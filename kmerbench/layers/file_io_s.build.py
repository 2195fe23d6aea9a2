"""s per build job in file I/O, from the program's spans
(kmerbench/progtrace.py): the self time of the "io.*" spans (the dump,
core/kmer_set_compact.py), less any other layer's work inside them."""

from kmerbench.progtrace import file_io_seconds, per_job


def read(ctx):
    return per_job(ctx, "build", file_io_seconds)
