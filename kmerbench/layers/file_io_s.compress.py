"""s per compress job in file I/O, from the program's spans
(kmerbench/progtrace.py): the self time of "io.load" (each set file),
"io.dump" (the directory's files) and "io.dump_graph" (the DOT file),
less the other layers' work inside them (a deferred build that a dump
forces)."""

from kmerbench.progtrace import file_io_seconds, per_job


def read(ctx):
    return per_job(ctx, "compress", file_io_seconds)
