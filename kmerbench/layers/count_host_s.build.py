"""s per build job on the count's host side, from the program's spans
(kmerbench/progtrace.py): the FASTA read and parse ("count.parse",
core/kmer_counter.py) and the 2-bit pack and upload ("count.stage",
ops/backend.stage), summed."""

from kmerbench.progtrace import per_job, summed


def read(ctx):
    return per_job(ctx, "build",
                   lambda s: summed(s, ("count.parse", "count.stage")))
