"""Mbp/s: FASTA bases turned into a dump by the window's finished
build jobs, over the window's whole time (host clock)."""

from kmerbench.readers import work_rate


def read(ctx):
    return work_rate(ctx, "build", 1e6)
