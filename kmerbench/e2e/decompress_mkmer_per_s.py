"""Mkmer/s: k-mers of the sets read back (the sum of the sizes of every
set the reader yields) by the window's finished decompress jobs, over
the window's whole time (host clock)."""

from kmerbench.readers import work_rate


def read(ctx):
    return work_rate(ctx, "decompress", 1e6)
