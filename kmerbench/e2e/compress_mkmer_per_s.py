"""Mkmer/s: input k-mers (the sum of the input sets' sizes) jointly
compressed by the window's finished compress jobs, over the window's
whole time (host clock)."""

from kmerbench.readers import work_rate


def read(ctx):
    return work_rate(ctx, "compress", 1e6)
