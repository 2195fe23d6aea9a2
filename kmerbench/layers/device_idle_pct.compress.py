"""%: the share of the window in which the device ran no kernel and no
copy, from the trace, in compress jobs."""

from kmerbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "compress")
