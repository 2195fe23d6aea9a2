"""%: the share of the window in which the device ran no kernel and no
copy, from the trace, in decompress jobs."""

from kmerbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "decompress")
