"""%: the least time the count's device work needs (kernels B1/B2 and
B3, peaks.py) over the device time of those kernels in the trace."""

from kmerbench.readers import count_kernels_roofline


def read(ctx):
    return count_kernels_roofline(ctx)
