"""s: the nearest-rank 90th percentile of one job's wall time over every
job the window finished (host clock)."""

from kmerbench.readers import job_p90


def read(ctx):
    return job_p90(ctx)
