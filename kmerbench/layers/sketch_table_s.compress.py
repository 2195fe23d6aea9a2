"""s per compress job in the sketch table (core/kmer_set_set.py,
ops/sketch.py): the "kmer_set_set: sketch table on ..." debug line."""

from kmerbench import spans
from kmerbench.readers import mean_per_job


def read(ctx):
    if ctx.kind != "compress":
        return None
    return mean_per_job(ctx, lambda job: spans.sketch_seconds(job.lines))
