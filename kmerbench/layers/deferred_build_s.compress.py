"""s per compress job in the compact sets' deferred SPSS builds
(core/kmer_set_compact.py): the "deferred SPSS build ... s" debug
lines, summed."""

from kmerbench.readers import stated_per_job


def read(ctx):
    if ctx.kind != "compress":
        return None
    return stated_per_job(ctx, "deferred SPSS build")
