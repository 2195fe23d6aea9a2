"""s per build job in the host walk, emission and path cover
(core/spss.py, core/graph.py, core/native.py): the chain walk, emission
+ cycles and path cover debug lines, summed."""

from kmerbench.readers import stated_per_job


def read(ctx):
    if ctx.kind != "build":
        return None
    return stated_per_job(ctx, "chain walk", "emission + cycles", "path cover")
