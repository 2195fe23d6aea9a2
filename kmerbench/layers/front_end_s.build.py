"""s per build job in the graph front-end (ops/unitigs.py,
ops/neighbors.py, ops/join.py): upload + device + download of the
"unitigs: device ..." debug line."""

from kmerbench.readers import stated_per_job


def read(ctx):
    return stated_per_job(ctx, "device front-end") if ctx.kind == "build" else None
