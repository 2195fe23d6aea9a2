"""% of the graph front-end's one-shot ceiling left above the set, per
build job: 100 * (ceiling - kmers) / ceiling of the job's
"front_end.plan" span (ops/unitigs.device_unitig_succ), negative where
the set lay above the ceiling and the front-end ran bounded.  Where a
job planned more than one front-end, the least headroom; None where a
job has no plan span (a program without it)."""

from kmerbench.progtrace import per_job


def headroom(all_spans):
    plans = [s["attrs"] for s in all_spans if s["name"] == "front_end.plan"
             and "attrs" in s]
    if not plans:
        return None
    return min(100.0 * (p["ceiling"] - p["kmers"]) / p["ceiling"] for p in plans)


def read(ctx):
    return per_job(ctx, "build", headroom)
