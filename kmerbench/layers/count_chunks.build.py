"""Halo chunks per build job of the count, from the program's spans
(kmerbench/progtrace.py): the largest "chunks" of the job's
"count.plan" spans (ops/backend.count_plan: 1 in one shot, else the
chunks of the one-shot ceiling that the memory budget gave).  None
where a job has no plan span (a program without it)."""

from kmerbench.progtrace import per_job


def chunks(all_spans):
    plans = [s["attrs"]["chunks"] for s in all_spans
             if s["name"] == "count.plan" and "chunks" in s.get("attrs", {})]
    return float(max(plans)) if plans else None


def read(ctx):
    return per_job(ctx, "build", chunks)
