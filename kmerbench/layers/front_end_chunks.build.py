"""Query chunks per pass of the graph front-end, per build job, from the
program's spans (kmerbench/progtrace.py): the largest "query_chunks" of
the job's "front_end.plan" spans (ops/unitigs.device_unitig_succ: 1 in
one shot unless its query chunk is smaller than the set, else the chunks
that the memory budget left beside the mode's whole-set arrays).  None
where a job has no plan span with the attribute (a program without it)."""

from kmerbench.progtrace import per_job


def chunks(all_spans):
    plans = [s["attrs"]["query_chunks"] for s in all_spans
             if s["name"] == "front_end.plan"
             and "query_chunks" in s.get("attrs", {})]
    return float(max(plans)) if plans else None


def read(ctx):
    return per_job(ctx, "build", chunks)
