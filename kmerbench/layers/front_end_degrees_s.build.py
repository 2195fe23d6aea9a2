"""s per build job in the bounded front-end's degrees pass, from the
program's spans (kmerbench/progtrace.py): the self time of the job's
"front_end.degrees" spans (ops/unitigs.bounded_unitig_succ: every query
chunk's side tables built for the whole set's degrees, ended on a sync),
summed.  None where a job has none (a front-end in one shot, or a
program without the span)."""

from kmerbench.progtrace import per_job, self_seconds


def degrees_seconds(all_spans):
    return self_seconds(all_spans, lambda n: n == "front_end.degrees",
                        lambda n: True)


def read(ctx):
    return per_job(ctx, "build", degrees_seconds)
