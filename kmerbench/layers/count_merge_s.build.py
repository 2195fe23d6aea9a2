"""s per build job in the count's host merge, from the program's spans
(kmerbench/progtrace.py): the self time of the job's "count.merge" spans
(ops/backend._merge_logged: the chunks' sorted runs of keys and raw
counts merged on the host above the one-shot ceiling), summed.  None
where a job has none (a count in one shot)."""

from kmerbench.progtrace import per_job, self_seconds


def merge_seconds(all_spans):
    return self_seconds(all_spans, lambda n: n == "count.merge",
                        lambda n: True)


def read(ctx):
    return per_job(ctx, "build", merge_seconds)
