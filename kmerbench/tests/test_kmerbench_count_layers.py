"""count_merge_s.build and count_chunks.build on hand-made job traces:
the summed self time of a job's "count.merge" spans, and the largest
"chunks" of its "count.plan" spans; None where a job has none."""

import json

import pytest

from kmerbench import progtrace, spec
from kmerbench.window import Job, Window

MERGE = spec.reader("layers", "count_merge_s.build")
CHUNKS = spec.reader("layers", "count_chunks.build")


def _job(t, merges=(), plans=()):
    """A job whose trace line holds a root, one "count.merge" span per
    (start, end) offset pair of `merges` and one "count.plan" span per
    chunk count of `plans`."""
    spans = [{"name": "cli.kmerset_build", "id": 1, "parent": None, "tid": 1,
              "start": t, "end": t + 20.0}]
    for lo, hi in merges:
        spans.append({"name": "count.merge", "id": len(spans) + 1, "parent": 1,
                      "tid": 1, "start": t + lo, "end": t + hi,
                      "attrs": {"chunks": 3, "keys_in": 360, "keys_out": 170}})
    for chunks in plans:
        spans.append({"name": "count.plan", "id": len(spans) + 1, "parent": 1,
                      "tid": 1, "start": t + 0.5, "end": t + 0.5001,
                      "attrs": {"windows": 1000 * chunks, "chunks": chunks,
                                "chunk": 1000, "ceiling": 1000,
                                "budget": 72_000}})
    line = progtrace.PREFIX + json.dumps({"spans": spans, "counters": {}})
    return Job(t, t + 20.0, 20.0, True, [(t + 20.0, line)])


class Ctx:
    def __init__(self, kind, jobs):
        self.kind = kind
        self.window = Window(jobs, None, jobs[0].start, jobs[-1].end)

    @property
    def jobs(self):
        return self.window.jobs


def test_three_merges_are_summed():
    jobs = [_job(0.0, merges=[(1.0, 1.5), (2.0, 2.25), (3.0, 4.0)]),
            _job(30.0, merges=[(1.0, 2.75)])]
    assert MERGE(Ctx("build", jobs)) == pytest.approx(1.75)


def test_no_merge_reads_nothing():
    assert MERGE(Ctx("build", [_job(0.0, plans=[1])])) is None
    mixed = [_job(0.0, merges=[(1.0, 2.0)]), _job(30.0)]
    assert MERGE(Ctx("build", mixed)) is None
    assert MERGE(Ctx("compress", [_job(0.0, merges=[(1.0, 2.0)])])) is None


def test_a_plan_of_three_chunks():
    jobs = [_job(0.0, plans=[3]), _job(30.0, plans=[3])]
    got = CHUNKS(Ctx("build", jobs))
    assert got == 3.0 and isinstance(got, float)


def test_the_largest_of_two_plans():
    assert CHUNKS(Ctx("build", [_job(0.0, plans=[1, 3])])) == 3.0
    assert CHUNKS(Ctx("build", [_job(0.0, plans=[2, 1])])) == 2.0


def test_no_plan_span_reads_nothing():
    assert CHUNKS(Ctx("build", [_job(0.0, merges=[(1.0, 2.0)])])) is None
    mixed = [_job(0.0, plans=[3]), _job(30.0)]
    assert CHUNKS(Ctx("build", mixed)) is None
    no_line = Job(0.0, 1.0, 1.0, True, [(1.0, "constructing kmer_counter")])
    assert CHUNKS(Ctx("build", [no_line])) is None
    assert MERGE(Ctx("build", [no_line])) is None
