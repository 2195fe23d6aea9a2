"""front_end_headroom_pct.build on hand-made job traces: the share of the
front-end's one-shot ceiling above the set, from each job's
"front_end.plan" span, negative where the front-end ran bounded, and
None where a job has no plan span."""

import json

import pytest

from kmerbench import progtrace, spec
from kmerbench.window import Job, Window

READ = spec.reader("layers", "front_end_headroom_pct.build")


def _job(t, plans):
    spans = [{"name": "cli.kmerset_build", "id": 1, "parent": None, "tid": 1,
              "start": t, "end": t + 2.0}]
    for i, (kmers, ceiling, mode) in enumerate(plans):
        spans.append({"name": "front_end.plan", "id": 2 + i, "parent": 1,
                      "tid": 1, "start": t + 1.0, "end": t + 1.0001,
                      "attrs": {"kmers": kmers, "ceiling": ceiling,
                                "budget": 160 * ceiling, "mode": mode,
                                "walk": "device"}})
    line = progtrace.PREFIX + json.dumps({"spans": spans, "counters": {}})
    return Job(t, t + 2.0, 2.0, True, [(t + 2.0, line)])


class Ctx:
    def __init__(self, kind, jobs):
        self.kind = kind
        self.window = Window(jobs, None, jobs[0].start, jobs[-1].end)

    @property
    def jobs(self):
        return self.window.jobs


def test_one_shot_jobs_read_the_margin_under_the_ceiling():
    jobs = [_job(0.0, [(248_400_000, 256_000_000, "one-shot")]),
            _job(3.0, [(248_500_000, 256_000_000, "one-shot")])]
    want = 100.0 * (256_000_000 - 248_450_000) / 256_000_000
    assert READ(Ctx("build", jobs)) == pytest.approx(want)
    assert 0 < want < 3


def test_a_bounded_job_reads_negative():
    jobs = [_job(0.0, [(268_000_000, 250_000_000, "bounded")])]
    assert READ(Ctx("build", jobs)) == pytest.approx(-7.2)


def test_the_least_headroom_of_a_job_with_several_plans():
    jobs = [_job(0.0, [(100, 1000, "one-shot"), (900, 1000, "one-shot")])]
    assert READ(Ctx("build", jobs)) == pytest.approx(10.0)


def test_no_plan_span_reads_nothing():
    assert READ(Ctx("build", [_job(0.0, [])])) is None
    mixed = [_job(0.0, [(100, 1000, "one-shot")]), _job(3.0, [])]
    assert READ(Ctx("build", mixed)) is None
    no_line = Job(0.0, 1.0, 1.0, True, [(1.0, "constructing kmer_counter")])
    assert READ(Ctx("build", [no_line])) is None
    assert READ(Ctx("compress", [_job(0.0, [(100, 1000, "one-shot")])])) is None
