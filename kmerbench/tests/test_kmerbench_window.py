"""The window's arithmetic: rates and the 90th percentile over the jobs
it finished, a cut-off job left out."""

import time

import pytest

from kmerbench import readers
from kmerbench.window import Job, Window, percentile, rate, run_job, run_window


def _job(start, wall, ok=True):
    return Job(start, start + wall, wall, ok)


def test_rate_takes_the_finished_jobs_over_the_whole_window():
    jobs = [_job(100.0 + 2 * i, 1.5) for i in range(4)]  # ends at 107.5
    w = Window(jobs, cut=_job(108.0, 5.0), start=100.0, end=jobs[-1].end)
    assert w.seconds == pytest.approx(7.5)
    assert rate(10.0, w) == pytest.approx(4 * 10.0 / 7.5)
    assert w.attempted == 5 and w.failed == 0


def test_no_finished_job_gives_no_rate():
    w = Window([], cut=_job(0.0, 9.0), start=0.0, end=0.0)
    assert rate(1.0, w) is None
    assert percentile([], 90) is None


def test_p90_is_nearest_rank():
    assert percentile(list(range(1, 11)), 90) == 9
    assert percentile(list(range(1, 21)), 90) == 18
    assert percentile([5.0], 90) == 5.0
    assert percentile([3, 1, 2], 90) == 3


def test_run_window_cuts_off_the_job_past_its_end():
    def one():
        return run_job(lambda argv: time.sleep(0.03), [])

    w = run_window(one, 0.1)
    assert w.cut is not None
    assert 2 <= len(w.jobs) <= 4
    assert w.end == w.jobs[-1].end
    assert w.end <= w.cut.end


def test_failed_jobs_are_counted():
    def bad(argv):
        raise SystemExit(1)

    assert not run_job(bad, []).ok
    assert run_job(lambda argv: None, []).ok
    w = Window([_job(0, 1), _job(1, 1, ok=False)], None, 0.0, 2.0)
    assert w.failed == 1


class _Ctx:
    def __init__(self, kind, jobs, work):
        self.kind, self.work_per_job = kind, work
        self.window = Window(jobs, None, jobs[0].start, jobs[-1].end)
        self.jobs = jobs


def test_work_rate_and_p90_readers():
    jobs = [_job(float(i), 1.0) for i in range(10)]
    ctx = _Ctx("build", jobs, 4_000_000.0)
    assert readers.work_rate(ctx, "build", 1e6) == pytest.approx(4.0)
    assert readers.work_rate(ctx, "compress", 1e6) is None
    assert readers.job_p90(ctx) == 1.0
