"""The readers of the program's own spans (kmerbench/progtrace.py and the
six metrics that read it), on synthetic jobs and a synthetic Chrome
trace, and the labelling tool."""

import json

import pytest

from kmerbench import progtrace, spec, tracing
from kmerbench.window import Job, Window

READ = {name: spec.reader("layers", name) for name in (
    "count_host_s.build", "file_io_s.build", "file_io_s.compress",
    "multiset_self_s.compress", "d2h_gbps.build", "d2h_gbps.compress")}


def _span(i, parent, name, start, end, **attrs):
    d = {"name": name, "id": i, "parent": parent, "tid": 1, "start": start,
         "end": end}
    if attrs:
        d["attrs"] = attrs
    return d


def _job(start, spans, counters=None):
    line = progtrace.PREFIX + json.dumps({"spans": spans,
                                          "counters": counters or {}})
    return Job(start, start + 1.5, 1.5, True,
               [(start, "constructing kmer_counter"), (start + 1.5, line)])


def _build_job(t):
    """A build job at host time t: parse 0.2 s, stage 0.1 s (an upload
    inside), the device part with two downloads, a deferred build and a
    dump."""
    return _job(t, [
        _span(1, None, "cli.kmerset_build", t, t + 1.5),
        _span(2, 1, "count.parse", t + 0.0, t + 0.2),
        _span(3, 1, "count.stage", t + 0.2, t + 0.3),
        _span(4, 3, "copy.h2d", t + 0.25, t + 0.3, bytes=1000),
        _span(5, 1, "count.device", t + 0.3, t + 0.6),
        _span(6, 5, "copy.d2h", t + 0.4, t + 0.5, bytes=2_000_000),
        _span(7, 5, "copy.d2h", t + 0.55, t + 0.6, bytes=500_000),
        _span(8, 1, "compact.deferred_build", t + 0.6, t + 1.3),
        _span(9, 1, "io.dump", t + 1.3, t + 1.45, bytes=10),
    ], {"d2h_bytes": 2_500_000})


def _compress_job(t):
    """A compress job: two loads, the greedy loop with a decode, a
    deferred build (a copy inside) and algebra, and a dump that forces
    a deferred build."""
    return _job(t, [
        _span(1, None, "cli.kmerset_multiple_compress", t, t + 1.5),
        _span(2, 1, "io.load", t + 0.0, t + 0.1),
        _span(3, 1, "io.load", t + 0.05, t + 0.15),
        _span(4, 1, "kss.construct", t + 0.2, t + 1.0),
        _span(5, 4, "kss.sample", t + 0.2, t + 0.4),
        _span(6, 5, "spss.decode", t + 0.25, t + 0.35),
        _span(7, 4, "kss.total_weight", t + 0.4, t + 0.7),
        _span(8, 7, "compact.deferred_build", t + 0.45, t + 0.65),
        _span(9, 8, "copy.d2h", t + 0.5, t + 0.6, bytes=1_000_000),
        _span(10, 4, "kss.algebra", t + 0.7, t + 0.8),
        _span(11, 4, "copy.d2h", t + 0.85, t + 0.9, bytes=10),
        _span(12, 1, "io.dump", t + 1.0, t + 1.4),
        _span(13, 12, "compact.deferred_build", t + 1.1, t + 1.3),
        _span(14, 1, "io.dump_graph", t + 1.4, t + 1.45),
    ])


class Ctx:
    def __init__(self, kind, jobs, trace=None):
        self.kind, self.trace = kind, trace
        self.window = Window(jobs, None, jobs[0].start, jobs[-1].end)

    @property
    def jobs(self):
        return self.window.jobs


def _events(job_starts, copies):
    """A Chrome trace marked at the job starts, with Memcpy DtoH events
    at (host time, seconds, bytes) and one kernel."""
    ev = [{"name": tracing.JOB_MARK, "ph": "X", "cat": "user_annotation",
           "ts": t * 1e6, "dur": 1e6} for t in job_starts]
    for t, dur, nbytes in copies:
        ev.append({"name": "Memcpy DtoH (Device -> Pageable)", "ph": "X",
                   "cat": "gpu_memcpy", "ts": t * 1e6, "dur": dur * 1e6,
                   "args": {"bytes": nbytes}})
    ev.append({"name": "void compact_kernel<true>(x)", "ph": "X",
               "cat": "kernel", "ts": (job_starts[0] + 0.35) * 1e6,
               "dur": 0.02e6})
    return ev


def test_count_host_and_file_io_of_builds():
    ctx = Ctx("build", [_build_job(10.0), _build_job(12.0)])
    assert READ["count_host_s.build"](ctx) == pytest.approx(0.3)
    assert READ["file_io_s.build"](ctx) == pytest.approx(0.15)
    assert READ["file_io_s.compress"](ctx) is None
    assert READ["multiset_self_s.compress"](ctx) is None


def test_compress_self_times():
    ctx = Ctx("compress", [_compress_job(10.0)])
    # Loads: the union [0, 0.15]; the dump 0.4 less the build inside,
    # 0.2; the graph 0.05.
    assert READ["file_io_s.compress"](ctx) == pytest.approx(0.15 + 0.2 + 0.05)
    # kss.construct 0.8 less the decode 0.1, the build 0.2 (its copy
    # inside it) and the loop's own copy 0.05.
    assert READ["multiset_self_s.compress"](ctx) == pytest.approx(0.45)
    assert READ["count_host_s.build"](ctx) is None


def test_a_job_without_the_line_reads_nothing():
    bare = Job(10.0, 11.5, 1.5, True, [(10.0, "constructing kmer_counter")])
    ctx = Ctx("build", [_build_job(8.0), bare])
    for name in ("count_host_s.build", "file_io_s.build", "d2h_gbps.build"):
        assert READ[name](ctx) is None


def test_d2h_rate_over_the_copies_device_time():
    jobs = [_build_job(10.0), _build_job(12.0)]
    # Inside the copy spans: 0.01 s and 0.002 s a job; one copy outside
    # every span (10.7) is not counted.
    copies = [(10.44, 0.01, 2_000_000), (10.57, 0.002, 500_000),
              (12.44, 0.01, 2_000_000), (12.57, 0.002, 500_000),
              (10.7, 0.5, 999)]
    trace = tracing.reduce_events(_events([10.0, 12.0], copies), [10.0, 12.0])
    ctx = Ctx("build", jobs, trace)
    assert READ["d2h_gbps.build"](ctx) == pytest.approx(5e6 / 0.024 / 1e9)
    assert READ["d2h_gbps.compress"](ctx) is None
    assert READ["d2h_gbps.build"](Ctx("build", jobs)) is None


def test_label_names_gaps_and_ops_by_the_innermost_span():
    jobs = [_build_job(10.0), _build_job(12.0)]
    copies = [(10.44, 0.01, 2_000_000), (10.57, 0.002, 500_000),
              (12.44, 0.01, 2_000_000), (12.57, 0.002, 500_000)]
    events = _events([10.0, 12.0], copies)
    ctx = Ctx("build", jobs, tracing.reduce_events(events, [10.0, 12.0]))
    out = progtrace.label(ctx, events)
    gaps = dict(out["idle_gaps"])
    assert gaps["compact.deferred_build"] == pytest.approx(1.4)
    assert gaps["count.parse"] == pytest.approx(0.4)
    assert gaps["between jobs"] == pytest.approx(0.5)
    assert out["device_ops"]["copy.d2h"][0] == pytest.approx(0.024)
    assert out["device_ops"]["count.device"][1][0][0] == "compact_kernel<true>"
    assert out["root_start_minus_job_start_s"]["max"] == pytest.approx(0.0)
    assert out["children_cover_of_wall"]["min"] == pytest.approx(1.45 / 1.5)
    assert out["d2h_bytes_vs_memcpy_max_rel_diff"] == pytest.approx(0.0)
