"""The device trace's reduction, on a synthetic Chrome trace."""

import pytest

from kmerbench import tracing
from kmerbench.window import Job, Window


def _events(offset_us):
    """Two jobs marked at host times 10.0 and 12.0; kernels and a copy."""
    ev = [{"name": tracing.JOB_MARK, "ph": "X", "cat": "user_annotation",
           "ts": offset_us + t * 1e6, "dur": 1.5e6} for t in (10.0, 12.0)]
    ev.append({"name": tracing.JOB_MARK, "ph": "X", "cat": "gpu_user_annotation",
               "ts": offset_us + 10.0e6, "dur": 1.0})
    for t, dur, name, cat in ((10.2, 0.1, "void compact_kernel<true>(Lanes)", "kernel"),
                              (10.25, 0.1, "void pack_canonical_kernel<unsigned int>(x)", "kernel"),
                              (10.8, 0.2, "Memcpy DtoH (Device -> Pageable)", "gpu_memcpy"),
                              (12.5, 0.5, "void compact_kernel<true>(Lanes)", "kernel")):
        ev.append({"name": name, "ph": "X", "cat": cat,
                   "ts": offset_us + t * 1e6, "dur": dur * 1e6})
    ev.append({"name": "aten::sort", "ph": "X", "cat": "cpu_op",
               "ts": offset_us + 10.2e6, "dur": 5e5})
    return ev


def test_busy_idle_and_ops_on_the_host_clock():
    trace = tracing.reduce_events(_events(7_000_000.0), [10.0, 12.0])
    # union: [10.2, 10.35] + [10.8, 11.0] + [12.5, 13.0] = 0.85 s busy
    assert tracing.busy_seconds(trace, 10.0, 13.5) == pytest.approx(0.85)
    gaps = tracing.idle_gaps(trace, 10.0, 13.5)
    assert sum(b - a for a, b in gaps) == pytest.approx(3.5 - 0.85)
    ops = dict(tracing.top_device_ops(trace, 10.0, 13.5))
    assert ops["compact_kernel<true>"] == pytest.approx(0.6)
    assert ops["pack_canonical_kernel<unsigned int>"] == pytest.approx(0.1)
    assert "aten::sort" not in ops


def test_idle_share_reader():
    from kmerbench import readers

    trace = tracing.reduce_events(_events(0.0), [10.0, 12.0])

    class Ctx:
        kind = "build"
        window = Window([Job(10.0, 11.5, 1.5, True), Job(12.0, 13.5, 1.5, True)],
                        None, 10.0, 13.5)

    Ctx.trace = trace
    assert readers.idle_pct(Ctx, "build") == pytest.approx(100 * (1 - 0.85 / 3.5))
    assert readers.idle_pct(Ctx, "compress") is None


def test_marks_must_match_jobs():
    with pytest.raises(ValueError):
        tracing.reduce_events(_events(0.0), [10.0])


def test_gaps_go_to_the_shortest_covering_phase():
    phases = [("CLI, other", 0.0, 10.0), ("count", 1.0, 3.0),
              ("path cover", 2.0, 2.5)]
    got = dict(tracing.label_gaps([(0.5, 2.2), (9.0, 11.0)], phases))
    assert got["CLI, other"] == pytest.approx(0.5 + 1.0)
    assert got["count"] == pytest.approx(1.0)
    assert got["path cover"] == pytest.approx(0.2)
    assert got["between jobs"] == pytest.approx(1.0)
