"""The device trace of a --trace 1 run, reduced to busy time, idle gaps
and device operations.

torch.profiler (CPU and CUDA activity) runs around the window and writes
a Chrome trace; the reduction reads its device events (kernels, copies,
memsets) and the benchmark's own "kmerbench.job" annotations, whose
host times the harness recorded, to put the device's clock on the
host's.  Every time here is then in time.time() seconds.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import statistics
from dataclasses import dataclass
from typing import Dict, List, Tuple

JOB_MARK = "kmerbench.job"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

Interval = Tuple[str, float, float]  # (name, start, end)


@dataclass
class Trace:
    device: List[Interval]  # every device event, on the host's clock

    def within(self, lo: float, hi: float) -> List[Interval]:
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device
                if e > lo and s < hi]


class Profiler:
    """torch.profiler around a block, its Chrome trace written to `path`
    and read back once by reduce()."""

    def __init__(self, path: str):
        self.path = path
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._prof.export_chrome_trace(self.path)
        return False

    def reduce(self, job_starts: List[float]) -> Trace:
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            if os.path.exists(self.path):
                os.remove(self.path)
        return reduce_events(events, job_starts)


def reduce_events(events: List[dict], job_starts: List[float]) -> Trace:
    """Device events of a Chrome trace on the host's clock: the offset is
    the median, over the job annotations, of the annotation's trace time
    less the host time the harness took just before it."""
    marks = sorted(float(e["ts"]) for e in events
                   if e.get("name") == JOB_MARK and e.get("ph") == "X"
                   and e.get("cat") != "gpu_user_annotation")
    if not marks or len(marks) != len(job_starts):
        raise ValueError(f"trace holds {len(marks)} job marks for "
                         f"{len(job_starts)} jobs")
    offset = statistics.median(m / 1e6 - t for m, t in zip(marks, job_starts))
    device = []
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            s = float(e["ts"]) / 1e6 - offset
            device.append((str(e.get("name", "?")), s,
                           s + float(e.get("dur", 0)) / 1e6))
    device.sort(key=lambda x: x[1])
    return Trace(device)


def union(intervals: List[Interval]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(trace: Trace, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(trace.within(lo, hi)))


def idle_gaps(trace: Trace, lo: float, hi: float) -> List[Tuple[float, float]]:
    gaps, at = [], lo
    for s, e in union(trace.within(lo, hi)):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


_ANON = re.compile(r"\(anonymous namespace\)::")


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    parameter list, at most 96 characters."""
    name = _ANON.sub("", name).strip()
    if name.startswith("void "):
        name = name[5:]
    return name.split("(", 1)[0].strip()[:96] or "?"


def top_device_ops(trace: Trace, lo: float, hi: float, n: int = 10):
    """[name, seconds] of the n device operations that took most time."""
    by: Dict[str, float] = {}
    for name, s, e in trace.within(lo, hi):
        key = short_name(name)
        by[key] = by.get(key, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]


def label_gaps(gaps, phases: List[Interval], n: int = 10):
    """[phase, seconds] of idle time by what the host was doing: each
    stretch of a gap goes to the shortest host phase that covers it
    ("between jobs" where none does); the n largest."""
    by: Dict[str, float] = {}
    phases = sorted(phases, key=lambda p: p[1])
    starts = [p[1] for p in phases]
    longest = max((e - s for _, s, e in phases), default=0.0)
    for g0, g1 in gaps:
        lo = bisect.bisect_left(starts, g0 - longest)
        hi = bisect.bisect_right(starts, g1)
        near = [p for p in phases[lo:hi] if p[2] > g0 and p[1] < g1]
        cuts = sorted({g0, g1, *(max(g0, min(g1, x)) for _, s, e in near
                                  for x in (s, e))})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            cover = [p for p in near if p[1] <= mid < p[2]]
            name = (min(cover, key=lambda p: p[2] - p[1])[0] if cover
                    else "between jobs")
            by[name] = by.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda x: -x[1])[:n]]
