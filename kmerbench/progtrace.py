"""The program's own spans and counters: the one "trace: " line that each
CLI call logs under --debug (kmerset_tpu_torch/utils/trace.py), read
from a job's log lines, and the arithmetic that the readers of layers/
take from it.

A job's line holds {"spans": [...], "counters": {...}}.  A span has
name, id, parent, tid, start and end, in time.time() seconds: the clock
of the job's log records and of the device trace as tracing.py maps it.
It may have attrs (bytes, k-mers) and the counters charged to it.  A
job of a program without the tracer logs no such line, and every
function here then finds nothing: None.

    python3 -m kmerbench.progtrace --workload W --seed N --seconds S

runs one traced run of a cell through the harness and prints label()'s
tables as one JSON line: the window's idle gaps and device operations by
the program's innermost span, and the checks of the spans against the
harness's jobs and the device trace.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
from typing import Callable, Dict, List, Optional

from . import tracing

PREFIX = "trace: "  # kmerset_tpu_torch.utils.trace.PREFIX
D2H = "Memcpy DtoH"  # the device trace's name of a device-to-host copy


def job_trace(job) -> Optional[dict]:
    """The job's one trace line, parsed; None where it logged none or
    more than one."""
    found = [m for _, m in job.lines if m.startswith(PREFIX)]
    if len(found) != 1:
        return None
    return json.loads(found[0][len(PREFIX):])


def spans(job) -> Optional[List[dict]]:
    t = job_trace(job)
    return None if t is None else t["spans"]


def counters(job) -> Optional[Dict[str, int]]:
    t = job_trace(job)
    return None if t is None else t["counters"]


def layer(name: str) -> str:
    """A span's layer: its name up to the first dot."""
    return name.split(".", 1)[0]


def covered(intervals, lo: float = float("-inf"),
            hi: float = float("inf")) -> float:
    """Seconds of [lo, hi] that the union of (start, end) intervals
    covers."""
    clipped = [("", max(s, lo), min(e, hi)) for s, e in intervals]
    return sum(e - s for s, e in tracing.union([c for c in clipped
                                                if c[2] > c[1]]))


def descendants(all_spans: List[dict], of: List[dict]) -> List[dict]:
    """The spans below any of `of` (its children, theirs, ...)."""
    kids: Dict[int, List[dict]] = {}
    for s in all_spans:
        kids.setdefault(s["parent"], []).append(s)
    out, todo = [], [s["id"] for s in of]
    while todo:
        for c in kids.get(todo.pop(), []):
            out.append(c)
            todo.append(c["id"])
    return out


def self_seconds(all_spans: List[dict], select: Callable[[str], bool],
                 other: Callable[[str], bool]) -> Optional[float]:
    """Self time of the selected spans (by name): the seconds their union
    covers less the part of it that their descendants whose names pass
    `other` cover; None where none is selected."""
    chosen = [s for s in all_spans if select(s["name"])]
    if not chosen:
        return None
    mine = tracing.union([("", s["start"], s["end"]) for s in chosen])
    below = [(d["start"], d["end"]) for d in descendants(all_spans, chosen)
             if other(d["name"])]
    return sum(e - s - covered(below, s, e) for s, e in mine)


def summed(all_spans: List[dict], names) -> Optional[float]:
    """Seconds of the spans of these names, added up; None where there
    are none."""
    got = [s["end"] - s["start"] for s in all_spans if s["name"] in names]
    return sum(got) if got else None


def per_job(ctx, kind: str, of_spans: Callable) -> Optional[float]:
    """The mean over the window's finished jobs of of_spans(the job's
    spans); None in a cell of another kind or where any job gives none."""
    if ctx.kind != kind or not ctx.jobs:
        return None
    values = []
    for j in ctx.jobs:
        s = spans(j)
        v = None if s is None else of_spans(s)
        if v is None:
            return None
        values.append(v)
    return sum(values) / len(values)


def file_io_seconds(all_spans: List[dict]) -> Optional[float]:
    """Self time of the io.* spans: less the other layers' work inside
    them (a deferred build that a dump forces)."""
    return self_seconds(all_spans, lambda n: layer(n) == "io",
                        lambda n: layer(n) != "io")


_BELOW_MULTISET = ("compact", "spss", "front_end", "copy")


def multiset_self_seconds(all_spans: List[dict]) -> Optional[float]:
    """Self time of kss.construct: less its compact.*, spss.*,
    front_end.* and copy.* descendants."""
    return self_seconds(all_spans, lambda n: n == "kss.construct",
                        lambda n: layer(n) in _BELOW_MULTISET)


def _inside(events, intervals) -> list:
    """The (name, start, end) events whose midpoint lies inside the union
    of the (start, end) intervals."""
    u = tracing.union([("", s, e) for s, e in intervals])
    starts = [s for s, _ in u]
    out = []
    for ev in events:
        mid = (ev[1] + ev[2]) / 2
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid < u[i][1]:
            out.append(ev)
    return out


def d2h_gbps(ctx, kind: str) -> Optional[float]:
    """The bytes of the window's copy.d2h spans over the device seconds
    of the trace's Memcpy DtoH events inside them, in GB/s (1e9 B); None
    without a trace, spans or such events."""
    if ctx.trace is None or ctx.kind != kind or not ctx.jobs:
        return None
    copies = []
    for j in ctx.jobs:
        s = spans(j)
        if s is None:
            return None
        copies += [c for c in s if c["name"] == "copy.d2h"]
    memcpy = [ev for ev in ctx.trace.within(ctx.window.start, ctx.window.end)
              if ev[0].startswith(D2H)]
    seconds = sum(e - s for _, s, e in _inside(
        memcpy, [(c["start"], c["end"]) for c in copies]))
    if seconds <= 0:
        return None
    return sum(c.get("attrs", {}).get("bytes", 0) for c in copies) / seconds / 1e9


# -- the one-off labelling tool ----------------------------------------------

def _innermost(all_spans, events) -> Dict[str, list]:
    """Each (name, start, end) event under the shortest span that covers
    its midpoint ("between jobs" where none does)."""
    by: Dict[str, list] = {}
    ordered = sorted(all_spans, key=lambda s: s["start"])
    starts = [s["start"] for s in ordered]
    longest = max((s["end"] - s["start"] for s in ordered), default=0.0)
    for ev in events:
        mid = (ev[1] + ev[2]) / 2
        lo = bisect.bisect_left(starts, mid - longest)
        hi = bisect.bisect_right(starts, mid)
        cover = [s for s in ordered[lo:hi] if s["start"] <= mid < s["end"]]
        name = (min(cover, key=lambda s: s["end"] - s["start"])["name"]
                if cover else "between jobs")
        by.setdefault(name, []).append(ev)
    return by


def _d2h_copies(trace, events) -> List[tuple]:
    """(start on the host's clock, bytes) of each Memcpy DtoH event: the
    raw trace's bytes beside the starts that tracing.reduce_events gave
    the same events, in the same order."""
    raw = sorted((e for e in events
                  if e.get("cat") in tracing.DEVICE_CATS and e.get("ph") == "X"
                  and str(e.get("name", "")).startswith(D2H)),
                 key=lambda e: float(e["ts"]))
    starts = [s for n, s, _ in trace.device if n.startswith(D2H)]
    return [(s, int(e.get("args", {}).get("bytes", 0)))
            for s, e in zip(starts, raw)]


def label(ctx, events: Optional[list] = None, n: int = 12) -> dict:
    """A traced window by the program's spans: its idle gaps by the
    innermost span (tracing.label_gaps, the call's root where no other
    covers), its device operations by the innermost span that issued
    them (tracing.top_device_ops), each job's root start against the
    harness's Job.start, the share of each job's wall time that the
    root's children cover, and, given the raw Chrome trace's events, each
    job's d2h_bytes counter against the bytes of its Memcpy DtoH events."""
    w, jobs = ctx.window, ctx.jobs
    per_job = [spans(j) or [] for j in jobs]
    every = [s for js in per_job for s in js]
    gaps = tracing.idle_gaps(ctx.trace, w.start, w.end)
    out = {"jobs": len(jobs),
           "idle_gaps": tracing.label_gaps(
               gaps, [(s["name"], s["start"], s["end"]) for s in every], n)}
    ops = {}
    for name, evs in _innermost(every, ctx.trace.within(w.start, w.end)).items():
        sub = tracing.Trace(sorted(evs, key=lambda x: x[1]))
        ops[name] = [sum(e - s for _, s, e in evs),
                     tracing.top_device_ops(sub, w.start, w.end, 5)]
    out["device_ops"] = dict(sorted(ops.items(), key=lambda x: -x[1][0])[:n])
    starts, cover, after = [], [], {}
    for j, js in zip(jobs, per_job):
        root = [s for s in js if s["parent"] is None]
        if len(root) != 1:
            continue
        r = root[0]
        starts.append(r["start"] - j.start)
        kids = sorted((s for s in js if s["parent"] == r["id"]),
                      key=lambda s: s["start"])
        cover.append(covered([(s["start"], s["end"]) for s in kids],
                             r["start"], r["end"]) / (j.end - j.start))
        # The wall time no child covers, by the child it follows.
        at, prev = j.start, "job start"
        for s in kids + [{"name": "job end", "start": j.end, "end": j.end}]:
            if s["start"] > at:
                after[prev] = after.get(prev, 0.0) + s["start"] - at
            if s["end"] >= at:
                at, prev = s["end"], s["name"]
    if starts:
        out["root_start_minus_job_start_s"] = {
            "median": statistics.median(starts), "max": max(starts, key=abs)}
        out["children_cover_of_wall"] = {"min": min(cover),
                                         "median": statistics.median(cover)}
        out["uncovered_after"] = sorted(after.items(), key=lambda x: -x[1])[:n]
    if events is not None:
        copies = _d2h_copies(ctx.trace, events)
        worst = 0.0
        for j in jobs:
            c = counters(j) or {}
            got = sum(b for t, b in copies if j.start <= t < j.end)
            want = c.get("d2h_bytes", 0)
            if got or want:
                worst = max(worst, abs(want - got) / max(got, 1))
        out["d2h_bytes_vs_memcpy_max_rel_diff"] = worst
    return out


def main(argv=None) -> int:
    """One traced run of a cell through harness.main, unchanged, and
    label() of it.  The harness hands neither its reader context nor the
    raw Chrome trace out, and this tool may not edit a harness file, so
    for the one run it wraps spec.reader (to keep the context it passes)
    and tracing.Profiler.reduce (to keep the raw events before they are
    deleted), and puts both back after."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)

    from . import harness, spec

    got = {}
    real_reader, real_reduce = spec.reader, tracing.Profiler.reduce

    def reader(kind, name):
        fn = real_reader(kind, name)

        def read(ctx):
            got["ctx"] = ctx
            return fn(ctx)
        return read

    def reduce(self, job_starts):
        with open(self.path) as f:
            got["events"] = json.load(f)["traceEvents"]
        return real_reduce(self, job_starts)

    spec.reader, tracing.Profiler.reduce = reader, reduce
    try:
        rc = harness.main(["--workload", args.workload, "--seed", str(args.seed),
                           "--seconds", str(args.seconds), "--trace", "1"])
    finally:
        spec.reader, tracing.Profiler.reduce = real_reader, real_reduce
    if rc != 0 or "ctx" not in got:
        return rc or 1
    print(json.dumps(label(got["ctx"], got.get("events"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
