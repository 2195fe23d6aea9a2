"""Arithmetic that the metrics' readers (e2e/, layers/) share."""

from __future__ import annotations

import re
from typing import Callable, Optional

from . import peaks, spans, tracing
from .window import percentile, rate


def work_rate(ctx, kind: str, scale: float) -> Optional[float]:
    """The work of the window's finished jobs over its whole time, in
    units of `scale`, for a job of `kind`."""
    if ctx.kind != kind:
        return None
    r = rate(ctx.work_per_job, ctx.window)
    return None if r is None else r / scale


def job_p90(ctx) -> Optional[float]:
    return percentile([j.wall_s for j in ctx.jobs], 90)


def mean_per_job(ctx, of_job: Callable) -> Optional[float]:
    """The mean over the window's finished jobs of of_job(job), where
    every job gives one (None where any gives none)."""
    values = [of_job(j) for j in ctx.jobs]
    if not values or any(v is None for v in values):
        return None
    return sum(values) / len(values)


def stated_per_job(ctx, *names) -> Optional[float]:
    """Seconds per job of the stated debug spans of these names."""
    def of_job(job):
        got = [s for s in spans.stated(job.lines) if s[0] in names]
        return spans.total(got) if got else None
    return mean_per_job(ctx, of_job)


def paired_per_job(ctx, name: str) -> Optional[float]:
    def of_job(job):
        got = spans.pairs(job.lines, name)
        return spans.total(got) if got else None
    return mean_per_job(ctx, of_job)


def idle_pct(ctx, kind: str) -> Optional[float]:
    """The share of the window in which no kernel and no copy ran."""
    w = ctx.window
    if ctx.trace is None or ctx.kind != kind or w.seconds <= 0:
        return None
    return 100.0 * (1 - tracing.busy_seconds(ctx.trace, w.start, w.end)
                    / w.seconds)


COUNT_KERNELS = re.compile(r"\b(pack_canonical_kernel|compact_kernel)\b")


def count_kernels_roofline(ctx) -> Optional[float]:
    """The count kernels' least time (peaks.count_kernels_seconds) over
    the device time of their launches inside the count's span
    ("constructing kmer_counter" to "constructed kmer_counter", which
    ends in a host fetch) of the window's finished jobs, in %; None where
    the trace holds none.  Launches outside it, such as the cutoff
    filter's B3, do other work and are not counted."""
    if ctx.trace is None or ctx.kind != "build" or not ctx.jobs:
        return None
    counts = [s for j in ctx.jobs for s in spans.pairs(j.lines, "kmer_counter")]
    t = sum(e - s for _, lo, hi in counts for n, s, e in ctx.trace.within(lo, hi)
            if COUNT_KERNELS.search(tracing.short_name(n)))
    if t <= 0:
        return None
    least = peaks.count_kernels_seconds(ctx.k, ctx.stats["windows"],
                                        ctx.stats["distinct"])
    return 100.0 * least * len(ctx.jobs) / t
