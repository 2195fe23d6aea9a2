"""One tracer for the port: spans and counters of a CLI call, on the host
clock that the log records and a device trace mapped onto it share.

    with trace.span("count.parse", file=path):
        ...
    trace.add("launch.B1")

Tracing is on exactly while a CLI call runs with the "kmerset" logger at
DEBUG level (the CLIs' --debug): utils/flags.trace_context reads the
level once per call and opens the call's root span (root()).  Off,
span() returns one shared no-op after a single check of a module global,
and add() is one integer add.  timed() is span() for a site whose debug
line states its own seconds: off, it still reads the clock twice, so
that the line keeps its number.

On, a span records its name, id, parent id, native thread id, start and
end, and its attributes (bytes, k-mers, chunks).  Parents are tracked
per thread: a span opened in a worker thread with no span open there
takes the call's root as its parent.  Times are time.perf_counter_ns(),
mapped to time.time() seconds by one anchor pair taken when the root
opens.  add() charges a counter to the innermost open span of the
calling thread (the root in a thread with none open) and to the call.
The spans are kept in memory; at the root's end they are logged once,
at debug level, as one line: "trace: " and compact JSON
{"spans": [...], "counters": {...}}.  The call's counters also hold the
pooling allocator's hits and misses over the call (pool.hits,
pool.misses) where it is installed.  While a torch profiler records,
every span is also a torch.profiler.record_function range, so the
program's spans, kernels and copies sit in one Chrome trace.

add() also counts into process-wide totals (counts()), with tracing on
or off: chip_smoke.py reads the kernels' launch counters (launch.B1,
launch.B2, launch.B3) there.  Concurrent adds of one name to the totals
are not locked: the launch counters are raised under the device lock
(ops/backend.device_lock); a call's own counters are.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import threading
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger("kmerset")

PREFIX = "trace: "  # what the one line of a traced call starts with

_totals: Dict[str, int] = collections.defaultdict(int)
_current: Optional["_Call"] = None  # the call being recorded; None when off


class _Noop:
    """The shared span of tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return None

    def set(self, **attrs) -> None:
        pass


NOOP = _Noop()


class _Clock:
    """timed()'s span of tracing off: its seconds and nothing else."""

    __slots__ = ("t0", "t1")

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb):
        self.t1 = time.perf_counter_ns()

    def set(self, **attrs) -> None:
        pass

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9


class _Span(_Clock):
    __slots__ = ("call", "name", "attrs", "counts", "id", "parent", "tid",
                 "_rf")

    def __init__(self, call: "_Call", name: str, attrs: dict):
        self.call, self.name, self.attrs = call, name, attrs
        self.counts: Optional[Dict[str, int]] = None
        self._rf = None

    def __enter__(self):
        call = self.call
        self.id = next(call.ids)
        stack = call.stack()
        self.parent = stack[-1].id if stack else call.root_id
        self.tid = threading.get_native_id()
        stack.append(self)
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb):
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__exit__(kind, value, tb)
            self._rf = None
        self.call.stack().pop()
        self.call.spans.append(self)

    def set(self, **attrs) -> None:
        """Adds attributes known only inside the span (bytes, k-mers)."""
        self.attrs.update(attrs)


class _Call:
    """The spans and counters of one CLI call."""

    def __init__(self):
        self.ids = itertools.count(1)
        self.root_id: Optional[int] = None
        self.spans = []
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.lock = threading.Lock()
        self._stacks: Dict[int, list] = {}
        self.ns0 = time.perf_counter_ns()
        self.wall0 = time.time()

    def stack(self) -> list:
        """The calling thread's open spans, innermost last."""
        tid = threading.get_ident()
        s = self._stacks.get(tid)
        if s is None:
            s = self._stacks[tid] = []
        return s

    def charge(self, name: str, n: int) -> None:
        stack = self.stack()
        with self.lock:
            owner = stack[-1] if stack else self._root
            if owner.counts is None:
                owner.counts = collections.defaultdict(int)
            owner.counts[name] += n
            self.counters[name] += n

    def open_root(self, name: str, started: Optional[int]) -> _Span:
        self._root = _Span(self, name, {})
        self._root.__enter__()
        self.root_id = self._root.id
        if started is not None:
            self._root.t0 = started
        return self._root

    def seconds(self, ns: int) -> float:
        """A perf_counter_ns reading in time.time() seconds."""
        return self.wall0 + (ns - self.ns0) / 1e9

    def export(self) -> dict:
        spans = []
        for s in sorted(self.spans, key=lambda s: s.id):
            d = {"name": s.name, "id": s.id, "parent": s.parent, "tid": s.tid,
                 "start": self.seconds(s.t0), "end": self.seconds(s.t1)}
            if s.attrs:
                d["attrs"] = s.attrs
            if s.counts:
                d["counters"] = dict(s.counts)
            spans.append(d)
        return {"spans": spans, "counters": dict(self.counters)}


def span(name: str, **attrs):
    """A span of this name and attributes, or the shared no-op when
    tracing is off.  Names are dotted and hold no spaces."""
    call = _current
    if call is None:
        return NOOP
    return _Span(call, name, attrs)


def timed(name: str, **attrs):
    """span() whose .seconds are there with tracing off too, for a site
    that logs them."""
    call = _current
    if call is None:
        return _Clock()
    return _Span(call, name, attrs)


def add(name: str, n: int = 1) -> None:
    """Adds n to counter `name`: to the process's totals and, tracing on,
    to the innermost open span of the calling thread and the call."""
    _totals[name] += n
    call = _current
    if call is not None:
        call.charge(name, n)


def counts() -> Dict[str, int]:
    """A copy of the process-wide counter totals."""
    return dict(_totals)


def _pool_stats():
    import kmerset_tpu_torch

    mod = kmerset_tpu_torch.pool.module
    return mod.stats() if mod is not None else None


@contextlib.contextmanager
def root(name: str, on: bool, started: Optional[int] = None):
    """The root span `name` of one CLI call, recorded when `on`, from
    `started` (a perf_counter_ns reading: the call's entry) where given,
    else from now; at its end the call's spans and counters are logged as
    one "trace: " line at debug level.  Off, nothing is recorded."""
    global _current
    if not on:
        yield
        return
    call = _Call()
    pool0 = _pool_stats()
    _current = call
    rspan = call.open_root(name, started)
    try:
        yield
    finally:
        rspan.__exit__(None, None, None)
        _current = None
        pool1 = _pool_stats()
        if pool0 is not None and pool1 is not None:
            call.counters["pool.hits"] = pool1["pool_hits"] - pool0["pool_hits"]
            call.counters["pool.misses"] = (pool1["pool_misses"]
                                            - pool0["pool_misses"])
        logger.debug("%s%s", PREFIX,
                     json.dumps(call.export(), separators=(",", ":")))
