"""The measured window: whole jobs back to back, and the arithmetic over
the jobs it finished.

A job is one call of a CLI's main(argv) in this process.  The window
starts the first job at its opening and starts no job after `seconds`;
a job still running then is cut off and does not count, and the window
ends where its last finished job ended.
"""

from __future__ import annotations

import contextlib
import io
import logging
import math
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, List, Optional

CLI_LOGGER = "kmerset"  # the logger every port CLI writes its lines to


@dataclass
class Job:
    start: float  # time.time() at the call
    end: float
    wall_s: float  # perf_counter span of the call
    ok: bool
    lines: list = field(default_factory=list)  # (time.time(), message)
    error: str = ""
    digest: Optional[str] = None  # of the job's outputs, read after it


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append((record.created, record.getMessage()))


def quiet_cli_logger(debug: bool) -> None:
    """Takes the CLIs' logger before their first call: their
    init_default_logger then adds no stderr handler, so a job prints
    nothing; the level is the one a CLI user gets (info, or debug as
    under --debug)."""
    log = logging.getLogger(CLI_LOGGER)
    for h in list(log.handlers):
        log.removeHandler(h)
    log.addHandler(logging.NullHandler())
    log.setLevel(logging.DEBUG if debug else logging.INFO)
    log.propagate = False


def run_job(main: Callable, argv: List[str], annotate=None) -> Job:
    """One call of main(argv), its stdout swallowed and its log lines
    kept.  A raise or a non-zero exit is a failed job."""
    cap = _Capture()
    log = logging.getLogger(CLI_LOGGER)
    log.addHandler(cap)
    ok, error = True, ""
    start = time.time()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            with annotate() if annotate else contextlib.nullcontext():
                main(argv)
    except SystemExit as e:
        if e.code not in (0, None):
            ok, error = False, f"exit {e.code}"
    except Exception:  # noqa: BLE001 - a job's failure is counted, not fatal
        ok, error = False, traceback.format_exc(limit=8)
    finally:
        log.removeHandler(cap)
    wall = time.perf_counter() - t0
    end = time.time()
    if ok and any(m.startswith("failed") for _, m in cap.records):
        ok, error = False, "; ".join(m for _, m in cap.records
                                     if m.startswith("failed"))
    return Job(start, end, wall, ok, cap.records, error)


@dataclass
class Window:
    jobs: List[Job]  # finished inside the window, in order
    cut: Optional[Job]  # the job the window cut off, if any
    start: float  # time.time() at the opening
    end: float  # end of the last finished job (the opening if none)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def attempted(self) -> int:
        return len(self.jobs) + (self.cut is not None)

    @property
    def failed(self) -> int:
        return sum(not j.ok for j in self.jobs) + (
            self.cut is not None and not self.cut.ok)


def run_window(one_job: Callable[[], Job], seconds: float) -> Window:
    """Jobs back to back from now for `seconds`; see the module's doc."""
    start = time.time()
    deadline = time.perf_counter() + seconds
    jobs, cut = [], None
    while time.perf_counter() < deadline:
        job = one_job()
        if time.perf_counter() > deadline:
            cut = job
            break
        jobs.append(job)
    end = jobs[-1].end if jobs else start
    return Window(jobs, cut, start, end)


def rate(work_per_job: float, window: Window) -> Optional[float]:
    """The work of the finished jobs over the window's whole time."""
    if not window.jobs or window.seconds <= 0:
        return None
    return work_per_job * len(window.jobs) / window.seconds


def percentile(values, q: float) -> Optional[float]:
    """The nearest-rank q-th percentile (0 < q <= 100): a value that was
    observed, the smallest with at least q% of the values at or under it."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100 * len(ordered))) - 1]
