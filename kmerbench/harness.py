"""One run of one cell: inputs from the seed, set-up and a warm-up job,
the measured window, the check against the reference, the result line.

    python3 kmerbench/run.py --workload W --seed N --seconds S --trace 0|1

The last line of standard output is the result, a JSON object; the
numbers the check compared, each beside its limit, are the last lines
of standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import Optional

from . import generate, guard, jobs, spec, tracing
from .reference import check
from .spans import host_phases
from .window import Window, quiet_cli_logger, run_window

_T_IMPORT = time.perf_counter()


def process_age() -> float:
    """Seconds since this process started, by the kernel's clock where
    /proc has it, else since this module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


@dataclass
class Context:
    """What a metric's reader reads."""

    kind: str  # the mix's job kind
    k: int
    window: Window
    stats: dict  # the reference's counts of the inputs
    work_per_job: float
    trace: Optional[tracing.Trace]

    @property
    def jobs(self):
        return self.window.jobs


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def pin_caches(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own nvcc and C builds already land in build/ there)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "build", "kmerbench", sub)


def main(argv=None, *, require_chip: bool = True, device: str = "cuda",
         root: str = spec.ROOT, overrides: Optional[dict] = None) -> int:
    """Runs one cell; returns the exit code.  Tests pass require_chip=False,
    device="cpu" and `overrides` ({"config": {...}, "mix": {...}}, merged
    over the files) to drive the rest of a run at a small size."""
    args = _parse(argv)
    s = spec.Spec(root)
    cell, config, mix = s.resolve(args.workload, overrides)
    import torch

    if require_chip and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < int(cell["chips"])):
        print(f"kmerbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    pin_caches(root)
    quiet_cli_logger(debug=bool(args.trace))
    work = tempfile.mkdtemp(prefix="kmerbench-")
    try:
        result = _run(args, s, cell, config, mix, work, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    guard.require_clean("before the result")
    for name, c in result["compared"].items():
        print(f"kmerbench: compared {name} = {c['value']} (limit "
              f"{c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


def _run(args, s, cell, config, mix, work, device) -> dict:
    import torch

    import kmerset_tpu_torch  # noqa: F401 - no program, no run (and no result)

    cuda = device.startswith("cuda")
    fastas, bases = generate.write_fastas(config, mix, args.seed, work)
    inputs = generate.compress_inputs(fastas, mix.get("input_compressor", ""))
    kind = jobs.KINDS[mix["job"]](config, mix, inputs, fastas, bases, work,
                                  device, args.seed, bool(args.trace))
    kind.setup()
    ran = [kind.run()]  # the warm-up: one whole job
    setup_s = process_age()
    guard.require_clean("after set-up")

    def one_job():
        ran.append(kind.run(annotate))
        return ran[-1]

    prof = None
    if args.trace:
        def annotate():
            return torch.profiler.record_function(tracing.JOB_MARK)

        prof = tracing.Profiler(os.path.join(work, "trace.json"))
        with prof:
            window = run_window(one_job, args.seconds)
    else:
        annotate = None
        window = run_window(one_job, args.seconds)
    guard.require_clean("after the window")
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    trace = None
    if prof is not None:
        marked = window.jobs + ([window.cut] if window.cut else [])
        trace = prof.reduce([j.start for j in marked])
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    parts, numbers = kind.check(ran[-1])
    parts["outputs differing"] = sum(j.digest != ran[-1].digest for j in ran)
    failed = window.failed + (not ran[0].ok)
    compared = check.compared(parts, numbers)
    for j in ran:
        if not j.ok:
            print(f"kmerbench: a job failed: {j.error}", file=sys.stderr)
    walls = sorted(j.wall_s for j in window.jobs)
    if walls:
        print(f"kmerbench: {len(walls)} jobs in {window.seconds:.3f} s, "
              f"job s min {walls[0]:.3f} median {walls[len(walls) // 2]:.3f} "
              f"max {walls[-1]:.3f}", file=sys.stderr)
    print(f"kmerbench: reference: {json.dumps(kind.stats)}", file=sys.stderr)
    for name, value in parts.items():
        print(f"kmerbench: {name}: {value}", file=sys.stderr)

    ctx = Context(mix["job"], int(config["k"]), window, kind.stats,
                  kind.work_per_job(), trace)
    metrics = {}
    for m in s.metrics(cell, bool(args.trace)):
        if m["name"] == spec.SETUP_METRIC:
            value = setup_s
        else:
            value = spec.reader("layers" if args.trace else "e2e", m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": (check.within(compared) and failed == 0
                          and bool(window.jobs)),
              "attempted": window.attempted + 1, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = tracing.busy_seconds(trace, window.start, window.end)
        dev["window_s"] = window.seconds
        phases = [p for j in window.jobs for p in host_phases(j)]
        result["breakdown"] = {
            "device_ops": tracing.top_device_ops(trace, window.start, window.end),
            "idle_gaps": tracing.label_gaps(
                tracing.idle_gaps(trace, window.start, window.end), phases),
        }
    result["compared"] = compared
    return result
