"""Where the port's count phase spends its time on a CUDA device.

    python -m kmerset_tpu_torch.tools.profile_count [--k 15|19|23|31] \
        [--trace OUT.json] FASTA

It counts the FASTA's canonical k-mers (k = 15 by default, the CLI's
default).  In each of two repetitions (the first pays one-time costs) it
prints one line per step:
- the host steps that KmerCounter.from_fasta takes (wall ms): the native
  parse when the native host library is loaded, else its numpy
  fallback as read_lines, parse_fasta_lines and reads_to_codes;
- the staging (2-bit pack and upload, wall ms);
- each device step of ops/count.count_kmers_frag (CUDA-event ms, through
  its `mark` hook): the pack step is "B1 pack" at k = 15 and "B2 pack" at
  k = 19, 23 and 31;
- device_count end to end (stage, device, fetch; wall ms).
Then it records one device_count call with torch.profiler, writes the
Chrome trace to --trace if given, and prints the device's busy time by
category and its idle share over the call's wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile
import time

import torch

from .. import resolve_device
from ..core import io as core_io
from ..core import native
from ..core.kmer_counter import DEFAULT_VALUE_MAX
from ..ops import _build, backend
from ..ops import count as count_ops

REPS = 2
_BUSY = ("kernel", "gpu_memcpy", "gpu_memset")


def _wall(label: str, fn):
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    print(f"host {label}: {(time.perf_counter() - t) * 1e3:.3f} ms", flush=True)
    return out


def parse(path: str):
    """(codes, offsets) of the FASTA at `path`, by the steps
    KmerCounter.from_fasta takes."""
    if backend.host_library_loaded():
        data = _wall("read_file_bytes", lambda: core_io.read_file_bytes(path, ""))
        return _wall("parse_fasta_bytes", lambda: native.parse_fasta_bytes(data))
    lines = _wall("read_lines", lambda: core_io.read_lines(path, ""))
    reads = _wall("parse_fasta_lines", lambda: core_io.parse_fasta_lines(lines))
    return _wall("reads_to_codes", lambda: core_io.reads_to_codes(reads))


def device_steps(staged, k: int) -> None:
    """CUDA-event time of each step of count_kmers_frag on `staged`."""
    events = []

    def mark(step: str) -> None:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        events.append((step, e))

    mark("start")
    count_ops.count_kmers_frag(*staged, k, True, mark=mark)
    torch.cuda.synchronize()
    for (_, a), (step, b) in zip(events, events[1:]):
        print(f"device {step}: {a.elapsed_time(b):.4f} ms")
    total = events[0][1].elapsed_time(events[-1][1])
    print(f"device pipeline total: {total:.4f} ms", flush=True)


def profile_once(codes, offsets, k: int, device, trace_path: str) -> None:
    """One device_count call under torch.profiler: device busy time by
    category and the idle share of the call's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        backend.device_count(
            codes, offsets, k, True, device=device, value_max=DEFAULT_VALUE_MAX
        )
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = trace_path or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    by_cat = {}
    for e in events:
        if e.get("cat") in _BUSY:
            by_cat[e["cat"]] = by_cat.get(e["cat"], 0.0) + e["dur"] / 1e3
    busy = sum(by_cat.values())
    print(f"profiled device_count: wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / wall_ms:.4f}")
    print("device busy by category, ms: "
          + ", ".join(f"{c} {v:.4f}" for c, v in sorted(by_cat.items())))
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=15))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--k", type=int, default=15, choices=(15, 19, 23, 31))
    parser.add_argument(
        "--trace", default="",
        help="write the torch.profiler trace of one device_count call here",
    )
    parser.add_argument("fasta")
    args = parser.parse_args(argv)
    device = resolve_device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    _build.load()
    print(f"native host library loaded: {backend.host_library_loaded()} "
          f"({native.edition()})")
    for rep in range(REPS):
        print(f"--- rep {rep}", flush=True)
        codes, offsets = parse(args.fasta)
        staged = _wall(
            "stage (pack2 + upload)",
            lambda: backend.stage(codes, offsets, args.k, device),
        )
        device_steps(staged, args.k)
        keys, _ = _wall(
            "device_count (stage, device, fetch)",
            lambda: backend.device_count(
                codes, offsets, args.k, True, device=device,
                value_max=DEFAULT_VALUE_MAX,
            ),
        )
        print(f"n_unique {keys.shape[0]}", flush=True)
    profile_once(codes, offsets, args.k, device, args.trace)


if __name__ == "__main__":
    main()
