"""Times kernel B3 (ops/compact.compact_select) on a CUDA device at the five
shapes the count and decode launch.

    python kmerset_tpu_torch/tools/time_compact.py [--root DIR] [--n N] [--trace]

--root DIR times the kmerset_tpu_torch package of the checkout at DIR (by
default the one that holds this file), so that two commits are compared
on one card: unpack the other into a git-ignored directory and run the
two in turns, A B B A, each in its own process.  Inputs are made from a
fixed seed, so every run times the same data.  Per shape (n = 2^24
unless --n says otherwise) it
prints the kernel's time by CUDA events (the median of 7 batches of 10
back-to-back calls, each batch queued behind a ~10 ms device sleep), the
bytes bound at 3.35 TB/s, its share, `lane[keep]` per lane, and the
wrapper's host time per call.  --trace also records 10 calls per shape
with torch.profiler and prints the device time per call of each kernel
and memset it ran, and the share of the call's device span they leave
idle.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's memory rate (NVIDIA data sheet)
SEED = 5
# (name, lane dtypes, keep fraction): the k = 15 count, the k = 19/23
# count, the k = 15 decode, the k = 19/23 decode, one lane at 5% kept.
SHAPES = (
    ("2 int32 lanes, all kept", ("int32", "int32"), 1.0),
    ("int64 + int32, all kept", ("int64", "int32"), 1.0),
    ("1 int32 lane, all kept", ("int32",), 1.0),
    ("1 int64 lane, all kept", ("int64",), 1.0),
    ("1 int32 lane, 5% kept", ("int32",), 0.05),
)


def time_ms(torch, fn, reps: int = 7, inner: int = 10) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def trace(torch, fn, calls: int = 10) -> str:
    """Device time per call of each kernel and memset in `calls` calls,
    and the idle share of their device span, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        return "trace: no device events recorded"
    per = {}
    for start, end, name in spans:
        per[name] = per.get(name, 0.0) + (end - start) / calls / 1e3
    busy = sum(end - start for start, end, _ in spans)
    span = max(e for _, e, _ in spans) - min(s for s, _, _ in spans)
    return ("trace per call: " + ", ".join(
        f"{name[:60]} {ms:.4f} ms" for name, ms in sorted(per.items()))
        + f"; device idle {100 * (1 - busy / span):.1f}% of the span")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--root", default=here)
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from kmerset_tpu_torch.ops import _build, compact

    if not torch.cuda.is_available():
        print("time_compact: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    print(f"root {os.path.abspath(args.root)}; {smi[0] if smi else 'no nvidia-smi'}")
    _build.load()
    N = args.n
    rng = np.random.default_rng(SEED)
    lane = {"int32": torch.from_numpy(rng.integers(
                -(1 << 31), (1 << 31) - 1, N, dtype=np.int32)).cuda(),
            "int64": torch.from_numpy(rng.integers(
                -(1 << 62), 1 << 62, N, dtype=np.int64)).cuda()}
    pos = torch.arange(N, dtype=torch.int32, device="cuda")
    for name, kinds, frac in SHAPES:
        keep = torch.from_numpy(rng.random(N) < frac).cuda()
        lanes = [lane[kinds[0]]] + [pos] * (len(kinds) - 1)
        got, n_sel = compact.compact_select(lanes, keep)
        want, m = compact.compact_select_plain(lanes, keep)
        m = int(m)
        if int(n_sel) != m or not all(
                torch.equal(g[:m], w[:m]) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: not equal to the plain version")
        ms = time_ms(torch, lambda: compact.compact_select(lanes, keep))
        library = time_ms(torch, lambda: [x[keep] for x in lanes])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            compact.compact_select(lanes, keep)
        host = (time.perf_counter() - t0) * 10
        torch.cuda.synchronize()
        width = sum(x.element_size() for x in lanes)
        n_bytes = N * (1 + width) + m * width
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        print(f"n={N} {name}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
              f"({n_bytes / N:.2f} B per element), {100 * bound / ms:.1f}% "
              f"of bound; lane[keep] per lane {library:.4f} ms; wrapper host "
              f"time {host:.4f} ms per call", flush=True)
        if args.trace:
            print(f"{name}: " + trace(
                torch, lambda: compact.compact_select(lanes, keep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
