"""Times a large device-to-host copy on a CUDA device five ways: (a)
t.cpu().numpy(), as download() does below ops/backend.STAGED_MIN_BYTES;
(b) torch.from_numpy(out).copy_(t), into fresh pages and into an array
that the pooling allocator has recycled; (c) the DMA alone, into one
pinned buffer of the whole size; (d) the pinned ring of
ops/backend.copy_staged, into fresh pages (cold) and into an array
written before (warm), over a sweep of piece sizes, ring depths and
threads; (e) a pinned destination of its own from torch's caching host
allocator, with that cache emptied before each repetition (cold) and
kept (warm).  The measurement behind STAGED_MIN_BYTES and behind the
download's use of READ_PIECE_BYTES, READ_RING and READ_THREADS.

    python -m kmerset_tpu_torch.tools.time_download [--reps 3]
        [--mib 2048:int64 256:uint8] [--piece-mib 8]
        [--ring 8] [--threads 4 8]

Fresh pages are a private anonymous mapping of their own (mmap with
MAP_PRIVATE, as the pooling allocator and glibc map a large block), so
that every repetition faults its destination in again.  Each line gives
the way, its parameters, the median seconds over the repetitions and
GB/s (1e9 B); every copy is checked against the source's bytes once.
The card's name and power limit and how the pooling allocator was
installed come first.  Card only.
"""

from __future__ import annotations

import argparse
import mmap
import statistics
import subprocess
import time

import numpy as np
import torch


def fresh(nbytes: int, dtype) -> np.ndarray:
    """An array on private pages no one has touched yet."""
    pages = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS)
    return np.frombuffer(pages, dtype=dtype)


def empty_host_cache() -> None:
    """Frees the blocks that torch's caching host allocator keeps."""
    free = (getattr(torch._C, "_host_emptyCache", None)
            or getattr(torch._C, "_accelerator_emptyHostCache"))
    free()


def timed(fn, reps: int, before=None):
    """(median seconds, last result) of `reps` calls of fn, each after
    the previous result is dropped, `before` (untimed) and a device
    sync."""
    times, out = [], None
    for _ in range(reps):
        out = None
        if before is not None:
            before()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def main(argv=None) -> int:
    from kmerset_tpu_torch import pool
    from kmerset_tpu_torch.ops import backend

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mib", nargs="+", default=["2048:int64", "256:uint8"])
    ap.add_argument("--piece-mib", type=int, nargs="+", default=[8])
    ap.add_argument("--ring", type=int, nargs="+", default=[8])
    ap.add_argument("--threads", type=int, nargs="+", default=[4, 8])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_download: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; pool: {pool.how}", flush=True)
    print("size\tway\tparams\tseconds\tGB/s", flush=True)
    for spec in args.mib:
        mib, dtype_name = spec.split(":")
        dtype = getattr(torch, dtype_name)
        nbytes = int(mib) << 20
        n = nbytes // torch.empty(0, dtype=dtype).element_size()
        t = torch.randint(0, 255, (n,), dtype=torch.int64, device="cuda").to(dtype)
        want = t.cpu().numpy()
        npdtype = want.dtype

        def report(way: str, params: str, seconds: float, got) -> None:
            if not np.array_equal(got, want):
                raise SystemExit(f"time_download: {way} {params} differs")
            print(f"{spec}\t{way}\t{params}\t{seconds:.6f}\t"
                  f"{nbytes / seconds / 1e9:.3f}", flush=True)

        report("a_cpu_numpy", "-", *timed(lambda: t.cpu().numpy(), args.reps))
        report("b_copy_fresh", "-", *timed(
            lambda: torch.from_numpy(fresh(nbytes, npdtype)).copy_(t).numpy(),
            args.reps))
        warm = np.empty(n, npdtype)
        warm.fill(1)
        del warm  # back to the pool, warm

        def into_recycled():
            out = np.empty(n, npdtype)
            torch.from_numpy(out).copy_(t)
            return out

        hits0 = pool.module.stats()["pool_hits"] if pool.module else None
        seconds, got = timed(into_recycled, args.reps)
        hits = (pool.module.stats()["pool_hits"] - hits0
                if pool.module else "no pool")
        report("b_copy_recycled", f"pool_hits={hits}", seconds, got)
        pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        pinned_view = pinned.view(dtype)
        report("c_dma_pinned", "-", *timed(
            lambda: pinned_view.copy_(t, non_blocking=True), args.reps))
        del pinned, pinned_view

        def into_pinned():
            out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            return out.copy_(t).numpy()

        report("e_pinned_cold", "-", *timed(into_pinned, args.reps,
                                            before=empty_host_cache))
        report("e_pinned_warm", "-", *timed(into_pinned, args.reps))
        empty_host_cache()
        dest = np.empty(n, npdtype)
        dest.fill(1)
        for piece in args.piece_mib:
            for ring in args.ring:
                for threads in args.threads:
                    params = f"piece={piece}MiB ring={ring} threads={threads}"
                    kw = dict(piece=piece << 20, ring=ring, threads=threads)
                    report("d_ring_cold", params, *timed(
                        lambda: backend.copy_staged(t, fresh(nbytes, npdtype),
                                                    **kw), args.reps))
                    report("d_ring_warm", params, *timed(
                        lambda: backend.copy_staged(t, dest, **kw), args.reps))
        del t, want, dest
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
