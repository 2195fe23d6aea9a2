"""Times the canonical build's unitig walk on a CUDA device both ways: on
the device (kernel W1, ops/walk.py) and on the host after downloading
the front-end's successor, over a sweep of set sizes.  The sweep behind
ops/backend.WALK_MIN_KMERS.

    python -m kmerset_tpu_torch.tools.time_walk [--k 15 23] [--reps 5]
        [--log2-bases 10 11 ... 22]

For each k and genome size (2^b random bases as 10 kb records, made from
a fixed seed, so every run times the same data) it times
core/spss.get_unitigs_canonical on "cuda" (front-end, walk and emission,
all the downloads) with the device walk and with the host walk, in turns
(device, host, host, device) after one call of each that is not timed,
and prints the k-mers, each side's median seconds, their ratio and
whether the two gave the same strings.  The card's name and power limit
come first.  Card only.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time
from unittest import mock

import numpy as np
import torch

SEED = 18
RECORD = 10_000


def kmer_set(k: int, n_bases: int):
    from kmerset_tpu_torch.core import kmer
    from kmerset_tpu_torch.core.kmer_set import KmerSet

    codes = np.random.default_rng(SEED).integers(0, 4, n_bases, dtype=np.uint8)
    parts = [kmer.kmers_from_codes(codes[i : i + RECORD], k)
             for i in range(0, n_bases, RECORD)]
    A = np.unique(kmer.canonical(np.concatenate(parts), k))
    return KmerSet(k, A, _sorted=True)


def build(ks, on_device: bool):
    """(seconds, strings) of one get_unitigs_canonical on the card, the
    walk on the device or on the host."""
    from kmerset_tpu_torch.core import spss
    from kmerset_tpu_torch.ops import backend

    least = 1 if on_device else 1 << 62
    with mock.patch.object(backend, "WALK_MIN_KMERS", least):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = spss.get_unitigs_canonical(ks, device="cuda")
        return time.perf_counter() - t0, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[15, 23])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--log2-bases", type=int, nargs="+",
                    default=list(range(10, 23)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_walk: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    print("k\tbases\tkmers\tdevice_s\thost_s\thost/device\tequal", flush=True)
    for k in args.k:
        for b in args.log2_bases:
            ks = kmer_set(k, 1 << b)
            _, want = build(ks, False)
            _, got = build(ks, True)
            equal = (np.array_equal(got.codes, want.codes)
                     and np.array_equal(got.offsets, want.offsets))
            dev, host = [], []
            for _ in range(args.reps):
                for side in (True, False, False, True):
                    (dev if side else host).append(build(ks, side)[0])
            d, h = statistics.median(dev), statistics.median(host)
            print(f"{k}\t{1 << b}\t{ks.size()}\t{d:.6f}\t{h:.6f}\t{h / d:.3f}\t"
                  f"{equal}", flush=True)
            if not equal:
                raise SystemExit(f"time_walk: k={k} 2^{b} bases: the device "
                                 "walk's strings differ from the host walk's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
