"""Times the canonical path cover's candidate overlap edges on a CUDA
device both ways: on the device (kernel J1, ops/overlap.py) and on the
host (the native join and dedup), over a sweep of unitig counts.  The
sweep behind ops/backend.EDGES_MIN_UNITIGS.

    python -m kmerset_tpu_torch.tools.time_edges [--k 15 23] [--reps 5]
        [--log2-bases 12 13 ... 23]

For each k and genome size (2^b random bases as 10 kb records, made from
a fixed seed, so every run times the same data) it builds the canonical
unitigs once on "cuda", then times core/spss._candidate_port_edges_canonical
(first and last k-mers, join, dedup, the upload and download on J1's
route) with J1 and with the host join, in turns (device, host, host,
device) after one call of each that is not timed, and prints the
unitigs, the kept edges, each side's median seconds, their ratio and
whether the two gave the same edges.  The card's name and power limit
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

SEED = 22
RECORD = 10_000


def unitigs_of(k: int, n_bases: int):
    from kmerset_tpu_torch.core import kmer, spss
    from kmerset_tpu_torch.core.kmer_set import KmerSet

    codes = np.random.default_rng(SEED).integers(0, 4, n_bases, dtype=np.uint8)
    parts = [kmer.kmers_from_codes(codes[i : i + RECORD], k)
             for i in range(0, n_bases, RECORD)]
    A = np.unique(kmer.canonical(np.concatenate(parts), k))
    return spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device="cuda")


def edges(unitigs, k: int, on_device: bool):
    """(seconds, (pa, pb)) of one candidate-edge discovery on the card's
    route, J1 or the host join."""
    from kmerset_tpu_torch.core import spss
    from kmerset_tpu_torch.ops import backend

    least = 1 if on_device else 1 << 62
    with mock.patch.object(backend, "EDGES_MIN_UNITIGS", least):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = spss._candidate_port_edges_canonical(unitigs, k, device="cuda")
        return time.perf_counter() - t0, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, nargs="+", default=[15, 23])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--log2-bases", type=int, nargs="+",
                    default=list(range(12, 24)))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_edges: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    print("k\tbases\tunitigs\tedges\tdevice_s\thost_s\thost/device\tequal",
          flush=True)
    for k in args.k:
        for b in args.log2_bases:
            unitigs = unitigs_of(k, 1 << b)
            _, want = edges(unitigs, k, False)
            _, got = edges(unitigs, k, True)
            equal = all(np.array_equal(g, w) for g, w in zip(got, want))
            dev, host = [], []
            for _ in range(args.reps):
                for side in (True, False, False, True):
                    (dev if side else host).append(edges(unitigs, k, side)[0])
            d, h = statistics.median(dev), statistics.median(host)
            print(f"{k}\t{1 << b}\t{len(unitigs)}\t{want[0].shape[0]}\t{d:.6f}\t"
                  f"{h:.6f}\t{h / d:.3f}\t{equal}", flush=True)
            if not equal:
                raise SystemExit(f"time_edges: k={k} 2^{b} bases: J1's edges "
                                 "differ from the host join's")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
