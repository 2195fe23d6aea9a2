#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (kmerset_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the port's CUDA kernels from the checkout's sources, holds each
kernel against its plain PyTorch version on the card, then drives the
port's `kmerset-build --k 15 --check` on the card at 2^24 bases (run A,
cutoff 1) and on ~3x-coverage reads (run B, cutoff 2), and requires each
dump to be byte-identical to the reference CLI's host build of the same
input.  Inputs are made from fixed seeds under build/chip_smoke/.

Each phase prints one line.  The line before the last is a JSON summary of
the kernels; the last line is {"ok": true, "device": {...}}.  Any failure
raises, and the script exits non-zero without that line; it also exits
non-zero, printing nothing to stdout, when no CUDA device is present.
"""

from __future__ import annotations

import filecmp
import json
import logging
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 20241016
CLI_LOGGER = "kmerset"  # the logger kmerset-build writes its log lines to


def say(phase, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median per-call device time of `fn` in ms: CUDA events around
    `inner` back-to-back calls, `reps` times, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def environment(torch) -> str:
    from kmerset_tpu_torch.ops import _build, backend

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    nvcc = subprocess.run(
        [_build._nvcc(), "--version"], capture_output=True, text=True,
        check=True, timeout=60,
    ).stdout.strip().splitlines()
    gcc = subprocess.run(
        ["gcc", "--version"], capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()
    say(0, f"python {sys.version.split()[0]}, torch {torch.__version__}, "
           f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print(smi, flush=True)
    say(0, f"nvcc: {[l for l in nvcc if 'release' in l][-1]}; "
           f"gcc: {gcc[0] if gcc else 'not found'}; "
           f"libkmerio loaded: {backend.host_library_loaded()}")
    return smi


def build_kernels() -> float:
    from kmerset_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    say(1, f"kernels built and loaded in {dt:.3f} s "
           f"({os.path.basename(_build.library_path())})")
    for line in _build.build_log().splitlines():
        if "Used" in line or "Compiling entry" in line:
            say(1, "ptxas: " + line.split("ptxas info    :")[-1].strip())
    return dt


def check_pack(torch, rng) -> dict:
    from kmerset_tpu_torch.ops import backend, pack

    err, main_ms = 0, None
    for k, n in ((15, 1 << 24), (7, 1 << 20), (11, 1 << 20)):
        L = n + k - 1
        codes = rng.integers(0, 4, L, dtype=np.uint8)
        packed = backend.stage(codes, np.array([0, L]), k, "cuda").packed
        valid = torch.from_numpy(rng.random(n) > 0.01).cuda()
        for canonical, v in ((True, valid), (False, None)):
            got = pack.canonical_windows(packed, L, k, canonical, v)
            want = pack.canonical_windows_plain(packed, L, k, canonical, v)
            torch.cuda.synchronize()
            e = int((got.long() - want.long()).abs().max())
            if got.shape != (n,) or e != 0:
                raise AssertionError(f"B1 k={k} canonical={canonical}: max err {e}")
            err = max(err, e)
        ms = time_ms(lambda: pack.canonical_windows(packed, L, k, True, valid))
        plain = time_ms(
            lambda: pack.canonical_windows_plain(packed, L, k, True, valid), 3, 2
        )
        say(2, f"B1 pack k={k} windows={n}: equal to plain (canonical and "
               f"forward); kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if main_ms is None:
            main_ms = (ms, plain)
    return {"name": "B1 pack: canonical_windows", "route": "cuda",
            "source": "kmerset_tpu_torch/csrc/pack.cu",
            "replaces": "kmerset_tpu/ops/pallas_pack.py:34",
            "max_abs_err": err, "ms": main_ms[0], "plain_ms": main_ms[1]}


def check_compact(torch, rng) -> dict:
    from kmerset_tpu_torch.ops import compact

    err, main_ms = 0, None
    for n in (1 << 24, 5_000_011):
        lane0 = torch.from_numpy(
            rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
        ).cuda()
        lane1 = torch.arange(n, dtype=torch.int32, device="cuda")
        for frac in (0.0, 0.05, 0.5, 1.0):
            keep = torch.from_numpy(rng.random(n) < frac).cuda()
            for lanes in ([lane0], [lane0, lane1]):
                got, ns = compact.compact_select(lanes, keep)
                want, ns_p = compact.compact_select_plain(lanes, keep)
                m = int(ns_p)
                e = abs(int(ns) - m)
                for g, w in zip(got, want):
                    if m:
                        e = max(e, int((g[:m].long() - w[:m].long()).abs().max()))
                if e != 0:
                    raise AssertionError(
                        f"B3 n={n} lanes={len(lanes)} keep={frac}: max err {e}"
                    )
                err = max(err, e)
                if n == 1 << 24:
                    ms = time_ms(lambda: compact.compact_select(lanes, keep))
                    plain = time_ms(
                        lambda: compact.compact_select_plain(lanes, keep), 3, 2
                    )
                    say(3, f"B3 compact n={n} lanes={len(lanes)} keep={frac}: "
                           f"equal, n_sel={m}; kernel {ms:.4f} ms, "
                           f"plain {plain:.4f} ms")
                    if len(lanes) == 2 and frac == 1.0:
                        main_ms = (ms, plain)
        say(3, f"B3 compact n={n}: kernel equal to plain for 1 and 2 lanes, "
               "keep fractions 0, 0.05, 0.5, 1")
    return {"name": "B3 compact: compact_select", "route": "cuda",
            "source": "kmerset_tpu_torch/csrc/compact.cu",
            "replaces": "kmerset_tpu/ops/pallas_compact.py:118",
            "max_abs_err": err, "ms": main_ms[0], "plain_ms": main_ms[1]}


_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_genome_fasta(path: str, rng, n_bases: int) -> None:
    """Random genome as 10 kb reads, plus 8 reads carrying runs of N."""
    codes = rng.integers(0, 4, n_bases, dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(0, n_bases, 10_000):
            f.write(b">r%d\n" % (i // 10_000))
            f.write(_BASES[codes[i : i + 10_000]].tobytes() + b"\n")
        for j in range(8):
            s = int(rng.integers(0, n_bases - 10_000))
            read = _BASES[codes[s : s + 10_000]].copy()
            for _ in range(5):
                a = int(rng.integers(0, 10_000))
                read[a : a + int(rng.integers(1, 40))] = ord("N")
            f.write(b">n%d\n" % j + read.tobytes() + b"\n")


def write_reads_fasta(path: str, rng, genome_bases: int, coverage: float) -> None:
    """2 kb reads sampled from both strands of a random genome."""
    genome = rng.integers(0, 4, genome_bases, dtype=np.uint8)
    read_len = 2_000
    n_reads = int(coverage * genome_bases / read_len)
    with open(path, "wb") as f:
        for j in range(n_reads):
            s = int(rng.integers(0, genome_bases - read_len))
            r = genome[s : s + read_len]
            if rng.random() < 0.5:
                r = 3 - r[::-1]
            f.write(b">s%d\n" % j + _BASES[r].tobytes() + b"\n")


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append((record.created, record.getMessage()))


_LOGGED = ("cutoff_count", "kmer_set.Size()", "kmer_set.Hash()",
           "kmer_set_compact.Size()")


def _logged_values(lines) -> dict:
    out = {}
    for line in lines:
        for key in _LOGGED:
            m = re.search(re.escape(key) + r" = (\d+)", line)
            if m:
                out[key] = int(m.group(1))
    return out


def main_path_run(tag: str, fasta: str, cutoff: int) -> dict:
    """Port CLI in-process on cuda against the reference CLI's host build
    in a subprocess; returns the port's phase times."""
    from kmerset_tpu_torch.cli import kmerset_build
    from kmerset_tpu_torch.ops import compact, pack

    stem = os.path.splitext(fasta)[0]
    out_port, out_ref = f"{stem}_port.txt", f"{stem}_ref.txt"
    cap = _Capture()
    log = logging.getLogger(CLI_LOGGER)
    log.addHandler(cap)
    pack.launches = compact.launches = 0
    t0 = time.time()
    try:
        kmerset_build.main([
            "--device", "cuda", "--k", "15", "--cutoff", str(cutoff),
            "--check", "--out", out_port, fasta,
        ])
    finally:
        log.removeHandler(cap)
    t_end = time.time()
    launches = {"pack": pack.launches, "compact": compact.launches}

    env = dict(os.environ, KMERSET_TPU_FORCE_BACKEND="host", JAX_PLATFORMS="cpu")
    r0 = time.perf_counter()
    ref = subprocess.run(
        [sys.executable, "-m", "kmerset_tpu.cli.kmerset_build", "--k", "15",
         "--cutoff", str(cutoff), "--check", "--out", out_ref, fasta],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=900,
    )
    ref_s = time.perf_counter() - r0
    if ref.returncode != 0:
        raise RuntimeError(f"reference CLI failed:\n{ref.stderr[-4000:]}")

    msgs = [m for _, m in cap.records]
    at = {m: t for t, m in cap.records}
    if "kmer_set_compact -> KmerSet: ok" not in msgs:
        raise AssertionError(f"{tag}: the port's --check did not log ok")
    if "kmer_set_compact -> KmerSet: ok" not in ref.stderr:
        raise AssertionError(f"{tag}: the reference's --check did not log ok")
    mine, theirs = _logged_values(msgs), _logged_values(ref.stderr.splitlines())
    if mine != theirs or len(mine) != len(_LOGGED):
        raise AssertionError(f"{tag}: logged values differ: {mine} vs {theirs}")
    if not filecmp.cmp(out_port, out_ref, shallow=False):
        raise AssertionError(f"{tag}: dump differs from the reference's")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched")
    times = {
        "count_s": at["constructed kmer_counter"] - at["constructing kmer_counter"],
        "spss_host_s": at["constructed kmer_set_compact"]
        - at["constructing kmer_set_compact"],
        "check_s": at["kmer_set_compact -> KmerSet: ok"]
        - at["constructed kmer_set_compact"],
        "total_s": t_end - t0,
        "reference_host_total_s": ref_s,
    }
    say(tag, f"--k 15 --cutoff {cutoff} --check: dump byte-identical to the "
             f"reference host CLI ({os.path.getsize(out_port)} bytes); "
             f"size {mine['kmer_set.Size()']}, hash {mine['kmer_set.Hash()']}, "
             f"cutoff_count {mine['cutoff_count']}; check ok; "
             f"launches {launches}")
    say(tag, "wall s: " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()))
    return {"launches": launches, **times}


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    # Pin the reused reference host code to its host arms before any of it
    # runs, so nothing in this process imports JAX.
    os.environ["KMERSET_TPU_FORCE_BACKEND"] = "host"
    import kmerset_tpu_torch  # noqa: F401 - fails outside a checkout

    os.makedirs(WORK, exist_ok=True)
    # The CLI's log lines, at info level, on stderr; the CLI's own logger
    # set-up leaves a logger that already has a handler as it is.
    log = logging.getLogger(CLI_LOGGER)
    log.setLevel(logging.INFO)
    log.propagate = False
    echo = logging.StreamHandler(sys.stderr)
    echo.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
    log.addHandler(echo)
    environment(torch)
    build_kernels()
    rng = np.random.default_rng(SEED)
    kernels = [check_pack(torch, rng), check_compact(torch, rng)]

    fasta_a = os.path.join(WORK, "run_a.fa")
    write_genome_fasta(fasta_a, rng, 1 << 24)
    run_a = main_path_run("4 run A", fasta_a, 1)
    fasta_b = os.path.join(WORK, "run_b.fa")
    write_reads_fasta(fasta_b, rng, 1 << 22, 3.0)
    run_b = main_path_run("5 run B", fasta_b, 2)

    for kern, key in zip(kernels, ("pack", "compact")):
        kern["launches"] = run_a["launches"][key] + run_b["launches"][key]
    if "jax" in sys.modules:
        raise AssertionError("jax was imported during the port's run")
    say(6, f"launch counts over runs A and B: pack {kernels[0]['launches']}, "
           f"compact {kernels[1]['launches']}; jax not in sys.modules")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
