#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (kmerset_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phase 0 loads the native host library and prints which edition each side
runs: the checkout's native/libkmerio.so, or, where that does not load,
the port's serial edition of native/kmerio.c (built by
kmerset_tpu_torch/_nativebuild.py, with its compile time).  It fails when
neither loads: the machine has a C compiler, so the numpy fallbacks would
be a fault here.  The reference's walk orders strings differently with
and without the library, so its CLIs must run the same code: when the
port runs the serial edition, the reference runs from a copy of its
package under build/chip_smoke/ref_tree/ whose native/libkmerio.so is
that edition, and a pre-flight subprocess there must load it.

Then it builds the port's CUDA kernels from the checkout's sources, times
one kmerset-build in a new process (its library load must find the
edition built and compile nothing), and holds each kernel against its
plain PyTorch version on the card: B1 (pack) at
every k from 1 to 15 and B2 at every k from 16 to 31, canonical and
forward, with and without `valid`, at n = 1, below one tile, a ragged
last tile and 2^24 windows; B3 (the one-pass compaction) at n = 1, below
one tile, a ragged tile, 5,000,011 and 2^24, keep fractions 0 to 1, 1 to
3 int32 or int64 lanes, bool and uint8 keep, and views at element offset
1 (its element-by-element path); the unitig graph front-end against
itself on the CPU; and (phase 4w) kernel W1, the canonical unitig walk
and emission, stage by stage against its plain version at the assembly
cell's shape (4.6M k-mers at k = 15), and core/spss.get_unitigs_canonical
with the device walk against the host walk, byte for byte, at k = 15 and
23; and (phase 4j) kernel J1, the path cover's candidate overlap edges,
against its plain version and the host's native join and dedup at the
same shape, with its peak device bytes a unitig against
ops/backend.EDGES_BYTES_PER_UNITIG; and (phase 4p) kernel P1, the
count's FASTA parse and pack, against its plain version and the host's
parse on fuzzed texts and at the benchmark's reads, chr1 and dmel FASTA,
and a build of the reads cell's input byte-identical on both routes.
Each kernel is timed at the main path's shapes beside its bound (the bytes it must move over the card's 3.35 TB/s), its plain
version, its wrapper's host time per call and, for B3, the one PyTorch
call that computes the same function (`lane[keep]` per lane), at the
five shapes the count and decode launch.  Then it drives the port's
`kmerset-build --check` on the card: run A (k = 15, a 2^24-base genome,
cutoff 1), run C (k = 23, the same genome, cutoff 1), run D (k = 19,
~3x-coverage reads of a 2^22-base genome, cutoff 2) and run E (k = 31,
run A's genome, cutoff 1) and run F (k = 15, run A's genome, the directed
graph: --canonical=false, its side tables on the card).  Each dump must
be byte-identical to the reference CLI's host build of the same input
(those run as subprocesses beside the port's runs), and each run must go
through its kernels and the device graph front-end.  Runs A, C and E run
again on a mesh of 4 shards of one card (--device
cuda:0,cuda:0,cuda:0,cuda:0: the count, the graph phases and the decode
on the mesh), and over every card where there are several, each dump
byte-identical to that run's reference dump.  Then it checks the out-of-core paths (the
chunked count of run A's input at k = 15, 23 and 31 and the decode of run
C's dump, each equal to its one-shot result, with the bytes per window
behind the memory ceiling measured; the front-end in query chunks and in
its bounded mode, equal to one shot, with its bytes per k-mer measured,
and the device walk from the bounded mode's rows kept on the card, its
bytes per k-mer against WALK_BYTES_PER_KMER),
each mesh program (count, front-end, pointer doubling, chain grouping,
emission, overlap edges, matching) at 1 and 4 shards of one card on run
A's and run C's inputs and sets against the single-device or host
result, and the multi-set programs (the XOR hash, the set algebra) at 1
and 4 shards on run A's set and a set made from the seed against numpy,
run A's SPSS build on a 1-shard mesh timed in turns against the
single-device path's host walk and path cover, the sketch table at 100
sets on the card against the CPU, and the same rows in the
key-range-sharded mesh table on 1 and 4 shards of one card against the
single table, and runs M (k = 15) and M31 (k = 31): the multi-set round
trip (eight related strains built, jointly compressed, decompressed,
`kmerset-stat` and `spss-benchmark`) through the port's CLIs on the card
against the reference's host CLIs: byte-identical directories and DOT
files, equal hashes, sizes, TSV and weights.  Phase 18 runs M's and
M31's compress, decompress, stat and spss-benchmark again on 4 shards of
one card (and over every card where there are several) against the same
reference outputs; the compress must take the mesh's sketch table, and
decode and build on the mesh.  Phase 19 runs the port's CLIs as a
process group of two ranks over KMERSET_TPU_DISTRIBUTED, both on cuda:0
(rank 0 with two shards, rank 1 with one: the exchanges go through the
host, gloo, since both ranks hold the card): runs A and C (each rank's
dump byte-identical to the reference dump of phases 5 and 6) and run M's
compress (`--workers 4`; each rank's directory and DOT byte-identical to
phase 11's reference); each rank's launch counts join the kernels line,
and its wall and mesh steps print beside the single-process 3-shard mesh
and the single device (for run M also the single-process mesh with
--workers 1: the item order a group imposes).  It also runs run C in a group of one rank on
`cuda:0,cuda:0`, whose exchanges go over NCCL on the card, and over one
rank per card (NCCL) where there are several cards.  Phase 20 drives the
library surface on the card: the unpacked-code count entries
(ops/count.count_kmers, count_to_set at cutoffs 1 and 2) on run A's
genome at k = 15, 23 and 31, against backend.device_count and against
their plain versions on the card, each timed by CUDA events; and
KmerSet's queries and algebra on run A's set and a set from the seed,
with intersection_size and ops/join.intersection_count, a KmerCounter of
run D's reads with 10^4 adds, get_random_kmer_set_set dumped, and
utils/io.get_kmer_set_from_file of run A's dump, each against the
reference's same calls in a subprocess (byte-identical directory, equal
arrays, sizes and hashes).  Phase 21 runs runs A, C, E and F again with
KMERSET_TPU_LINK=slow (the gap-encoded key download, the side-code
front-end built on the resident handle), each dump byte-identical to
its reference dump; run A must take the gap format, and each canonical
run must build its side codes on the resident set; it holds the gap encode and the side
codes against their plain versions on the CPU copy of the input, the
successor rebuilt from the card's side codes against the card's
front-end, and run D's handle filter against the host filter, prints
each download's bytes and seconds, the decode, the succ rebuild, peak
device memory and the pooling allocator's state.  Phase 22 runs the
multi-set CLIs at k = 19 and 23 (runs M19 and M23, on run M's strains)
against the reference's, then kmerset-build --check at genome scale at
the card's natural memory budget, nothing forced: G23 (a 2^28-base
genome as 10 kb reads, k = 23, above the front-end's one-shot ceiling:
its bounded mode keeps the rows on the card and W1 walks them, counted
in walk.bounded) and R19 (8x coverage in 2 kb reads of both strands of a
2^27-base genome, k = 19, cutoff 2, above the count's one-shot
ceiling).  Each run's count, front-end and check plans must be
those that window_ceiling and front_end_plan give at a budget
memory_budget returned during the run (backend.count_plan's and the
front-end's decisions), with as many chunks merged as planned; R19's
count must take more than one chunk, and the dump's set, decoded on the card, must equal by
torch.equal a plain count on the card (groups of whole reads through
the plain B2 and torch.unique), hold each k-mer once and give
kmerset-stat's size and hash; it prints the phase times, the host
merges, the front-end's download, peak device bytes per window and per
k-mer beside the memory constants, and the host's peak RSS.  The
reference's host CLI is not run at that size here.  Inputs are made
from fixed seeds under build/chip_smoke/.

Each phase prints one line.  The line before the last is a JSON summary of
the kernels; the last line is {"ok": true, "device": {...}}.  Any failure
raises, and the script exits non-zero without that line; it also exits
non-zero, printing nothing to stdout, when no CUDA device is present.
The port's process imports neither JAX nor the JAX package (kmerset_tpu):
the reference runs only in the subprocesses of its CLIs, and the script
checks sys.modules for both at the end.
"""

from __future__ import annotations

import contextlib
import filecmp
import io
import json
import logging
import os
import re
import resource
import shutil
import statistics
import subprocess
import sys
import threading
import time
from typing import Tuple

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 20241016
CLI_LOGGER = "kmerset"  # the logger kmerset-build writes its log lines to
DEVICE = "cuda"  # of the out-of-core, sketch and run M phases
MESH_DEVICE = "cuda:0"  # the card the mesh phase puts its shards on
HBM_BYTES_PER_S = 3.35e12  # one H100 SXM's memory rate (NVIDIA data sheet)
# One H100's published rate for scalar 32-bit work outside the tensor
# cores (67 TFLOP/s float32), the yardstick of the kernels' integer and
# bit operations.
SCALAR_OPS_PER_S = 67e12
# Integer operations per window of B1/B2 (two funnel shifts, mask, bit
# reversal and pair swap, complement, min, valid test), counted from
# csrc/pack.cu.  B3 (csrc/compact.cu), per element: 4 for the flags (per
# 16: four nonzero-byte tests of 4 operations, their merge, popc, the
# 5-step shuffle scan, the 8 warp totals, the owner word), plus 12 per
# lane (per 16-byte load: the owner shuffle, offsets, bounds test and
# first rank; per element: the flag bit test, the shared-memory write and
# rank step, the shared-memory read and its share of the 16-byte store).
PACK_OPS_PER_WINDOW = 24
COMPACT_OPS_PER_ELEMENT = 4
COMPACT_OPS_PER_LANE_ELEMENT = 12
# The kernels whose launches the runs count: the tracer's launch.<name>.
KERNELS = ("B1", "B2", "B3", "W1", "J1", "P1")
# The tracer's counts of the canonical builds' sets walked on the card
# (kernel W1) and on the host, which the runs count beside the launches.
WALKS = ("walk.device", "walk.host")
# Of those on the card, the sets W1 walked from the bounded front-end.
BOUNDED_WALKS = "walk.bounded"
# Every counter a run reports under "launches", the process-group ranks' too.
COUNTED = (*KERNELS, *WALKS, BOUNDED_WALKS)
# Each answer of ops/backend.walk_route in this process, (k-mers, on the
# card), in order: main() puts a spy that changes nothing in its place.
_ROUTES: list = []


def say(phase, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def time_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median per-call device time of `fn` in ms: CUDA events around
    `inner` back-to-back calls, `reps` times, after a warm-up.  Each
    repetition first queues a ~10 ms device sleep, so that the host has
    queued all `inner` calls before the first starts: a wrapper's host
    cost (phase 2 prints B1's and B2's) would otherwise be timed in
    place of a kernel that is as short."""
    import torch

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


def host_ms(torch, fn, calls: int = 100) -> float:
    """A wrapper's own host cost per call, the card left to catch up."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def environment(torch) -> str:
    from kmerset_tpu_torch.core import native
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
           f"numpy {np.__version__}, CUDA {torch.version.cuda}, device "
           f"{torch.cuda.get_device_name(0)}")
    print(smi, flush=True)
    with open("/proc/meminfo") as f:
        mem_total = next(l.split(":")[1].strip() for l in f
                         if l.startswith("MemTotal:"))
    say(0, f"nvcc: {[l for l in nvcc if 'release' in l][-1]}; "
           f"gcc: {gcc[0] if gcc else 'not found'}; host MemTotal {mem_total}, "
           f"{os.cpu_count()} CPUs")
    t0 = time.perf_counter()
    loaded = backend.host_library_loaded()
    load_s = time.perf_counter() - t0
    ed = native.edition()
    if not loaded or ed is None:
        raise AssertionError(
            "no native host library loaded: neither native/libkmerio.so nor "
            "the port's serial edition (is there a C compiler?)")
    built = (f"compiled in {ed.build_s:.3f} s" if ed.build_s is not None
             else "found built")
    say(0, "port's libkmerio: " + (
        f"serial edition (no OpenMP; --workers does nothing), {built}"
        if ed.serial else "the checkout's native/libkmerio.so")
        + f", {os.path.relpath(ed.path, ROOT)}; first load {load_s:.3f} s")
    RefCli.cwd = reference_tree(ed)
    ref = reference_edition(RefCli.cwd)
    say(0, "reference's libkmerio (pre-flight subprocess in "
           f"{os.path.relpath(RefCli.cwd, ROOT) or '.'}): loaded "
           f"{ref['loaded']}, {os.path.relpath(ref['path'], RefCli.cwd)}, "
           f"package {os.path.relpath(ref['package'], RefCli.cwd)}")
    return smi


REF_TREE = os.path.join(WORK, "ref_tree")


def reference_tree(ed) -> str:
    """The directory the reference's CLIs run from.  With the checkout's
    library loaded, the checkout's root.  With the serial edition, a copy
    of the reference's package and native/{kmerio.c,Makefile} under
    build/chip_smoke/ref_tree/, whose native/libkmerio.so is that edition,
    newer than kmerio.c, so that the reference's own build step leaves it
    as it is.  Nothing of the checkout's kmerset_tpu/ or native/ is
    written to."""
    if not ed.serial:
        return ROOT
    if os.path.isdir(REF_TREE):
        shutil.rmtree(REF_TREE)
    shutil.copytree(os.path.join(ROOT, "kmerset_tpu"),
                    os.path.join(REF_TREE, "kmerset_tpu"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.makedirs(os.path.join(REF_TREE, "native"))
    for name in ("kmerio.c", "Makefile"):
        shutil.copy2(os.path.join(ROOT, "native", name),
                     os.path.join(REF_TREE, "native", name))
    lib = os.path.join(REF_TREE, "native", "libkmerio.so")
    shutil.copyfile(ed.path, lib)
    later = os.path.getmtime(os.path.join(REF_TREE, "native", "kmerio.c")) + 1
    os.utime(lib, (later, later))
    return REF_TREE


_PREFLIGHT = (
    "import json, kmerset_tpu\n"
    "from kmerset_tpu.core import native\n"
    "print(json.dumps({'loaded': native.get_lib() is not None,\n"
    "                  'path': native._find_lib() or '',\n"
    "                  'package': kmerset_tpu.__file__}))\n"
)


def reference_edition(cwd: str) -> dict:
    """Which library the reference's CLIs load from `cwd`: a subprocess
    with their environment.  Fails unless it loads that tree's
    native/libkmerio.so."""
    env = dict(os.environ, KMERSET_TPU_FORCE_BACKEND="host", JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _PREFLIGHT], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"reference pre-flight failed:\n{out.stderr[-4000:]}")
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    want = os.path.join(cwd, "native", "libkmerio.so")
    if not ref["loaded"] or os.path.realpath(ref["path"]) != os.path.realpath(want) \
            or not os.path.realpath(ref["package"]).startswith(os.path.realpath(cwd)):
        raise AssertionError(f"the reference does not load {want}: {ref}")
    return ref


def build_kernels() -> float:
    from kmerset_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load()
    dt = time.perf_counter() - t0
    say(1, f"kernels built and loaded in {dt:.3f} s "
           f"({os.path.basename(_build.library_path())})")
    for line in _build.build_log().splitlines():
        if "Used" in line or "Compiling entry" in line or "spill" in line:
            say(1, "ptxas: " + line.split("ptxas info    :")[-1].strip())
    return dt


_PORT_CLI = (
    "import json, subprocess, sys, time\n"
    "t0 = time.perf_counter()\n"
    "import torch\n"
    "from kmerset_tpu_torch.core import native\n"
    "t1 = time.perf_counter()\n"
    "ran, run = [], subprocess.run\n"
    "subprocess.run = lambda args, **kw: ran.append(args[0]) or run(args, **kw)\n"
    "ed = native.edition()\n"
    "subprocess.run = run\n"
    "t2 = time.perf_counter()\n"
    "from kmerset_tpu_torch.cli import kmerset_build\n"
    "kmerset_build.main(sys.argv[1:])\n"
    "print(json.dumps({'import_s': t1 - t0, 'load_s': t2 - t1,\n"
    "                  'cli_s': time.perf_counter() - t2, 'ran': ran,\n"
    "                  'serial': ed.serial, 'build_s': ed.build_s}))\n"
)


def fresh_cli_process() -> None:
    """The port's kmerset-build in a new process, as a user runs it, on a
    2^20-base genome: its wall, its imports, and its native library's
    load, which must find the library built and run no build (where the
    OpenMP `make` failed in phase 0, its recorded failure skips it)."""
    fasta = os.path.join(WORK, "small.fa")
    write_genome_fasta(fasta, np.random.default_rng(SEED + 1), 1 << 20)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_CLI, "--device", "cuda", "--k", "15",
         "--check", "--out", os.path.join(WORK, "small_port.txt"), fasta],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or "KmerSet: ok" not in proc.stdout + proc.stderr:
        raise AssertionError(f"a fresh port CLI process failed:\n"
                             f"{proc.stderr[-4000:]}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    if info["build_s"] is not None or info["ran"]:
        raise AssertionError(f"a fresh process built libkmerio again: {info}")
    say(1, f"a fresh kmerset-build process (--k 15 --check, 2^20 bases): "
           f"wall {wall:.3f} s; import of torch and the port "
           f"{info['import_s']:.3f} s, libkmerio load {info['load_s']:.4f} s ("
           + ("serial edition" if info["serial"] else "the checkout's library")
           + f", found built, no build run), the CLI {info['cli_s']:.3f} s")


def bound_ms(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """The least time one H100 could take for a kernel's work: the larger
    of its bytes over the memory rate and its operations over the scalar
    rate, in ms, and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


PACK_TILE = 4096  # windows per tile of csrc/pack.cu (kTile)
# Window counts of the edge cases: one window, below one tile, a ragged
# last tile, and several tiles with a packed length that is no multiple
# of 16 bytes (ceil((2^16 + 4 + k) / 4) = 16385 + ceil(k / 4) bytes).
PACK_EDGES = (1, 1000, 5 * PACK_TILE + 77, (1 << 16) + 5)


def _packed_input(rng, k: int, n: int):
    from kmerset_tpu_torch.ops import backend

    L = n + k - 1
    codes = rng.integers(0, 4, L, dtype=np.uint8)
    if n > 100:  # a run of one base: the extreme keys 0 and 4^k - 1
        codes[: n // 4] = 3 * (k % 2)
    return L, backend.stage(codes, np.array([0, L]), k, "cuda").packed


def check_pack(torch, rng, kernel: str, ks, timed) -> dict:
    """Kernel B1 or B2 against the plain version at every k in `ks` and
    window count in PACK_EDGES, and at 2^24 windows for each k in `timed`,
    canonical and forward, with and without `valid`; times it at 2^24
    windows beside its bound.  Returns its kernel-line entry, timed at
    the first of `timed` (the main path's k = 15 or 31)."""
    from kmerset_tpu_torch.ops import pack

    err, main, n_cases = 0, None, 0
    cases = [(k, n) for k in ks for n in PACK_EDGES] + [(k, 1 << 24) for k in timed]
    for k, n in cases:
        L, packed = _packed_input(rng, k, n)
        valid = torch.from_numpy(rng.random(n) > 0.01).cuda()
        for canonical in (True, False):
            for v in (valid, None):
                got = pack.canonical_windows(packed, L, k, canonical, v)
                want = pack.canonical_windows_plain(packed, L, k, canonical, v)
                torch.cuda.synchronize()
                e = int((got - want).abs().max())
                if got.shape != (n,) or got.dtype != want.dtype or e != 0:
                    raise AssertionError(
                        f"{kernel} k={k} n={n} canonical={canonical} "
                        f"valid={v is not None}: max err {e}"
                    )
                err = max(err, e)
                n_cases += 1
        if n != 1 << 24:
            continue
        ms = time_ms(lambda: pack.canonical_windows(packed, L, k, True, valid))
        plain = time_ms(
            lambda: pack.canonical_windows_plain(packed, L, k, True, valid), 3, 2
        )
        host = host_ms(torch, lambda: pack.canonical_windows(packed, L, k, True, valid))
        # Each input byte read once (packed codes, valid), each key
        # written once.
        n_bytes = packed.shape[0] + n * (1 + got.element_size())
        bound, by = bound_ms(n_bytes, PACK_OPS_PER_WINDOW * n)
        say(2, f"{kernel} pack k={k} windows={n} ({got.dtype}): kernel "
               f"{ms:.4f} ms, bound {bound:.4f} ms ({by}: {n_bytes / n:.2f} "
               f"B per window), {100 * bound / ms:.1f}% of bound, "
               f"{n_bytes / ms / 1e9:.3f} TB/s; plain {plain:.4f} ms; "
               f"wrapper host time {host:.4f} ms per call")
        if main is None:
            main = (ms, plain, bound, by)
    say(2, f"{kernel} pack: equal to plain in all {n_cases} cases (k = "
           f"{ks[0]}..{ks[-1]} at n = {', '.join(map(str, PACK_EDGES))}, and "
           f"k = {', '.join(map(str, timed))} at 2^24; canonical and forward, "
           "with and without valid)")
    replaces = {"B1": "kmerset_tpu/ops/pallas_pack.py:34",
                "B2": "kmerset_tpu/ops/pallas_pack.py:85"}[kernel]
    return {"name": f"{kernel} pack: canonical_windows", "route": "cuda",
            "source": "kmerset_tpu_torch/csrc/pack.cu", "replaces": replaces,
            "max_abs_err": err, "ms": main[0], "plain_ms": main[1],
            "bound_ms": main[2], "bound_by": main[3], "library_ms": None}


COMPACT_LANES = {"int32": ("int32",), "int32 x2": ("int32", "int32"),
                 "int32 x3": ("int32",) * 3, "int64": ("int64",),
                 "int64+int32": ("int64", "int32")}
# The shapes the main path launches, timed at 2^24: the k = 15 count (two
# int32 lanes, all kept: the first is the kernels line's), the k = 19/23
# count, the k = 15 and k = 19/23 decodes, and one int32 lane at 5% kept.
COMPACT_TIMED = (("int32 x2", 1.0), ("int64+int32", 1.0), ("int32", 1.0),
                 ("int64", 1.0), ("int32", 0.05))


def check_compact(torch, rng) -> dict:
    """Kernel B3 against the plain version at n = 1, 1000, one tile + 77,
    5,000,011 and 2^24, keep fraction 0, 0.05, 0.5 and 1, and every lane
    set in COMPACT_LANES, with bool keep, uint8 keep whose kept bytes hold
    2..255, and views at element offset 1 of keep, of every lane and of
    the last lane alone (not 16-byte aligned: the kernel's
    element-by-element path).  Times the COMPACT_TIMED shapes at 2^24
    beside their bound."""
    from kmerset_tpu_torch.ops import compact

    err, n_cases, main = 0, 0, None
    # One element, below one tile, a tile and 77, two of the main path's.
    for n in (1, 1000, compact.TILE + 77, 5_000_011, 1 << 24):
        # n + 1 elements each, so that [1:] is a view at an odd offset.
        pool = {"int32": [torch.from_numpy(rng.integers(
                    -(1 << 31), (1 << 31) - 1, n + 1, dtype=np.int32)).cuda()
                    for _ in range(3)],
                "int64": [torch.from_numpy(rng.integers(
                    -(1 << 62), 1 << 62, n + 1, dtype=np.int64)).cuda()]}
        for frac in (0.0, 0.05, 0.5, 1.0):
            kept = rng.random(n + 1) < frac
            keep_bool = torch.from_numpy(kept).cuda()
            keep_u8 = torch.from_numpy(np.where(
                kept, rng.integers(2, 256, n + 1), 0).astype(np.uint8)).cuda()
            for name, kinds in COMPACT_LANES.items():
                full = [pool[kind][kinds[:i].count(kind)]
                        for i, kind in enumerate(kinds)]
                head = [x[:n] for x in full]
                variants = {
                    "bool keep": (head, keep_bool[:n]),
                    "uint8 keep": (head, keep_u8[:n]),
                    "keep[1:]": (head, keep_u8[1:]),
                    "lanes[1:]": ([x[1:] for x in full], keep_bool[:n]),
                    "last lane[1:]": (head[:-1] + [full[-1][1:]], keep_u8[:n]),
                }
                for variant, (lanes, keep) in variants.items():
                    got, ns = compact.compact_select(lanes, keep)
                    want, ns_p = compact.compact_select_plain(lanes, keep)
                    m = int(ns_p)
                    e = abs(int(ns) - m)
                    for g, w in zip(got, want):
                        if g.dtype != w.dtype or g.shape != w.shape:
                            raise AssertionError(f"B3 {name}: {g.dtype} {g.shape}")
                        if m:
                            diff = g[:m].long() - w[:m].long()
                            e = max(e, int(diff.abs().max()))
                    if e != 0:
                        raise AssertionError(
                            f"B3 n={n} lanes={name} keep={frac} {variant}: "
                            f"max err {e}")
                    err = max(err, e)
                    n_cases += 1
                if n != 1 << 24 or (name, frac) not in COMPACT_TIMED:
                    continue
                lanes, keep = head, keep_bool[:n]
                m = int(keep.sum())
                ms = time_ms(lambda: compact.compact_select(lanes, keep))
                plain = time_ms(
                    lambda: compact.compact_select_plain(lanes, keep), 3, 2)
                # The same function as one PyTorch call per lane.
                library = time_ms(lambda: [lane[keep] for lane in lanes])
                host = host_ms(torch, lambda: compact.compact_select(lanes, keep))
                width = sum(lane.element_size() for lane in lanes)
                n_bytes = n * (1 + width) + m * width
                ops = COMPACT_OPS_PER_ELEMENT + COMPACT_OPS_PER_LANE_ELEMENT * len(lanes)
                bound, by = bound_ms(n_bytes, n * ops)
                say(3, f"B3 compact n={n} lanes={name} keep={frac}: n_sel={m}; "
                       f"kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}: "
                       f"{n_bytes / n:.2f} B per element), "
                       f"{100 * bound / ms:.1f}% of bound, "
                       f"{n_bytes / ms / 1e9:.3f} TB/s; plain {plain:.4f} ms; "
                       f"lane[keep] per lane {library:.4f} ms; wrapper host "
                       f"time {host:.4f} ms per call")
                if (name, frac) == COMPACT_TIMED[0]:
                    main = (ms, plain, bound, by, library)
        say(3, f"B3 compact n={n}: equal to plain for lanes "
               f"{', '.join(COMPACT_LANES)}, keep fractions 0, 0.05, 0.5, 1, "
               f"with {', '.join(variants)}")
    say(3, f"B3 compact: equal to plain in all {n_cases} cases")
    return {"name": "B3 compact: compact_select", "route": "cuda",
            "source": "kmerset_tpu_torch/csrc/compact.cu",
            "replaces": "kmerset_tpu/ops/pallas_compact.py:118",
            "max_abs_err": err, "ms": main[0], "plain_ms": main[1],
            "bound_ms": main[2], "bound_by": main[3], "library_ms": main[4]}


def check_front_end(torch, rng) -> None:
    """The unitig front-end (torch ops around the join) on cuda equal to
    the same function on the CPU, on a ~2^20-k-mer set at k = 23: a guard
    that the shifts behave alike on both devices.  Times lookup_join at
    the front-end's query shape (8 queries per k-mer)."""
    from kmerset_tpu_torch.ops import backend, join, unitigs
    from kmerset_tpu_torch.ops import count as count_ops

    k = 23
    L = (1 << 20) + k - 1
    codes = rng.integers(0, 4, L, dtype=np.uint8)
    staged = backend.stage(codes, np.array([0, L]), k, "cuda")
    A, n, _ = count_ops.count_to_set_frag(*staged, k, True, 1)
    got = unitigs.unitig_succ(A, k)
    want = unitigs.unitig_succ(A.cpu(), k)
    torch.cuda.synchronize()
    for name, g, w in zip(("succ", "term_l", "term_r", "both"), got, want):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"front-end {name} differs between cuda and cpu")
    ms = time_ms(lambda: unitigs.unitig_succ(A, k), 5, 3)
    chains = int((got[0] >= 0).sum())
    say(4, f"front-end k={k} n={n}: unitig_succ on cuda equal to cpu "
           f"({chains} non-terminal exits); device {ms:.4f} ms")
    for m in (1 << 20, 1 << 24):
        S = torch.unique(torch.randint(0, 1 << 46, (m,), device="cuda"))
        Q = torch.cat([S[torch.randint(0, S.shape[0], (4 * m,), device="cuda")],
                       torch.randint(0, 1 << 46, (4 * m,), device="cuda")])
        found, idx = join.lookup_join(S, Q)
        hit = found[: 4 * m]
        if not bool(hit.all()) or not torch.equal(S[idx[: 4 * m]], Q[: 4 * m]):
            raise AssertionError(f"lookup_join n={m}: a member was not found")
        ms = time_ms(lambda: join.lookup_join(S, Q), 5, 3)
        say(4, f"lookup_join n={S.shape[0]} queries={Q.shape[0]} (half "
               f"members): {ms:.4f} ms")


def check_walk(torch, rng) -> dict:
    """Kernel W1 (csrc/walk.cu: the canonical unitig walk and emission)
    against its plain version on the card, stage by stage, at the
    assembly cell's shape: a genome of E. coli K-12's 4,641,652 bases as
    10 kb records, counted at k = 15, with its front-end's arrays.  Each
    stage is timed by CUDA events, beside the bytes bound of the whole
    walk, the plain version's time and the wrapper's wall (chain_walk and
    emit_strings with their downloads), and the longest chain.  Then
    core/spss.get_unitigs_canonical on the card with the device walk
    against the same call with the host walk, byte for byte, at k = 15
    and 23 on that genome, with the walk.device and walk.host counters."""
    from unittest import mock

    from kmerset_tpu_torch.core import spss
    from kmerset_tpu_torch.core.kmer_set import KmerSet
    from kmerset_tpu_torch.ops import backend, unitigs, walk
    from kmerset_tpu_torch.ops import count as count_ops
    from kmerset_tpu_torch.utils import trace

    n_bases = 4_641_652
    codes = rng.integers(0, 4, n_bases, dtype=np.uint8)
    offsets = np.append(np.arange(0, n_bases, 10_000), n_bases)
    row = {}
    for k in (15, 23):
        staged = backend.stage(codes, offsets, k, "cuda")
        A = count_ops.count_to_set_frag(*staged, k, True, 1)[0].to(torch.int64)
        succ, term_l, term_r, both = unitigs.unitig_succ(A, k)
        if k == 15:
            starts, n_right = walk.starts_of(term_l, term_r)
            bad, pbad = (torch.zeros(1, dtype=torch.int32, device="cuda")
                         for _ in range(2))
            ends, lens = walk.measure(succ, starts, bad)
            _same_as_plain(torch, "W1 measure", (ends, lens),
                           walk.measure_plain(succ, starts, pbad))
            ranked = walk.rank(A, starts, n_right, ends, lens, k, bad)
            plain = walk.rank_plain(A, starts, n_right, ends, lens, k, pbad)
            rec = ranked[0] >= 0
            _same_as_plain(torch, "W1 rank",
                           (*ranked[:1], ranked[1][rec], *ranked[2:]),
                           (*plain[:1], plain[1][rec], *plain[2:]))
            ch = walk.chain_walk(succ, term_l, term_r, A, k)
            em = walk.emit_strings(ch, succ, both, A, k)
            iso = torch.nonzero(both).squeeze(1)
            bufs = (torch.empty_like(em.codes), torch.empty_like(em.offsets),
                    torch.zeros_like(em.covered))
            walk.emit_plain(A, succ, k, ch, iso, *bufs, pbad)
            _same_as_plain(torch, "W1 emit", em[:3], bufs)
            if int(bad.item()) or int(pbad.item()):
                raise AssertionError("W1 flagged the front-end's own arrays")
            n = A.shape[0]
            stage_ms = (
                time_ms(lambda: walk.measure(succ, starts, bad), 5, 3),
                time_ms(lambda: walk.rank(A, starts, n_right, ends, lens, k, bad), 5, 3),
                time_ms(lambda: walk.emit(A, succ, k, ch, iso, *bufs, bad), 5, 3))
            wall = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                walk.emit_strings(walk.chain_walk(succ, term_l, term_r, A, k),
                                  succ, both, A, k)
                wall.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ends_p, lens_p = walk.measure_plain(succ, starts, pbad)
            walk.rank_plain(A, starts, n_right, ends_p, lens_p, k, pbad)
            walk.emit_plain(A, succ, k, ch, iso, *bufs, pbad)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            n_bytes = (succ.nbytes + A.nbytes + starts.nbytes + em.codes.nbytes
                       + em.offsets.nbytes + em.covered.nbytes)
            bound = bound_ms(n_bytes, 0)
            longest = int(lens.max())
            say("4w", f"W1 walk k={k}: {n} k-mers, {starts.shape[0]} starts, "
                      f"{ch.n_chains} chains, {iso.shape[0]} isolated, "
                      f"{em.codes.shape[0]} code bytes, longest chain {longest} "
                      f"nodes; measure, rank, emit equal to plain")
            say("4w", f"W1 device ms: measure {stage_ms[0]:.4f}, rank "
                      f"{stage_ms[1]:.4f}, emit {stage_ms[2]:.4f} (sum "
                      f"{sum(stage_ms):.4f}); {stage_ms[0] / longest * 1e6:.1f} ns "
                      f"a step of the longest chain; wrapper wall median "
                      f"{statistics.median(wall):.4f} ms; bytes bound "
                      f"{bound[0]:.4f} ms ({n_bytes} B); plain {plain_ms:.1f} ms")
            row = {"name": "W1 walk: chain_walk, emit_strings", "route": "cuda",
                   "source": "kmerset_tpu_torch/csrc/walk.cu",
                   "replaces": "native/kmerio.c kmerio_chain_pairs, "
                               "kmerio_chain_emit, kmerio_emit_kmer_chains "
                               "(no Pallas kernel)",
                   "max_abs_err": 0, "ms": sum(stage_ms), "plain_ms": plain_ms,
                   "bound_ms": bound[0], "bound_by": "latency of the longest "
                   f"chain ({longest} nodes)", "library_ms": None,
                   "wall_ms": statistics.median(wall)}
        ks = KmerSet(k, A.cpu().numpy(), _sorted=True)
        before = dict(trace.counts())
        got = spss.get_unitigs_canonical(ks, device="cuda")
        with mock.patch.object(backend, "WALK_MIN_KMERS", 1 << 62):
            want = spss.get_unitigs_canonical(ks, device="cuda")
        moved = {c: trace.counts().get(c, 0) - before.get(c, 0)
                 for c in ("walk.device", "walk.host", "launch.W1")}
        if moved != {"walk.device": 1, "walk.host": 1, "launch.W1": 3}:
            raise AssertionError(f"W1 k={k}: routes {moved}")
        if not (np.array_equal(got.codes, want.codes)
                and np.array_equal(got.offsets, want.offsets)):
            raise AssertionError(f"W1 k={k}: the device walk's unitigs differ "
                                 "from the host walk's")
        say("4w", f"get_unitigs_canonical k={k}: {len(got)} unitigs, device "
                  "walk byte-identical to the host walk")
    return row


def check_overlap(torch, rng) -> dict:
    """Kernel J1 (csrc/overlap.cu: the path cover's candidate overlap
    edges) against its plain version and the host's native join and dedup
    on the card, at the assembly cell's shape: the canonical unitigs of a
    genome of E. coli K-12's 4,641,652 bases as 10 kb records at k = 15.
    Its two launches are timed by CUDA events, beside the bytes bound (the
    unitigs' ends read once, the kept int32 ports written once), the
    wrapper's wall (the sorts, the scan and the count's download), the
    whole route's wall in the path cover (the ends' upload and the kept
    edges' download too), the plain version's time and the host join's
    and dedup's, which J1 replaces."""
    from kmerset_tpu_torch.core import native, spss
    from kmerset_tpu_torch.core.kmer_set import KmerSet
    from kmerset_tpu_torch.ops import backend, overlap
    from kmerset_tpu_torch.ops import count as count_ops
    from kmerset_tpu_torch.utils import trace

    k = 15
    n_bases = 4_641_652
    codes = rng.integers(0, 4, n_bases, dtype=np.uint8)
    offsets = np.append(np.arange(0, n_bases, 10_000), n_bases)
    staged = backend.stage(codes, offsets, k, "cuda")
    A = count_ops.count_to_set_frag(*staged, k, True, 1)[0].cpu().numpy()
    unitigs = spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device="cuda")
    P, S = unitigs.first_kmers(k), unitigs.last_kmers(k)
    n = P.shape[0]
    t0 = time.perf_counter()
    raw = native.overlap_edges(P, S, k)
    want = spss._dedup_port_edges(*raw, n)
    join_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    Pc, Sc = torch.from_numpy(P).cuda(), torch.from_numpy(S).cuda()
    before = trace.counts().get("launch.J1", 0)
    got = overlap.edges(Pc, Sc, k)
    torch.cuda.synchronize()
    per_unitig = (torch.cuda.max_memory_allocated() - base - got.nbytes) / n
    if trace.counts().get("launch.J1", 0) - before != 2:
        raise AssertionError("J1: not two launches a call")
    t0 = time.perf_counter()
    plain = overlap.edges_plain(torch.from_numpy(P), torch.from_numpy(S), k)
    plain_ms = (time.perf_counter() - t0) * 1e3
    _same_as_plain(torch, "J1 edges", (got.cpu(),), (plain,))
    if not all(np.array_equal(g, w) for g, w in zip(got.cpu().numpy(), want)):
        raise AssertionError("J1: the edges differ from the native join's")
    m = got.shape[1]

    lib = overlap._lib()[0]
    p_keys, p_ord = torch.sort(Pc, stable=True)
    s_keys, s_ord = torch.sort(Sc, stable=True)
    tables = (p_keys.data_ptr(), p_ord.data_ptr(), s_keys.data_ptr(),
              s_ord.data_ptr())
    ends = torch.empty(overlap.PASSES * n, dtype=torch.int64, device="cuda")
    out = torch.empty(2 * m, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    count_ms = time_ms(lambda: lib.kmerset_overlap_count(
        Pc.data_ptr(), Sc.data_ptr(), n, k, *tables, ends.data_ptr(), stream), 5, 5)
    ends.cumsum_(0)
    fill_ms = time_ms(lambda: lib.kmerset_overlap_fill(
        Pc.data_ptr(), Sc.data_ptr(), n, k, *tables, ends.data_ptr(), m,
        out.data_ptr(), stream), 5, 5)
    if not torch.equal(out.view(2, m), got):
        raise AssertionError("J1: the timed fill differs")
    wall, route = [], []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        overlap.edges(Pc, Sc, k)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        spss._device_edges(P, S, k, "cuda")
        route.append((time.perf_counter() - t0) * 1e3)
    n_bytes = P.nbytes + S.nbytes + out.nbytes
    bound = bound_ms(n_bytes, 0)
    say("4j", f"J1 edges k={k}: {n} unitigs, {raw[0].shape[0]} raw and {m} "
              "kept edges; equal to the plain version and the native join")
    say("4j", f"J1 device ms: count {count_ms:.4f}, fill {fill_ms:.4f} (sum "
              f"{count_ms + fill_ms:.4f}); wrapper wall median "
              f"{statistics.median(wall):.4f} ms; route wall median "
              f"{statistics.median(route):.4f} ms; bytes bound {bound[0]:.5f} ms "
              f"({n_bytes} B); plain {plain_ms:.1f} ms; host join and dedup "
              f"{join_ms:.1f} ms; peak {per_unitig:.2f} B a unitig beside the "
              f"edges (EDGES_BYTES_PER_UNITIG {backend.EDGES_BYTES_PER_UNITIG})")
    if per_unitig > backend.EDGES_BYTES_PER_UNITIG:
        raise AssertionError("J1: its peak exceeds EDGES_BYTES_PER_UNITIG")
    return {"name": "J1 edges: overlap.edges", "route": "cuda",
            "source": "kmerset_tpu_torch/csrc/overlap.cu",
            "replaces": "native/kmerio.c kmerio_overlap_edges_fp, "
                        "kmerio_overlap_edges_part, kmerio_dedup_edges "
                        "(no Pallas kernel)",
            "max_abs_err": 0, "ms": count_ms + fill_ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": "launches and the binary "
            "searches' dependent loads", "library_ms": None,
            "host_ms": join_ms, "wall_ms": statistics.median(wall),
            "route_ms": statistics.median(route)}


# The benchmark's cells whose FASTA phase 4p parses: (configuration, mix,
# k, cutoff) of kmerbench/configs and kmerbench/mixes.
PARSE_SHAPES = (("ecoli-k15", "reads", 15, 4), ("chr1-k23", "assembly", 23, 1),
                ("dmel-k19", "reads10x", 19, 2))


def _parse_fuzz(rng) -> bytes:
    """A FASTA text of up to ~240 KB (up to 15 of P1's 16 KB tiles):
    records of 0-600 bases with N runs, now and then without its last
    newline, with a header more (an odd line count) or with one byte
    replaced by a newline, '>', a carriage return, lower case or N."""
    out = bytearray()
    for i in range(int(rng.integers(0, 400))):
        seq = _BASES[rng.integers(0, 4, int(rng.integers(0, 600)))].copy()
        seq[rng.random(seq.shape[0]) < 0.02] = ord("N")
        out += b">r%d\n" % i + seq.tobytes() + b"\n"
    if out and rng.random() < 0.3:
        out = out[:-1]
    if rng.random() < 0.1:
        out += b">odd\n"
    if out and rng.random() < 0.3:
        out[int(rng.integers(0, len(out)))] = int(rng.choice(
            np.frombuffer(b"\n>\raN", np.uint8)))
    return bytes(out)


def _parse_outcome(torch, fn):
    """(packed codes, offsets, None) on the host of a parse, or (None,
    None, its message)."""
    from kmerset_tpu_torch.ops import parse

    try:
        codes, offsets = fn()
    except ValueError as e:
        return None, None, str(e)
    codes = torch.as_tensor(codes)
    return (parse.pack_plain(codes.cpu()).numpy(),
            torch.as_tensor(offsets).cpu().numpy(), None)


def check_parse(torch, rng) -> dict:
    """Kernel P1 (csrc/parse.cu: the FASTA parse and 2-bit pack of the
    count) on the card: on 400 fuzzed texts against its plain version on
    the card and the host's native parse and pack (codes, offsets, error
    messages); at the FASTA of the benchmark's reads, chr1 and dmel cells
    against its plain version, with its two kernels timed by CUDA events
    beside the bytes bound (the text read once, the codes and fragment
    ends written once; the codes read once and packed), the plain
    version's time, the device route's wall (the pinned read and upload,
    P1, its download) and the host parse and pack it replaces; then
    kmerset-build of the reads cell's input on the device route and on the
    host route: launch.P1 and parse.device once on the first, parse.host
    once on the second, the dumps byte-identical."""
    from unittest import mock

    from kmerbench import generate
    from kmerset_tpu_torch.cli import kmerset_build
    from kmerset_tpu_torch.core import io as core_io
    from kmerset_tpu_torch.core import native
    from kmerset_tpu_torch.ops import backend, parse
    from kmerset_tpu_torch.utils import trace

    for i in range(400):
        data = _parse_fuzz(rng)
        buf = torch.tensor(np.frombuffer(data, np.uint8)).cuda()
        got = _parse_outcome(torch, lambda: parse.parse(buf))
        plain = _parse_outcome(torch, lambda: parse.parse_plain(buf))
        host = _parse_outcome(torch, lambda: native.parse_fasta_bytes(data))
        for other, what in ((plain, "its plain version"), (host, "the host's")):
            if got[2] != other[2] or (got[2] is None and not all(
                    np.array_equal(g, w) for g, w in zip(got[:2], other[:2]))):
                raise AssertionError(f"P1 fuzz case {i} ({len(data)} B): "
                                     f"differs from {what} ({got[2]!r}, "
                                     f"{other[2]!r})")
    say("4p", "P1 on 400 fuzzed texts: packed codes, offsets and errors equal "
              "to its plain version's and the host's")
    lib = parse._lib()[0]
    stream = torch.cuda.current_stream().cuda_stream
    row = None
    for config, mix, k, cutoff in PARSE_SHAPES:
        work = os.path.join(WORK, f"parse_{config}.{mix}")
        os.makedirs(work, exist_ok=True)

        def load(name):
            with open(os.path.join(ROOT, "kmerbench", name)) as f:
                return json.load(f)

        (fasta,), _ = generate.write_fastas(load(f"configs/{config}.json"),
                                            load(f"mixes/{mix}.json"), SEED, work)
        buf = backend.upload_file(fasta, "cuda")
        n = buf.shape[0]
        codes, offsets = parse.parse(buf)
        t0 = time.perf_counter()
        plain = parse.parse_plain(buf)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        _same_as_plain(torch, f"P1 parse {config}.{mix}", (codes, offsets), plain)
        del plain
        packed = parse.pack(codes)
        odd = codes[12_345:]
        _same_as_plain(torch, f"P1 pack {config}.{mix}",
                       (packed, parse.pack(odd)),
                       (parse.pack_plain(codes), parse.pack_plain(odd)))
        total, n_frag = codes.shape[0], offsets.shape[0] - 1
        tiles = -(-n // parse.TILE)
        out = torch.empty(n, dtype=torch.uint8, device="cuda")
        ends = torch.empty(1 + (n + 1) // 2, dtype=torch.int64, device="cuda")
        scratch = torch.empty(1 + 3 * tiles, dtype=torch.int64, device="cuda")
        info = torch.empty(4, dtype=torch.int64, device="cuda")
        parse_ms = time_ms(lambda: lib.kmerset_parse_fasta(
            buf.data_ptr(), n, out.data_ptr(), ends.data_ptr(),
            scratch.data_ptr(), scratch.shape[0], info.data_ptr(), stream), 5, 3)
        pack_ms = time_ms(lambda: lib.kmerset_pack_codes(
            codes.data_ptr(), total, packed.data_ptr(), stream), 5, 3)
        if not (torch.equal(out[:total], codes)
                and torch.equal(ends[: n_frag + 1], offsets)):
            raise AssertionError(f"P1 {config}.{mix}: the timed parse differs")
        del buf, out, ends, scratch, info, codes, offsets, packed, odd
        route = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            parse.parse(backend.upload_file(fasta, "cuda"))
            torch.cuda.synchronize()
            route.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        host = native.parse_fasta_bytes(core_io.read_file_bytes(fasta))
        native.pack2(host[0])
        host_ms = (time.perf_counter() - t0) * 1e3
        del host
        parse_bytes = n + total + 8 * (n_frag + 1)
        pack_bytes = total + (total + 3) // 4
        bound = bound_ms(parse_bytes + pack_bytes, 0)[0]
        say("4p", f"P1 {config}.{mix}: {n} B, {total} codes, {n_frag} fragments; "
                  f"equal to its plain version; device ms: parse {parse_ms:.4f} "
                  f"(bound {bound_ms(parse_bytes, 0)[0]:.4f}), pack {pack_ms:.4f} "
                  f"(bound {bound_ms(pack_bytes, 0)[0]:.4f}), sum "
                  f"{parse_ms + pack_ms:.4f} against {bound:.4f} "
                  f"({100 * bound / (parse_ms + pack_ms):.1f}% of the bytes "
                  f"bound); plain {plain_ms:.1f} ms; route wall (read, upload, "
                  f"P1, totals) median {statistics.median(route):.1f} ms; host "
                  f"read, parse and pack {host_ms:.1f} ms")
        row = {"name": "P1 parse: parse.parse, parse.pack", "route": "cuda",
               "source": "kmerset_tpu_torch/csrc/parse.cu",
               "replaces": "native/kmerio.c kmerio_parse_fasta, kmerio_pack2 "
                           "(no Pallas kernel)",
               "max_abs_err": 0, "ms": parse_ms + pack_ms, "plain_ms": plain_ms,
               "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
               "host_ms": host_ms, "route_ms": statistics.median(route),
               "shape": f"{config}.{mix}"}
        if config != "ecoli-k15":
            continue

        def build(name: str) -> Tuple[bytes, dict]:
            out_path = os.path.join(work, name)
            before = dict(trace.counts())
            kmerset_build.main(["--device", "cuda", "--k", str(k), "--cutoff",
                                str(cutoff), "--out", out_path, fasta])
            moved = {c: trace.counts().get(c, 0) - before.get(c, 0)
                     for c in ("launch.P1", "launch.P1.pack", "parse.device",
                               "parse.host")}
            with open(out_path, "rb") as f:
                return f.read(), moved

        got, moved = build("device.txt")
        if moved != {"launch.P1": 1, "launch.P1.pack": 1, "parse.device": 1,
                     "parse.host": 0}:
            raise AssertionError(f"P1 build {config}.{mix}: device route {moved}")
        with mock.patch.object(backend, "parse_route", lambda *a: False):
            want, moved = build("host.txt")
        if moved != {"launch.P1": 0, "launch.P1.pack": 0, "parse.device": 0,
                     "parse.host": 1}:
            raise AssertionError(f"P1 build {config}.{mix}: host route {moved}")
        if got != want:
            raise AssertionError(f"P1 build {config}.{mix}: the dumps differ")
        say("4p", f"kmerset-build {config}.{mix} --k {k} --cutoff {cutoff}: the "
                  f"device route's dump ({len(got)} B) byte-identical to the "
                  "host route's; launch.P1 1, parse.device 1 on the first")
    return row


def _same_as_plain(torch, what: str, got, want) -> None:
    for i, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError(f"{what}: output {i} differs from the plain version")


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


def _launch_counts() -> dict:
    """The process's launches of each kernel of KERNELS so far (the
    tracer's counters launch.B1, launch.B2, launch.B3 and launch.W1) and
    its sets walked each way (walk.device, walk.host), and of those on
    the card the ones from the bounded front-end (walk.bounded)."""
    from kmerset_tpu_torch.utils import trace

    c = trace.counts()
    return {n: c.get(n if "." in n else f"launch.{n}", 0) for n in COUNTED}


def _spy_walk_routes() -> None:
    """ops/backend.walk_route, recording each answer in _ROUTES."""
    from kmerset_tpu_torch.ops import backend

    real = backend.walk_route

    def spy(n, device):
        card = real(n, device)
        _ROUTES.append((n, card))
        return card

    backend.walk_route = spy


def _check_walks(tag: str, moved: dict, since: int, host: int = 0) -> int:
    """The canonical builds' walks of a run that started when _ROUTES held
    `since` answers and counted `moved` (_launches_since): walk.device
    must be the sets walk_route sent to the card, and walk.host those it
    kept on the host plus `host` sets built on a route that never asks it
    (a mesh, the slow link).  Each set it kept is below WALK_MIN_KMERS:
    the walk's own ceiling (backend.walk_ceiling) lies far above every
    set here.  So a set that W1 refused, or that took the host walk on
    the card's route, fails the run.  Returns the sets walked on the
    card."""
    from kmerset_tpu_torch.ops import backend

    routes = _ROUTES[since:]
    card = sum(1 for _, c in routes if c)
    large = [n for n, c in routes if not c and n >= backend.WALK_MIN_KMERS]
    want = {"walk.device": card, "walk.host": len(routes) - card + host}
    got = {w: moved[w] for w in WALKS}
    if got != want or large:
        raise AssertionError(f"{tag}: sets walked {got}, routes {want} with "
                             f"{len(large)} of at least WALK_MIN_KMERS k-mers "
                             "on the host")
    return card


def _launches_since(before: dict) -> dict:
    """The launches of each kernel since _launch_counts() gave `before`."""
    now = _launch_counts()
    return {n: now[n] - before[n] for n in now}


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append((record.created, record.getMessage()))


_LOGGED = ("cutoff_count", "kmer_set.Size()", "kmer_set.Hash()",
           "kmer_set_compact.Size()")
# Debug lines of the port's SPSS build (core/spss.py, through its
# _phase: "name: 1.23s"; ops/unitigs.py: the front-end's upload, device
# and download).
_PHASES = ("unitigs: device front-end", "unitigs: chain walk",
           "unitigs: emission + cycles", "spss: path cover")
_FRONT_END_IO = re.compile(
    r"unitigs: device [a-z -]+ upload ([\d.]+) s, device ([\d.]+) s, "
    r"download ([\d.]+) s"
)


def _logged_values(lines) -> dict:
    out = {}
    for line in lines:
        for key in _LOGGED:
            m = re.search(re.escape(key) + r" = (\d+)", line)
            if m:
                out[key] = int(m.group(1))
    return out


def _phase_times(lines) -> dict:
    out = {}
    for line in lines:
        for name in _PHASES:
            m = re.fullmatch(re.escape(name) + r": ([\d.]+)s", line)
            if m:
                out[name] = float(m.group(1))
        m = _FRONT_END_IO.search(line)
        if m:
            out.update(zip(("front-end upload", "front-end device",
                            "front-end download"), map(float, m.groups())))
    return out


class RefCli:
    """One reference CLI (`python -m kmerset_tpu.cli.<cli> ARGS`) pinned
    to its host path, in a subprocess that runs beside the port's runs,
    from `cwd` (phase 0 sets it: see reference_tree)."""

    cwd = ROOT

    def __init__(self, tag: str, cli: str, args):
        self._start(tag, ["-m", f"kmerset_tpu.cli.{cli}", *args])

    def _start(self, tag: str, argv) -> None:
        self.out_log = open(os.path.join(WORK, f"{tag}_ref.out"), "w+")
        self.err = open(os.path.join(WORK, f"{tag}_ref.log"), "w+")
        env = dict(os.environ, KMERSET_TPU_FORCE_BACKEND="host",
                   JAX_PLATFORMS="cpu")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, *argv],
            stdout=self.out_log, stderr=self.err, env=env, cwd=self.cwd,
        )

    def wait_output(self, timeout: float) -> Tuple[str, str, float]:
        """(stdout, stderr, wall s) once it exits; raises if it failed."""
        rc = self.proc.wait(timeout=timeout)
        secs = time.perf_counter() - self.t0
        out = []
        for f in (self.out_log, self.err):
            f.seek(0)
            out.append(f.read())
            f.close()
        if rc != 0:
            raise RuntimeError(f"reference CLI failed:\n{out[1][-4000:]}")
        return out[0], out[1], secs

    def wait(self, timeout: float) -> Tuple[str, float]:
        """(stderr, wall s) once it exits; raises if it failed."""
        _, stderr, secs = self.wait_output(timeout)
        return stderr, secs

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


class RefRun(RefCli):
    """The reference CLI's host build of one input."""

    def __init__(self, tag: str, fasta: str, k: int, cutoff: int, extra=()):
        self.out = os.path.join(WORK, f"{tag}_ref.txt")
        super().__init__(tag, "kmerset_build", [
            "--k", str(k), "--cutoff", str(cutoff), *extra, "--check",
            "--out", self.out, fasta,
        ])


class RefDone:
    """A RefRun that has ended: its dump, log and wall, read again for
    another port run of the same input (the mesh runs)."""

    def __init__(self, ref: RefRun, secs: float):
        self.out, self.log, self.secs = ref.out, ref.err.name, secs

    def wait(self, timeout: float) -> Tuple[str, float]:
        with open(self.log) as f:
            return f.read(), self.secs

    def kill(self) -> None:
        pass


# Debug lines of the mesh's steps (parallel/driver.py): "mesh: NAME on N
# shards: S s".
_MESH_STEP = re.compile(r"mesh: (.+) on (\d+) shards: ([\d.]+) s")


def _mesh_steps(lines) -> dict:
    """Seconds per mesh step name, summed over the lines."""
    out = {}
    for line in lines:
        m = _MESH_STEP.fullmatch(line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + float(m.group(3))
    return out


def main_path_run(torch, tag: str, fasta: str, k: int, cutoff: int,
                  ref, kernels: Tuple[str, ...], device: str = "cuda",
                  extra=(), link=None) -> dict:
    """Port CLI in-process on `device` (one device, or a comma-separated
    list: a mesh of those shards) against the reference CLI's host build
    (`ref`); `kernels` are the launch counters this path must raise, and
    `extra` more CLI flags; `link` sets KMERSET_TPU_LINK for the run
    (slow: the link formats, whose canonical front-end is the side-code
    route).  Returns the launch counts, the port's phase times, its peak
    device memory and its log lines."""
    from kmerset_tpu_torch.cli import kmerset_build

    on_mesh = "," in device
    out_port = os.path.join(WORK, f"{tag}_port.txt")
    cap = _Capture()
    log = logging.getLogger(CLI_LOGGER)
    log.addHandler(cap)
    launches0, routes0 = _launch_counts(), len(_ROUTES)
    torch.cuda.reset_peak_memory_stats()
    if link is not None:
        os.environ["KMERSET_TPU_LINK"] = link
    t0 = time.time()
    try:
        kmerset_build.main([
            "--device", device, "--k", str(k), "--cutoff", str(cutoff),
            *extra, "--check", "--out", out_port, fasta,
        ])
    finally:
        log.removeHandler(cap)
        os.environ.pop("KMERSET_TPU_LINK", None)
    t_end = time.time()
    peak_gib = torch.cuda.max_memory_allocated() / (1 << 30)
    launches = _launches_since(launches0)
    ref_err, ref_s = ref.wait(timeout=900)

    msgs = [m for _, m in cap.records]
    at = {m: t for t, m in cap.records}
    if "kmer_set_compact -> KmerSet: ok" not in msgs:
        raise AssertionError(f"{tag}: the port's --check did not log ok")
    if "kmer_set_compact -> KmerSet: ok" not in ref_err:
        raise AssertionError(f"{tag}: the reference's --check did not log ok")
    mine, theirs = _logged_values(msgs), _logged_values(ref_err.splitlines())
    if mine != theirs or len(mine) != len(_LOGGED):
        raise AssertionError(f"{tag}: logged values differ: {mine} vs {theirs}")
    if not filecmp.cmp(out_port, ref.out, shallow=False):
        raise AssertionError(f"{tag}: dump differs from the reference's")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched")
    spss = _phase_times(msgs)
    steps = _mesh_steps(msgs)
    canonical = "--canonical=false" not in extra
    side_route = link == "slow" and canonical
    # One canonical set: on one device and the fast link walked by W1,
    # else by the host; the directed build counts no walk.
    on_card = canonical and not on_mesh and not side_route
    if _check_walks(tag, launches, routes0,
                    host=int(canonical and not on_card)) != int(on_card):
        raise AssertionError(f"{tag}: the canonical build did not walk on the "
                             "card (kernel W1)")
    if len(spss) != len(_PHASES) + (0 if on_mesh or side_route else 3):
        raise AssertionError(f"{tag}: the device front-end did not run: {spss}")
    if on_mesh:
        front = "front-end" if "--canonical=false" not in extra else "side tables"
        need = {"count", "decode", front, "pointer doubling",
                "chain grouping and emission"}
        if not need <= set(steps):
            raise AssertionError(f"{tag}: mesh steps {steps}, need {need}")
    times = {
        "count_s": at["constructed kmer_counter"] - at["constructing kmer_counter"],
        "spss_s": at["constructed kmer_set_compact"]
        - at["constructing kmer_set_compact"],
        "check_s": at["kmer_set_compact -> KmerSet: ok"]
        - at["constructed kmer_set_compact"],
        "total_s": t_end - t0,
        "reference_host_total_s": ref_s,
    }
    host = sum(spss[p] for p in _PHASES[1:])
    say(tag, f"--device {device} --k {k} --cutoff {cutoff} {' '.join(extra)} "
             f"--check: dump byte-identical to the "
             f"reference host CLI ({os.path.getsize(out_port)} bytes); "
             f"size {mine['kmer_set.Size()']}, hash {mine['kmer_set.Hash()']}, "
             f"cutoff_count {mine['cutoff_count']}; check ok; "
             f"launches {launches}; peak device memory {peak_gib:.3f} GiB")
    say(tag, "wall s: " + ", ".join(f"{n} {v:.3f}" for n, v in times.items()))
    if on_mesh:
        say(tag, f"SPSS split, s: mesh front-end {spss[_PHASES[0]]:.2f}; walk "
                 f"+ emission + path cover {host:.2f} [" + ", ".join(
                     f"{p} {spss[p]:.2f}" for p in _PHASES[1:]) + "]; mesh "
                 "steps: " + ", ".join(f"{n} {v:.4f}" for n, v in steps.items()))
    elif side_route:
        say(tag, f"SPSS split, s: side-code front-end (succ rebuilt on the "
                 f"host) {spss[_PHASES[0]]:.2f}; host walk + emission + path "
                 f"cover {host:.2f} [" + ", ".join(
                     f"{p} {spss[p]:.2f}" for p in _PHASES[1:]) + "]")
    else:
        say(tag, f"SPSS split, s: device front-end (succ on the host) "
                 f"{spss[_PHASES[0]]:.2f} [upload {spss['front-end upload']:.4f}, "
                 f"device {spss['front-end device']:.4f}, download "
                 f"{spss['front-end download']:.4f}]; host walk + emission + "
                 f"path cover {host:.2f} [" + ", ".join(
                     f"{p} {spss[p]:.2f}" for p in _PHASES[1:]) + "]")
    return {"launches": launches, "size": mine["kmer_set.Size()"],
            "steps": steps, "peak_gib": peak_gib, "lines": msgs, **times}


_LUT = np.full(256, 255, dtype=np.uint8)
_LUT[np.frombuffer(b"ACGT", dtype=np.uint8)] = np.arange(4, dtype=np.uint8)


def _sequence_lines(path: str) -> list:
    """The sequence lines of this script's own FASTA files and dumps (one
    sequence line per record here)."""
    with open(path, "rb") as f:
        return [l for l in f.read().split(b"\n") if l and l[:1] != b">"]


def fasta_codes(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(codes uint8, fragment offsets int64) of this script's own FASTA
    files and dumps: every sequence line is split at each base other than
    ACGT, as the FASTA parser does."""
    return _codes_of_lines(_sequence_lines(path))


def _codes_of_lines(lines) -> Tuple[np.ndarray, np.ndarray]:
    arr = _LUT[np.frombuffer(b"N".join(lines), dtype=np.uint8)]
    valid = arr != 255
    cum = np.cumsum(valid)
    offsets = np.unique(np.concatenate(
        [[0], cum[np.flatnonzero(~valid)], [cum[-1]]]
    )).astype(np.int64)
    return arr[valid], offsets


def _peak_bytes(torch, fn):
    """(fn(), peak bytes allocated above what was allocated before it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_out_of_core(torch, fasta_a: str, dump_c: str, sizes: dict) -> dict:
    """The chunked count (run A's genome at k = 15, 23 and 31) and decode
    (run C's dump) at a forced 2^22-window chunk, and the front-end on run
    C's set at query_chunk = 2^22 and in its bounded mode at a forced
    small budget, each equal to its one-shot result; the peak bytes per
    window, per queried k-mer and per k-mer held against the constants
    that size the memory ceilings; and the front-end's two modes timed on
    run C's and run E's sets (front_end_modes).  Returns the sets of runs
    A, C and E, by tag."""
    from kmerset_tpu_torch.ops import backend, neighbors, unitigs

    chunk = 1 << 22
    codes, offsets = fasta_codes(fasta_a)
    sets = {}
    for k, tag in ((15, "run A"), (23, "run C"), (31, "run E")):
        n_windows = codes.size - k + 1
        one, peak = _peak_bytes(torch, lambda: backend.device_count(
            codes, offsets, k, True, device=DEVICE))
        _, one_s = _timed(torch, lambda: backend.device_count(
            codes, offsets, k, True, device=DEVICE))
        got, ch_s = _timed(torch, lambda: backend.device_count_chunked(
            codes, offsets, k, True, device=DEVICE, chunk_windows=chunk))
        for g, w, name in zip(got, one, ("keys", "counts")):
            if not np.array_equal(g, w):
                raise AssertionError(f"chunked count k={k}: {name} differ")
        if one[0].size != sizes[k]:
            raise AssertionError(f"k={k}: {one[0].size} k-mers, {tag} "
                                 f"logged {sizes[k]}")
        sets[tag] = one[0]
        per = peak / n_windows
        say(9, f"count k={k}, {n_windows} windows: chunked "
               f"({-(-n_windows // chunk)} chunks of 2^22) equal to one-shot "
               f"({one[0].size} keys = {tag}'s size); one-shot {one_s:.4f} s, "
               f"chunked {ch_s:.4f} s; peak {per:.2f} B/window "
               f"(ceiling uses {backend.count_bytes_per_window(k)})")
        if per > backend.count_bytes_per_window(k):
            raise AssertionError(f"k={k}: {per:.2f} B/window above the "
                                 "ceiling's constant")
    k = 23
    codes, offsets = fasta_codes(dump_c)
    one, one_s = _timed(torch, lambda: backend.device_unique(
        codes, offsets, k, True, device=DEVICE))
    got, ch_s = _timed(torch, lambda: backend.device_unique_chunked(
        codes, offsets, k, True, device=DEVICE, chunk_windows=chunk))
    n_windows = codes.size - k + 1
    if not np.array_equal(got, one) or one.size != sizes[k]:
        raise AssertionError("chunked decode of run C's dump differs")
    say(9, f"decode k={k}, run C's dump, {n_windows} windows: chunked "
           f"({-(-n_windows // chunk)} chunks) equal to one-shot ({one.size} "
           f"k-mers); one-shot {one_s:.4f} s, chunked {ch_s:.4f} s")
    A = one
    whole, one_s = _timed(torch, lambda: unitigs.device_unitig_succ(
        A, k, device=DEVICE, query_chunk=A.size))
    got, ch_s = _timed(torch, lambda: unitigs.device_unitig_succ(
        A, k, device=DEVICE, query_chunk=chunk))
    for name, g, w in zip(("succ", "term_l", "term_r", "both"), got, whole):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"front-end in query chunks: {name} differs")
    At = torch.from_numpy(A).to(DEVICE)
    _, peak = _peak_bytes(torch, lambda: neighbors.side_tables(
        At, k, True, 0, chunk))
    del At
    per = peak / chunk
    say(9, f"front-end k={k}, {A.size} k-mers: query_chunk 2^22 "
           f"({-(-A.size // chunk)} chunks) bit for bit equal to one shot; "
           f"one shot {one_s:.4f} s, chunked {ch_s:.4f} s (upload and "
           f"download included); side-table chunk peak {per:.2f} B/k-mer "
           f"(ceiling uses {backend.FRONT_END_BYTES_PER_QUERY})")
    if per > backend.FRONT_END_BYTES_PER_QUERY:
        raise AssertionError(f"front-end: {per:.2f} B/k-mer above the "
                             "ceiling's constant")
    # The whole-set arrays of each mode, beside small query chunks whose
    # share (at FRONT_END_BYTES_PER_QUERY) is taken off the peak.
    q = 1 << 18
    n = A.size
    one, one_peak = _peak_bytes(torch, lambda: unitigs.device_unitig_succ(
        A, k, device=DEVICE, query_chunk=q))
    small = backend.FRONT_END_BYTES_PER_KMER * (n // 4)
    if not backend.front_end_plan(n, small)[0]:
        raise AssertionError("the forced budget does not plan the bounded mode")
    bounded = []
    spy = unitigs.bounded_unitig_succ
    unitigs.bounded_unitig_succ = lambda *a: bounded.append(1) or spy(*a)
    budget_of = backend.memory_budget
    backend.memory_budget = lambda device: small
    try:
        (got, b_s), b_peak = _peak_bytes(torch, lambda: _timed(
            torch, lambda: unitigs.device_unitig_succ(
                A, k, device=DEVICE, query_chunk=q)))
    finally:
        backend.memory_budget = budget_of
        unitigs.bounded_unitig_succ = spy
    if bounded != [1]:
        raise AssertionError("the forced budget did not run the bounded mode")
    for name, g, w in zip(("succ", "term_l", "term_r", "both"), got, whole):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"front-end in its bounded mode: {name} differs")
    for g, w in zip(one, whole):
        if not np.array_equal(g, w):
            raise AssertionError("front-end at query_chunk 2^18 differs")
    q_part = min(q, n) * backend.FRONT_END_BYTES_PER_QUERY
    one_set = (one_peak - q_part) / n
    b_set = (b_peak - q_part) / n
    say(9, f"front-end k={k}, {n} k-mers, query_chunk 2^18: one-shot mode "
           f"peak {one_peak / n:.2f} B/k-mer, whole-set arrays "
           f"{one_set:.2f} B/k-mer past the chunk's "
           f"{backend.FRONT_END_BYTES_PER_QUERY} B/query (ceiling uses "
           f"{backend.FRONT_END_BYTES_PER_KMER}); bounded mode at a budget of "
           f"{small} B ({-(-n // q)} chunks, two passes) bit for bit equal to "
           f"one shot in {b_s:.4f} s, peak {b_peak / n:.2f} B/k-mer, whole-set "
           f"arrays {b_set:.2f} B/k-mer")
    if one_set > backend.FRONT_END_BYTES_PER_KMER:
        raise AssertionError(f"front-end: {one_set:.2f} B/k-mer of whole-set "
                             "arrays above the ceiling's constant")
    if b_set > backend.BOUNDED_BYTES_PER_KMER:
        raise AssertionError(f"front-end: {b_set:.2f} B/k-mer of the bounded "
                             "mode's whole-set arrays above its constant")
    walk_bytes(torch, A, k)
    for tag, k in (("run C", 23), ("run E", 31)):
        front_end_modes(torch, sets[tag], k, tag)
    free, total = torch.cuda.mem_get_info()
    budget = backend.memory_budget(DEVICE)
    ceiling = backend.front_end_ceiling(budget)
    say(9, f"ceiling: mem_get_info free {free} of {total} B, budget "
           f"{budget} B: one shot up to {backend.window_ceiling(15, budget)} "
           f"windows at int32 keys (k <= 15), "
           f"{backend.window_ceiling(23, budget)} at int64 keys (k = 19, 23, "
           f"31); the front-end's one-shot mode up to {ceiling} k-mers "
           f"(there in query chunks of "
           f"{backend.front_end_plan(ceiling, budget)[1]}), the bounded mode "
           "above (phase 22 runs both ceilings at the natural budget)")
    return sets


def walk_bytes(torch, A: np.ndarray, k: int) -> None:
    """The device walk's whole-set bytes per k-mer on run C's set, against
    backend.WALK_BYTES_PER_KMER: the bounded front-end with keep at a
    forced budget (front-end ceiling below the set, walk ceiling above),
    its peak past small query chunks, then kernel W1's walk and emission
    (core/spss._device_walk) over the arrays it kept.  Its tensors must
    equal the one-shot mode's by torch.equal, and the strings the host
    walk's."""
    from unittest import mock

    from kmerset_tpu_torch.core import spss
    from kmerset_tpu_torch.core.kmer_set import KmerSet
    from kmerset_tpu_torch.ops import backend, unitigs
    from kmerset_tpu_torch.utils import trace

    n, q = A.size, 1 << 18
    budget = (backend.FRONT_END_BYTES_PER_KMER + backend.WALK_BYTES_PER_KMER) * n
    if not backend.front_end_ceiling(budget) < n <= backend.walk_ceiling(budget):
        raise AssertionError("the forced budget does not plan the bounded walk")
    bounded = [trace.counts().get("walk.bounded", 0)]
    one = unitigs.device_unitig_succ(A, k, device=DEVICE, keep=True)
    bounded.append(trace.counts().get("walk.bounded", 0))
    budget_of = backend.memory_budget
    backend.memory_budget = lambda device: budget
    try:
        base = torch.cuda.memory_allocated()
        kept, front_peak = _peak_bytes(torch, lambda: unitigs.device_unitig_succ(
            A, k, device=DEVICE, query_chunk=q, keep=True))
        held = torch.cuda.memory_allocated() - base
        got, walk_peak = _peak_bytes(torch, lambda: spss._device_walk(A, k, *kept))
    finally:
        backend.memory_budget = budget_of
    bounded.append(trace.counts().get("walk.bounded", 0))
    if [b - a for a, b in zip(bounded, bounded[1:])] != [0, 1]:
        raise AssertionError("the front-end's modes were not one shot and bounded")
    for name, g, w in zip(("succ", "term_l", "term_r", "both", "set"), kept, one):
        if not torch.equal(g, w):
            raise AssertionError(f"bounded front-end with keep: {name} differs")
    del one, kept
    with mock.patch.object(backend, "WALK_MIN_KMERS", n + 1):
        want = spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device=DEVICE)
    if not (np.array_equal(got.codes, want.codes)
            and np.array_equal(got.offsets, want.offsets)):
        raise AssertionError("W1 from the bounded front-end: strings differ "
                             "from the host walk's")
    front_b = (front_peak - q * backend.FRONT_END_BYTES_PER_QUERY) / n
    walk_b = (held + walk_peak) / n
    say(9, f"device walk k={k}, {n} k-mers, from the bounded front-end at a "
           f"budget of {budget} B ({-(-n // q)} query chunks of 2^18): tensors "
           f"torch.equal to one shot, strings equal to the host walk's "
           f"({want.offsets.size - 1}); whole-set arrays {front_b:.2f} B/k-mer "
           f"while the front-end builds them (past the chunks' "
           f"{backend.FRONT_END_BYTES_PER_QUERY} B/query), {held / n:.2f} kept, "
           f"{walk_b:.2f} at W1's peak (walk constant "
           f"{backend.WALK_BYTES_PER_KMER})")
    if max(front_b, walk_b) > backend.WALK_BYTES_PER_KMER:
        raise AssertionError(f"device walk: {max(front_b, walk_b):.2f} B/k-mer "
                             "above WALK_BYTES_PER_KMER")


def front_end_modes(torch, A: np.ndarray, k: int, tag: str) -> None:
    """The front-end's two modes on one set at their default query chunk
    for the card's memory budget, in turns, upload and download included:
    one shot (device_unitig_succ's plan for this set) and the bounded
    mode, which the plan takes only above the ceiling.  Equal outputs."""
    from kmerset_tpu_torch.ops import backend, unitigs

    n = A.size
    budget = backend.memory_budget(DEVICE)
    bounded, q_one = backend.front_end_plan(n, budget)
    if bounded:
        raise AssertionError(f"{tag}'s set is above the front-end's ceiling")
    q_b = max(1, min(n, backend.query_chunk_kmers(
        budget - backend.BOUNDED_BYTES_PER_KMER * n)))
    times = {"one shot": [], "bounded": []}
    for _ in range(3):
        one, secs = _timed(torch, lambda: unitigs.device_unitig_succ(
            A, k, device=DEVICE))
        times["one shot"].append(secs)
        (got, _), secs = _timed(torch, lambda: unitigs.bounded_unitig_succ(
            torch.from_numpy(A).to(DEVICE), k, q_b))
        times["bounded"].append(secs)
        for name, g, w in zip(("succ", "term_l", "term_r", "both"), got, one):
            if g.dtype != w.dtype or not np.array_equal(g, w):
                raise AssertionError(f"{tag}: bounded mode's {name} differs")
    say(9, f"front-end modes on {tag}'s set (k = {k}, {n} k-mers), s, upload "
           f"and download included, in turns: one shot "
           f"({-(-n // q_one)} query chunk(s)) "
           + ", ".join(f"{t:.4f}" for t in times["one shot"])
           + f"; bounded ({-(-n // q_b)} chunk(s), two passes) "
           + ", ".join(f"{t:.4f}" for t in times["bounded"])
           + "; equal outputs")


def _canonical_graph(A: np.ndarray, k: int):
    """(succ, starts) of the canonical unitig graph of the set A, from the
    single-device front-end on the card."""
    from kmerset_tpu_torch.ops import unitigs

    succ, term_l, term_r, _ = unitigs.device_unitig_succ(A, k, device=DEVICE)
    starts = np.concatenate([np.flatnonzero(term_l & ~term_r) * 2,
                             np.flatnonzero(term_r & ~term_l) * 2 + 1])
    return succ, starts


def _walk_doubling(succ: np.ndarray, walk) -> tuple:
    """(is_chain, end, dist) of every node of the canonical unitig graph
    `succ` as the native walk from its starts (`walk`: (nodes, groups))
    lays the chains out: each walked node's chain end and steps to it;
    a node that exits nowhere and was not walked (an isolated k-mer's) is
    its own end; every other node is on a cycle.  The host's answer to
    pointer doubling in one pass, where core/graph.pointer_double takes
    10-40 s on these 33M-node graphs."""
    nodes, groups = walk
    lens = np.diff(groups)
    gid = np.repeat(np.arange(lens.size), lens)
    is_chain = succ < 0
    end = np.arange(succ.size, dtype=np.int64)
    dist = np.zeros(succ.size, dtype=np.int64)
    end[nodes] = nodes[groups[1:][gid] - 1]
    dist[nodes] = groups[1:][gid] - 1 - np.arange(nodes.size)
    is_chain[nodes] = True
    return is_chain, end, dist


def _equal(what: str, got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if len(got) != len(want) or not all(
            g is None and w is None or np.array_equal(g, w)
            for g, w in zip(got, want)):
        raise AssertionError(f"mesh: {what} differs from the single-device "
                             "or host result")


def check_mesh_programs(torch, fasta_a: str, sets: dict) -> None:
    """Each mesh program of the build at 1 and 4 shards on cuda:0, on run
    A's (k = 15) and run C's (k = 23) inputs and sets, against the
    single-device or host result: the count (raw counts), the front-end's
    succ and terminal arrays, pointer doubling (the native walk's chains),
    chain grouping (the native walk), emission (the native kept walk and
    host emission), overlap edges (the native join) and matching (the
    host's greedy matching)."""
    from kmerset_tpu_torch.core import native, spss
    from kmerset_tpu_torch.core.graph import handshake_matching
    from kmerset_tpu_torch.core.kmer_set import KmerSet
    from kmerset_tpu_torch.ops import backend, unitigs
    from kmerset_tpu_torch.parallel import driver
    from kmerset_tpu_torch.parallel.mesh import Mesh

    codes, offsets = fasta_codes(fasta_a)
    for tag, k in (("run A", 15), ("run C", 23)):
        A = sets[tag]
        count = backend.device_count(codes, offsets, k, True, device=DEVICE)
        front = unitigs.device_unitig_succ(A, k, device=DEVICE)
        succ, starts = _canonical_graph(A, k)
        walk = native.chain_walk(succ, starts)
        ch, ends, dists = _walk_doubling(succ, walk)
        kept = native.chain_walk_kept(succ, starts, lambda a, b: A[a >> 1] >= A[b >> 1])
        emitted = spss._emit_kmer_chains(A, k, *kept, oriented=True)
        ut = spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device=DEVICE)
        P, S = ut.first_kmers(k), ut.last_kmers(k)
        edges = native.overlap_edges(P, S, k)
        pa, pb = spss._dedup_port_edges(*edges, len(ut))
        match = handshake_matching(pa, pb, 2 * len(ut))
        secs, peaks = {}, {}
        for n in (1, 4):
            mesh = Mesh([MESH_DEVICE] * n)
            t = {}

            def run(name, fn):
                out, t[name] = _timed(torch, fn)
                return out

            _equal("count", run("count", lambda: driver.mesh_count(
                codes, offsets, k, True, mesh)), count)
            # The front-end's peak bytes per k-mer in one query round and
            # in 8 (shard_query_chunk forced to an eighth of the set): the
            # whole-set arrays W and a round's bytes per queried k-mer R,
            # from peak = W + R * (queried share), held to the constants
            # of its plan.
            fe, p1 = _peak_bytes(torch, lambda: run(
                "front-end", lambda: driver.mesh_unitig_succ(A, k, mesh)))
            _equal("front-end", fe, front)
            plan = driver.shard_query_chunk
            driver.shard_query_chunk = lambda m, sizes: max(1, A.size // (8 * n))
            try:
                fe8, p8 = _peak_bytes(torch, lambda: driver.mesh_unitig_succ(
                    A, k, mesh))
            finally:
                driver.shard_query_chunk = plan
            _equal("front-end in 8 query rounds", fe8, front)
            R = (p1 - p8) / A.size * 8 / 7
            peaks[n] = (p1 / A.size - R, R)
            if peaks[n][0] > driver.MESH_FRONT_END_BYTES_PER_KMER or \
                    R > driver.MESH_BYTES_PER_QUERY:
                raise AssertionError(
                    f"mesh front-end on {n} shard(s): {peaks[n][0]:.2f} B per "
                    f"k-mer of whole-set arrays, {R:.2f} B per queried k-mer; "
                    f"its plan takes {driver.MESH_FRONT_END_BYTES_PER_KMER} and "
                    f"{driver.MESH_BYTES_PER_QUERY}")
            mpd = run("pointer doubling", lambda: driver.mesh_pointer_double(
                succ, mesh=mesh))
            # Every node's is_chain, and the chain nodes' end and dist (a
            # cycle node's depend on the round count, and nothing reads them).
            _equal("pointer doubling", (mpd[2], mpd[0][ch], mpd[1][ch]),
                   (ch, ends[ch], dists[ch]))
            _equal("chain grouping", run("grouping", lambda: driver.mesh_chain_group(
                succ, starts, mesh=mesh, pd=mpd)), walk)
            ps, _ = run("emission", lambda: spss._mesh_chain_walk_kept_emit(
                A, k, succ, starts, mesh, pd=mpd))
            _equal("emission", (ps.codes, ps.offsets), (emitted.codes, emitted.offsets))
            _equal("overlap edges", run("overlap edges", lambda: driver.mesh_overlap_edges(
                P, S, k, mesh=mesh)), edges)
            _equal("matching", run("matching", lambda: driver.mesh_matching(
                pa, pb, 2 * len(ut), mesh=mesh)), match)
            secs[n] = t
        say("14 mesh", f"{tag}'s input and set (k = {k}, {A.size} k-mers, "
                       f"{succ.size} oriented nodes, {len(ut)} unitigs, "
                       f"{pa.size} port edges): count, front-end, pointer "
                       "doubling, grouping, emission, overlap edges and "
                       f"matching on 1 and 4 shards of {MESH_DEVICE} equal to the "
                       "single-device or host result; the front-end's "
                       "whole-set arrays "
                       f"{peaks[1][0]:.2f} / {peaks[4][0]:.2f} B per k-mer and "
                       f"a query round's {peaks[1][1]:.2f} / {peaks[4][1]:.2f} B "
                       "per queried k-mer at 1 / 4 shards, in one round and "
                       "in 8 (the plan takes "
                       f"{driver.MESH_FRONT_END_BYTES_PER_KMER} and "
                       f"{driver.MESH_BYTES_PER_QUERY})")
        for n, t in secs.items():
            say("14 mesh", f"{tag}, {n} shard(s), s: " + ", ".join(
                f"{name} {v:.4f}" for name, v in t.items()))


def check_mesh_multiset(torch, rng, A: np.ndarray, k: int) -> None:
    """The multi-set programs at 1 and 4 shards of one card on run A's set
    (A) and a set B from the script's seed (a random two thirds of A,
    joined with as many random k-mers not in A): sharded_hash of each,
    held to numpy's XOR reduction, and sharded_set_algebra, held to
    numpy's intersect1d and setdiff1d and their sizes."""
    from kmerset_tpu_torch.parallel import driver
    from kmerset_tpu_torch.parallel.mesh import (Mesh, sharded_hash,
                                                 sharded_set_algebra)

    keep = A[rng.random(A.size) < 2 / 3]
    new = np.setdiff1d(rng.integers(0, 1 << (2 * k), keep.size), A)
    B = np.union1d(keep, new)
    want_hash = [int(np.bitwise_xor.reduce(x)) for x in (A, B)]
    want = (np.intersect1d(A, B, assume_unique=True),
            np.setdiff1d(A, B, assume_unique=True),
            np.setdiff1d(B, A, assume_unique=True))
    secs = {}
    for n in (1, 4):
        mesh = Mesh([MESH_DEVICE] * n)
        a_blocks, _ = driver._key_blocks(mesh, A, k)
        b_blocks, _ = driver._key_blocks(mesh, B, k)
        hashes, t_hash = _timed(torch, lambda: [sharded_hash(mesh, a_blocks),
                                                sharded_hash(mesh, b_blocks)])
        if hashes != want_hash:
            raise AssertionError(f"mesh hash on {n} shard(s): {hashes} against "
                                 f"numpy's {want_hash}")
        res, t_alg = _timed(torch, lambda: sharded_set_algebra(mesh, a_blocks, b_blocks))
        *parts, sizes = res
        for name, got, w in zip(("A & B", "A - B", "B - A"), parts, want):
            if not np.array_equal(np.concatenate([g.cpu().numpy() for g in got]), w):
                raise AssertionError(f"mesh set algebra on {n} shard(s): {name} "
                                     "differs from numpy's")
        if sizes.tolist() != [w.size for w in want]:
            raise AssertionError(f"mesh set algebra on {n} shard(s): sizes "
                                 f"{sizes.tolist()}")
        secs[n] = (t_hash, t_alg)
    say("14 mesh", f"run A's set (k = {k}, {A.size} k-mers) and B ({B.size}: "
                   f"{keep.size} of A and {new.size} new): sharded_hash and "
                   f"sharded_set_algebra on 1 and 4 shards of {MESH_DEVICE} "
                   f"equal to numpy (hashes {want_hash[0]}, {want_hash[1]}; "
                   f"|A & B| {want[0].size}, |A - B| {want[1].size}, |B - A| "
                   f"{want[2].size}); s at 1 / 4 shards: hash of both "
                   f"{secs[1][0]:.4f} / {secs[4][0]:.4f}, set algebra "
                   f"{secs[1][1]:.4f} / {secs[4][1]:.4f}")


def time_mesh_graph(torch, A: np.ndarray, k: int, turns: int = 2) -> None:
    """Run A's SPSS build from its set on a 1-shard mesh of one card (the
    front-end, pointer doubling, grouping and emission, overlap edges,
    matching and cycle breaking on the card) and on the single-device
    path (device front-end, host chain walk and path cover), in turns,
    with the same phase lines as the CLI runs; equal strings."""
    from kmerset_tpu_torch.core import spss
    from kmerset_tpu_torch.core.kmer_set import KmerSet
    from kmerset_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh([MESH_DEVICE])
    rows = {"single device": [], "1-shard mesh": []}
    outs = {}
    for _ in range(turns):
        for name, kw in (("single device", {}), ("1-shard mesh", {"mesh": mesh})):
            cap = _Capture()
            log = logging.getLogger(CLI_LOGGER)
            log.addHandler(cap)
            try:
                out, secs = _timed(torch, lambda: spss.get_spss_canonical(
                    KmerSet(k, A, _sorted=True), device=DEVICE, **kw))
            finally:
                log.removeHandler(cap)
            msgs = [m for _, m in cap.records]
            rows[name].append((secs, _phase_times(msgs), _mesh_steps(msgs)))
            outs[name] = out
    a, b = outs["single device"], outs["1-shard mesh"]
    if not (np.array_equal(a.codes, b.codes) and np.array_equal(a.offsets, b.offsets)):
        raise AssertionError("the 1-shard mesh's SPSS differs from the single device's")
    for name, runs in rows.items():
        for i, (secs, ph, steps) in enumerate(runs):
            say("15 mesh", f"run A's set (k = {k}), {name}, turn {i + 1}: "
                           f"SPSS build {secs:.3f} s [" + ", ".join(
                               f"{p} {ph[p]:.2f}" for p in _PHASES)
                + "]" + ("; mesh steps " + ", ".join(
                    f"{n} {v:.4f}" for n, v in steps.items()) if steps else ""))
    walk = {name: statistics.median(
        sum(ph[p] for p in _PHASES[1:]) for _, ph, _ in runs)
        for name, runs in rows.items()}
    say("15 mesh", "walk + emission + path cover, median s: " + ", ".join(
        f"{n} {v:.2f}" for n, v in walk.items()) + f"; equal strings "
        f"({len(a)}); the slower stays and is written down")


def check_sketch(torch, rng) -> None:
    """All 4,950 pair weights of 100 sketches of ~85K keys (2% of a
    ~4.2M-k-mer set, the README's 100-set scale) on cuda, equal to the
    same table on the CPU and, for 64 pairs, to a numpy intersection; and
    the same rows as a key-range-sharded MeshSketchTable on 1 and on 4
    shards of one card, equal to the single table on every pair, timed
    beside it, with each shard's width against the reference's rule (every
    shard pow2 of the widest whole sketch)."""
    from kmerset_tpu_torch.ops.sketch import DeviceSketchTable, MeshSketchTable
    from kmerset_tpu_torch.parallel.mesh import Mesh

    pool = np.unique(rng.integers(0, 1 << 30, 170_000))
    sketches = []
    for _ in range(100):
        keep = pool[rng.random(pool.size) < rng.uniform(0.3, 0.6)]
        own = rng.integers(0, 1 << 30, int(rng.integers(0, 20_000)))
        sketches.append(np.unique(np.concatenate([keep, own])))
    pairs = [(i, j) for i in range(100) for j in range(i + 1, 100)]
    table = DeviceSketchTable(sketches, device=DEVICE)
    if table.rows.device.type != torch.device(DEVICE).type:
        raise AssertionError("the sketch table is not on the card")
    table.pair_weights(pairs[:100])  # warm-up
    got, secs = _timed(torch, lambda: table.pair_weights(pairs))
    t0 = time.perf_counter()
    want = DeviceSketchTable(sketches, device="cpu").pair_weights(pairs)
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(got, want):
        raise AssertionError("sketch weights differ between cuda and cpu")
    for p in rng.choice(len(pairs), 64, replace=False):
        i, j = pairs[p]
        if got[p] != np.intersect1d(sketches[i], sketches[j],
                                    assume_unique=True).size:
            raise AssertionError(f"sketch weight of {pairs[p]} is wrong")
    mean = float(np.mean([s.size for s in sketches]))
    say(10, f"sketch table: 100 rows of {mean:.0f} keys on average "
            f"(widest {table.S}), {len(pairs)} pair weights on cuda in "
            f"{secs:.4f} s ({table.batch_pairs()} pairs per batch), equal to "
            f"the CPU table ({cpu_s:.3f} s there) and, for 64 pairs, to "
            "numpy's intersect1d")
    pow2 = 1 << (table.S - 1).bit_length()
    for n in (1, 4):
        mesh = Mesh([MESH_DEVICE] * n)
        mt = MeshSketchTable(sketches, 15, mesh)
        if any(r.device != torch.device(MESH_DEVICE) for r in mt.rows):
            raise AssertionError("the mesh sketch table is not on the card")
        mt.pair_weights(pairs[:100])  # warm-up
        mesh_got, mesh_s = _timed(torch, lambda: mt.pair_weights(pairs))
        _, single_s = _timed(torch, lambda: table.pair_weights(pairs))
        if not np.array_equal(mesh_got, got):
            raise AssertionError(
                f"the mesh sketch table on {n} shard(s) differs from the "
                "single table")
        say(10, f"mesh sketch table on {n} shard(s) of {MESH_DEVICE}: all "
                f"{len(pairs)} pair weights equal to the single table's; "
                f"{mesh_s:.4f} s against the single table's {single_s:.4f} s "
                f"in turn; shard widths {mt.widths} (sum {sum(mt.widths)}; "
                f"the reference's rule: {n} x pow2({table.S}) = {n * pow2}); "
                f"{mt.batch_pairs()} pairs per batch")


M_SETS = 8
M_BASES = 1 << 21  # bench.py:214's size; 2^22 made the script run past 600 s


def _capture_run(cli, argv):
    """Runs a port CLI's main(argv) in this process: (stdout, log lines
    with their times, wall s)."""
    cap = _Capture()
    log = logging.getLogger(CLI_LOGGER)
    log.addHandler(cap)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            cli.main(argv)
    finally:
        log.removeHandler(cap)
    return out.getvalue(), cap.records, time.perf_counter() - t0


_HASH_SIZE = re.compile(r"kmer_set\.(Hash|Size)\(\) = (\d+)")
_DEFERRED = re.compile(r"deferred SPSS build ([\d.]+) s")
_ORACLE = re.compile(r"sketch table on (.+?) ([\d.]+) s \((\d+) pair")


def write_strains(rng):
    """Eight related strains of one random genome (M_BASES // 500
    substitutions each), as FASTA files under WORK."""
    base = rng.integers(0, 4, M_BASES, dtype=np.uint8)
    fastas = []
    for i in range(M_SETS):
        mut = base.copy()
        pos = rng.integers(0, M_BASES, M_BASES // 500)
        mut[pos] = rng.integers(0, 4, pos.size, dtype=np.uint8)
        fastas.append(os.path.join(WORK, f"m{i}.fa"))
        with open(fastas[-1], "wb") as f:
            for j in range(0, M_BASES, 10_000):
                f.write(b">m%d_%d\n" % (i, j) + _BASES[mut[j:j + 10_000]].tobytes()
                        + b"\n")
    return fastas


def run_m(torch, tag: str, k: int, fastas) -> dict:
    """The strains built at k, then compressed, decompressed, stat'd and
    spss-benchmarked through the port's CLIs on the card, each against
    the reference's CLI on the host."""
    from kmerset_tpu_torch.cli import (kmerset_build, kmerset_multiple_compress,
                                       kmerset_multiple_decompress,
                                       kmerset_stat, spss_benchmark)

    K = str(k)
    sets = [os.path.join(WORK, f"m{i}_k{k}.txt") for i in range(len(fastas))]
    port_dir, ref_dir = (os.path.join(WORK, f"M{k}_{d}") for d in ("port", "ref"))
    rtag = f"m{k}"
    launches0, routes0 = _launch_counts(), len(_ROUTES)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for fa, out in zip(fastas, sets):
        kmerset_build.main(["--device", DEVICE, "--k", K, "--cutoff", "1",
                            "--out", out, fa])
    build_s = time.perf_counter() - t0
    refs = {
        "compress": RefCli(f"{rtag}_compress", "kmerset_multiple_compress", [
            "--k", K, "--seed", "1", "--out", ref_dir, "--out_graph",
            ref_dir + ".dot", *sets]),
        "stat": RefCli(f"{rtag}_stat", "kmerset_stat", ["--k", K, *sets]),
        "bench": RefCli(f"{rtag}_bench", "spss_benchmark", ["--k", K, sets[0]]),
    }
    try:
        _, comp_log, comp_s = _capture_run(kmerset_multiple_compress, [
            "--device", DEVICE, "--k", K, "--seed", "1", "--workers", "4",
            "--out", port_dir, "--out_graph", port_dir + ".dot", *sets])
        _, dec_log, dec_s = _capture_run(kmerset_multiple_decompress, [
            "--device", DEVICE, "--k", K, port_dir])
        stat_out, _, stat_s = _capture_run(kmerset_stat, [
            "--device", DEVICE, "--k", K, *sets])
        bench_out, _, bench_s = _capture_run(spss_benchmark, [
            "--device", DEVICE, "--k", K, sets[0]])
        launches = _launches_since(launches0)
        peak_gib = torch.cuda.max_memory_allocated() / (1 << 30)
        _, _, ref_comp_s = refs["compress"].wait_output(900)
        refs["decompress"] = RefCli(f"{rtag}_decompress",
                                    "kmerset_multiple_decompress",
                                    ["--k", K, ref_dir])
        ref_stat, _, _ = refs["stat"].wait_output(900)
        ref_bench, ref_bench_err, _ = refs["bench"].wait_output(900)
        _, ref_dec_err, ref_dec_s = refs["decompress"].wait_output(900)
    finally:
        for ref in refs.values():
            ref.kill()

    names = sorted(os.listdir(port_dir))
    if names != sorted(os.listdir(ref_dir)) or "meta.txt" not in names:
        raise AssertionError(f"{tag}: directories hold other files: {names}")
    match, mismatch, errors = filecmp.cmpfiles(port_dir, ref_dir, names,
                                               shallow=False)
    if mismatch or errors or not filecmp.cmp(port_dir + ".dot",
                                             ref_dir + ".dot", shallow=False):
        raise AssertionError(f"{tag}: files differ: {mismatch + errors} "
                             "(or the DOT files)")
    dec = [m.groups() for m in map(_HASH_SIZE.search,
                                   (msg for _, msg in dec_log)) if m]
    if dec != _HASH_SIZE.findall(ref_dec_err):
        raise AssertionError(f"{tag}: decompressed Hash()/Size() differ")
    if stat_out != ref_stat:
        raise AssertionError(f"{tag}: kmerset-stat TSV differs")
    for i, row in enumerate(stat_out.splitlines()):
        _, _, size, hash_ = row.split("\t")
        if dec[2 * i : 2 * i + 2] != [("Hash", hash_), ("Size", size)]:
            raise AssertionError(f"{tag}: set {i} decompressed to another set")
    p, r = bench_out.split(), ref_bench.split()
    if len(p) != 8 or [p[i] for i in (1, 3, 5, 7)] != [r[i] for i in (1, 3, 5, 7)] \
            or p[3] != "1" or p[7] != "1":
        raise AssertionError(f"{tag}: spss-benchmark {p} against {r}")
    for name in ("B1" if k == 15 else "B2", "B3"):
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched")
    # The strains' builds and spss-benchmark's set at least on the card.
    if _check_walks(tag, launches, routes0) < len(fastas) + 1:
        raise AssertionError(f"{tag}: sets walked {launches}")
    msgs = [m for _, m in comp_log]
    builds = [float(m.group(1)) for m in map(_DEFERRED.search, msgs) if m]
    oracle = [m.groups() for m in map(_ORACLE.search, msgs) if m]
    if not builds or len(oracle) != 1 or oracle[0][0] != DEVICE:
        raise AssertionError(f"{tag}: deferred builds {builds}, oracle {oracle}")
    sizes = [int(l.split("\t")[2]) for l in stat_out.splitlines()]
    w_in = sum(os.path.getsize(f) for f in sets)
    w_out = sum(os.path.getsize(os.path.join(port_dir, n)) for n in names
                if n != "meta.txt")
    say(tag, f"--k {k}: {M_SETS} strains of a {M_BASES}-base genome "
             f"({M_BASES // 500} substitutions each), {min(sizes)}-"
             f"{max(sizes)} k-mers: directory ({len(names)} files) and DOT "
             f"byte-identical to the reference CLI's; decompressed "
             f"Hash()/Size() equal to the reference's and to kmerset-stat "
             f"(TSV equal); spss-benchmark weights {p[1]} / {p[5]} and ok "
             f"equal; launches {launches}; sketch table on {oracle[0][0]}; "
             f"peak device memory {peak_gib:.3f} GiB")
    say(tag, f"wall s: 8 builds {build_s:.3f}, compress {comp_s:.3f} "
             f"({len(builds)} deferred SPSS builds, {sum(builds):.3f} s in "
             f"all; sketch table {float(oracle[0][1]):.4f} s for "
             f"{oracle[0][2]} pair weights), decompress {dec_s:.3f}, stat "
             f"{stat_s:.3f}, spss-benchmark {bench_s:.3f}; reference host "
             f"compress {ref_comp_s:.3f}, decompress {ref_dec_s:.3f} "
             "(subprocesses beside the port's runs)")
    say(tag, f"weight in -> out: {w_in} -> {w_out} bytes of dumps "
             f"(ratio {w_out / w_in:.4f})")
    return {"launches": launches, "ref": {
        "sets": sets, "dir": ref_dir, "stat": ref_stat, "bench": ref_bench,
        "decompress": ref_dec_err, "compress_s": ref_comp_s,
        "decompress_s": ref_dec_s,
    }, "port_s": {"compress": comp_s, "decompress": dec_s, "stat": stat_s,
                  "bench": bench_s}}


# A rank of a process group: the port's CLI (argv[1]) with argv[2:], its
# log lines to stderr one message per line, then its wall split and
# launch counts as JSON on stdout.
_RANK_CLI = (
    "import importlib, json, logging, sys, time\n"
    "t0 = time.perf_counter()\n"
    "from kmerset_tpu_torch.utils import trace\n"
    "cli = importlib.import_module('kmerset_tpu_torch.cli.' + sys.argv[1])\n"
    "log = logging.getLogger('kmerset')\n"
    "echo = logging.StreamHandler(sys.stderr)\n"
    "echo.setFormatter(logging.Formatter('%(message)s'))\n"
    "log.addHandler(echo)\n"
    "log.propagate = False\n"
    "t1 = time.perf_counter()\n"
    "cli.main(sys.argv[2:])\n"
    "print(json.dumps({'import_s': t1 - t0, 'cli_s': time.perf_counter() - t1,\n"
    "                  'launches': {n: trace.counts().get(\n"
    "                      n if '.' in n else 'launch.' + n, 0)\n"
    f"                               for n in {COUNTED!r}}}}}))\n"
)
GROUP_TIMEOUT_S = 600


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def group_run(tag: str, cli: str, devices, args_of) -> list:
    """The port's CLI `cli` as len(devices) ranks of one process group
    (KMERSET_TPU_DISTRIBUTED on a free local port), rank r on --device
    devices[r] with args_of(r), all started at once.  Returns per rank
    {"import_s", "cli_s", "launches", "log" (message lines), "steps"}.
    A rank that exits non-zero or outlives GROUP_TIMEOUT_S fails the run,
    and every rank still running is killed."""
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    try:
        for r, dev in enumerate(devices):
            err = open(os.path.join(WORK, f"{tag.replace(' ', '_')}_rank{r}.log"), "w+")
            env = dict(os.environ, KMERSET_TPU_DISTRIBUTED=
                       f"127.0.0.1:{port},{len(devices)},{r}")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _RANK_CLI, cli, "--debug", "--device",
                 dev, *args_of(r)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=err, text=True), err))
        out = []
        for r, (proc, err) in enumerate(procs):
            left = GROUP_TIMEOUT_S - (time.perf_counter() - t0)
            try:
                stdout, _ = proc.communicate(timeout=max(1.0, left))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{tag}: rank {r} outlived {GROUP_TIMEOUT_S} s")
            err.seek(0)
            log = err.read().splitlines()
            if proc.returncode != 0:
                raise AssertionError(f"{tag}: rank {r} exited {proc.returncode}:\n"
                                     + "\n".join(log[-40:]))
            info = json.loads(stdout.strip().splitlines()[-1])
            out.append({**info, "log": log, "steps": _mesh_steps(log)})
    finally:
        for proc, err in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            err.close()
    return out


def _need_lines(tag: str, log, lines) -> None:
    for line in lines:
        if line not in log:
            raise AssertionError(f"{tag}: no line {line!r} in the log")


def _rank_line(ranks) -> str:
    return "; ".join(
        f"rank {r} wall {x['import_s'] + x['cli_s']:.3f} (import "
        f"{x['import_s']:.3f}), launches {x['launches']}, mesh steps "
        + ", ".join(f"{n} {v:.4f}" for n, v in x["steps"].items())
        for r, x in enumerate(ranks))


def group_build(tag: str, fasta: str, k: int, ref, kernels, devices,
                mesh_line: str, single_s: float, three) -> dict:
    """kmerset-build --cutoff 1 --check of `fasta` at k as a process group
    (rank r on devices[r]), each rank's dump held against the reference
    dump `ref.out`; each rank's log must show the group's mesh line
    (mesh_line), its --check ok and the count, decode and graph steps,
    and each rank must launch `kernels`."""
    outs = [os.path.join(WORK, f"{tag.replace(' ', '_')}_rank{r}.txt")
            for r in range(len(devices))]
    ranks = group_run(tag, "kmerset_build", devices, lambda r: [
        "--k", str(k), "--cutoff", "1", "--check", "--out", outs[r], fasta])
    n = sum(d.count(",") + 1 for d in devices)
    for r, (x, out) in enumerate(zip(ranks, outs)):
        if not filecmp.cmp(out, ref.out, shallow=False):
            raise AssertionError(f"{tag}: rank {r}'s dump differs from the reference's")
        _need_lines(f"{tag} rank {r}", x["log"], [
            mesh_line, "kmer_set_compact -> KmerSet: ok"])
        need = {"count", "decode", "front-end", "pointer doubling"}
        if not need <= set(x["steps"]):
            raise AssertionError(f"{tag}: rank {r}'s mesh steps {x['steps']}")
        for name in kernels:
            if x["launches"][name] <= 0:
                raise AssertionError(f"{tag}: rank {r} launched no {name}")
        # Every rank walks the set once, on the host, as a mesh does.
        if [x["launches"][w] for w in WALKS] != [0, 1]:
            raise AssertionError(f"{tag}: rank {r} walked {x['launches']}")
    say(tag, f"--k {k} --cutoff 1 --check, {len(devices)} ranks on --device "
             f"{' / '.join(devices)} ({n} shards): every rank's dump "
             f"byte-identical to the reference CLI's; {mesh_line!r}")
    say(tag, "wall s: " + _rank_line(ranks))
    if three is not None:
        say(tag, f"beside: the single-process {n}-shard mesh {three['total_s']:.3f} s "
                 f"(mesh steps " + ", ".join(f"{a} {v:.4f}" for a, v in
                                             three["steps"].items())
                 + f"), one device {single_s:.3f} s")
    return {"launches": {name: sum(x["launches"][name] for x in ranks)
                         for name in COUNTED}}


def serial_compress(m: dict, devices: str) -> float:
    """Run M's compress in one process on the mesh `devices` with
    --workers 1, the order a process group imposes on its deferred builds
    (items in order, one at a time); its directory and DOT held against
    the reference's.  Returns its wall s."""
    from kmerset_tpu_torch.cli import kmerset_multiple_compress

    ref = m["ref"]
    out = os.path.join(WORK, "M15_serial")
    _, _, secs = _capture_run(kmerset_multiple_compress, [
        "--device", devices, "--k", "15", "--seed", "1", "--workers", "1",
        "--out", out, "--out_graph", out + ".dot", *ref["sets"]])
    names = sorted(os.listdir(ref["dir"]))
    _, mismatch, errors = filecmp.cmpfiles(out, ref["dir"], names, shallow=False)
    if mismatch or errors or not filecmp.cmp(out + ".dot", ref["dir"] + ".dot",
                                             shallow=False):
        raise AssertionError("run M's compress with --workers 1 differs")
    return secs


def group_compress(tag: str, m: dict, devices, mesh_line: str,
                   three: dict) -> dict:
    """Run M's kmerset-multiple-compress (--seed 1 --workers 4) as a
    process group, each rank's directory and DOT file held against the
    reference's of phase 11 (m["ref"])."""
    ref = m["ref"]
    dirs = [os.path.join(WORK, f"M15_group_rank{r}") for r in range(len(devices))]
    ranks = group_run(tag, "kmerset_multiple_compress", devices, lambda r: [
        "--k", "15", "--seed", "1", "--workers", "4", "--out", dirs[r],
        "--out_graph", dirs[r] + ".dot", *ref["sets"]])
    names = sorted(os.listdir(ref["dir"]))
    n = sum(d.count(",") + 1 for d in devices)
    for r, (x, d) in enumerate(zip(ranks, dirs)):
        _, mismatch, errors = filecmp.cmpfiles(d, ref["dir"], names, shallow=False)
        if sorted(os.listdir(d)) != names or mismatch or errors or not filecmp.cmp(
                d + ".dot", ref["dir"] + ".dot", shallow=False):
            raise AssertionError(f"{tag}: rank {r}'s directory or DOT differs")
        _need_lines(f"{tag} rank {r}", x["log"], [mesh_line])
        if not any("run in item order" in line for line in x["log"]):
            raise AssertionError(f"{tag}: rank {r} ran its deferred builds in a pool")
        if not {"decode", "sketch weights"} <= set(x["steps"]) \
                or not _GRAPH_STEPS & set(x["steps"]):
            raise AssertionError(f"{tag}: rank {r}'s mesh steps {x['steps']}")
        for name in ("B1", "B3"):
            if x["launches"][name] <= 0:
                raise AssertionError(f"{tag}: rank {r} launched no {name}")
        if x["launches"]["walk.device"] != 0 or x["launches"]["walk.host"] <= 0:
            raise AssertionError(f"{tag}: rank {r} walked {x['launches']}")
    say(tag, f"--k 15 --seed 1 --workers 4, {len(devices)} ranks on --device "
             f"{' / '.join(devices)} ({n} shards): every rank's directory "
             f"({len(names)} files) and DOT byte-identical to the reference "
             "CLI's; deferred builds in item order")
    say(tag, "wall s: " + _rank_line(ranks))
    say(tag, f"beside: the single-process {n}-shard mesh's compress "
             f"{three['compress_s']:.3f} s with --workers 4 (mesh steps "
             + ", ".join(f"{a} {v:.4f}" for a, v in three["steps"].items())
             + f") and {three['serial_s']:.3f} s with --workers 1 (item "
             f"order, as in a group), one device {m['port_s']['compress']:.3f} s")
    return {"launches": {name: sum(x["launches"][name] for x in ranks)
                         for name in COUNTED}}


# The graph steps a deferred SPSS build takes on the mesh (parallel/
# driver.py's step names).
_GRAPH_STEPS = {"front-end", "pointer doubling", "chain grouping and emission",
                "chain grouping", "overlap edges", "matching"}


def run_m_mesh(torch, tag: str, k: int, m: dict, devices: str) -> dict:
    """Run M's (or M31's) compress, decompress, stat and spss-benchmark
    through the port's CLIs on the mesh `devices`, each held against the
    reference outputs that run_m kept (m["ref"]): directory and DOT
    byte-identical, Hash()/Size(), TSV and spss-benchmark columns equal.
    The compress log must show the mesh's sketch table, its decodes and
    its graph steps."""
    from kmerset_tpu_torch.cli import (kmerset_multiple_compress,
                                       kmerset_multiple_decompress,
                                       kmerset_stat, spss_benchmark)

    K, ref = str(k), m["ref"]
    sets, ref_dir = ref["sets"], ref["dir"]
    port_dir = os.path.join(WORK, f"M{k}_mesh_{devices.count(',') + 1}")
    dev = ["--device", devices, "--k", K]
    launches0, routes0 = _launch_counts(), len(_ROUTES)
    torch.cuda.reset_peak_memory_stats()
    _, comp_log, comp_s = _capture_run(kmerset_multiple_compress, [
        *dev, "--seed", "1", "--workers", "4", "--out", port_dir,
        "--out_graph", port_dir + ".dot", *sets])
    _, dec_log, dec_s = _capture_run(kmerset_multiple_decompress, [*dev, port_dir])
    stat_out, _, stat_s = _capture_run(kmerset_stat, [*dev, *sets])
    bench_out, _, bench_s = _capture_run(spss_benchmark, [*dev, sets[0]])
    launches = _launches_since(launches0)
    peak_gib = torch.cuda.max_memory_allocated() / (1 << 30)

    names = sorted(os.listdir(port_dir))
    if names != sorted(os.listdir(ref_dir)):
        raise AssertionError(f"{tag}: directories hold other files: {names}")
    match, mismatch, errors = filecmp.cmpfiles(port_dir, ref_dir, names,
                                               shallow=False)
    if mismatch or errors or not filecmp.cmp(port_dir + ".dot",
                                             ref_dir + ".dot", shallow=False):
        raise AssertionError(f"{tag}: files differ: {mismatch + errors} "
                             "(or the DOT files)")
    dec = [m_.groups() for m_ in map(_HASH_SIZE.search,
                                     (msg for _, msg in dec_log)) if m_]
    if dec != _HASH_SIZE.findall(ref["decompress"]):
        raise AssertionError(f"{tag}: decompressed Hash()/Size() differ")
    if stat_out != ref["stat"]:
        raise AssertionError(f"{tag}: kmerset-stat TSV differs")
    p, r = bench_out.split(), ref["bench"].split()
    if len(p) != 8 or [p[i] for i in (1, 3, 5, 7)] != [r[i] for i in (1, 3, 5, 7)] \
            or p[3] != "1" or p[7] != "1":
        raise AssertionError(f"{tag}: spss-benchmark {p} against {r}")
    for name in ("B1" if k == 15 else "B2", "B3"):
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched")
    # A mesh keeps the host walk and never asks walk_route.
    _check_walks(tag, launches, routes0, host=launches["walk.host"])
    if launches["walk.host"] <= 0:
        raise AssertionError(f"{tag}: sets walked {launches}")
    msgs = [msg for _, msg in comp_log]
    oracle = [m_.groups() for m_ in map(_ORACLE.search, msgs) if m_]
    steps = _mesh_steps(msgs)
    n = devices.count(",") + 1
    if len(oracle) != 1 or not oracle[0][0].startswith(f"mesh of {n} shards"):
        raise AssertionError(f"{tag}: the sketch table ran on {oracle}")
    if "decode" not in steps or "sketch weights" not in steps \
            or not _GRAPH_STEPS & set(steps):
        raise AssertionError(f"{tag}: the compress's mesh steps: {steps}")
    single = m["port_s"]
    say(tag, f"--k {k} --device {devices}: directory ({len(names)} files) and "
             "DOT byte-identical to the reference CLI's; decompressed "
             "Hash()/Size(), kmerset-stat TSV and spss-benchmark weights "
             f"{p[1]} / {p[5]} and ok equal; launches {launches}; sketch table "
             f"on {oracle[0][0]}; peak device memory {peak_gib:.3f} GiB")
    say(tag, f"wall s: compress {comp_s:.3f} (sketch table "
             f"{float(oracle[0][1]):.4f} s for {oracle[0][2]} pair weights), "
             f"decompress {dec_s:.3f}, stat {stat_s:.3f}, spss-benchmark "
             f"{bench_s:.3f}; one device {single['compress']:.3f}, "
             f"{single['decompress']:.3f}, {single['stat']:.3f}, "
             f"{single['bench']:.3f}; reference host compress "
             f"{ref['compress_s']:.3f}, decompress {ref['decompress_s']:.3f}")
    say(tag, "compress's mesh steps, s: " + ", ".join(
        f"{name} {v:.4f}" for name, v in steps.items()))
    return {"launches": launches, "compress_s": comp_s, "steps": steps}


# Phase 20's reference side: the same library calls through the
# reference's API (pinned to its host arms) on the .npy inputs the phase
# writes, in a subprocess beside the port's calls.  argv: WORK, the run D
# reads, run A's dump, the generators' seed and set size.  Its array
# results go to WORK/lib_ref_*.npy, its scalars and times to the last line.
_LIBRARY_REF = (
    "import json, os, sys, time\n"
    "import numpy as np\n"
    "from kmerset_tpu.core.kmer_counter import KmerCounter\n"
    "from kmerset_tpu.core.kmer_set import KmerSet, intersection_size\n"
    "from kmerset_tpu.utils.io import get_kmer_set_from_file\n"
    "from kmerset_tpu.utils.random import get_random_kmer_set_set\n"
    "work, reads, dump, seed, m = sys.argv[1:6]\n"
    "ld = lambda n: np.load(os.path.join(work, f'lib_{n}.npy'))\n"
    "sv = lambda n, a: np.save(os.path.join(work, f'lib_ref_{n}.npy'), a)\n"
    "secs, out = {}, {}\n"
    "def timed(name, fn):\n"
    "    t0 = time.perf_counter(); r = fn()\n"
    "    secs[name] = time.perf_counter() - t0; return r\n"
    "S, T = ld('S'), ld('T')\n"
    "s, t = KmerSet(15, S, _sorted=True), KmerSet(15, T, _sorted=True)\n"
    "sv('contains', timed('contains', lambda: s.contains(T)))\n"
    "sv('union', timed('union', lambda: s.union(t)).kmers)\n"
    "sv('subtract', timed('subtract', lambda: s.subtract(t)).kmers)\n"
    "sv('intersection', timed('intersection', lambda: s.intersection(t)).kmers)\n"
    "out['diff_count'] = timed('diff_count', lambda: s.diff_count(t))\n"
    "out['intersection_size'] = timed('intersection_size',\n"
    "                                 lambda: intersection_size(S, T))\n"
    "out['hash'] = timed('hash', lambda: [s.hash(), t.hash()])\n"
    "c = timed('counter from_fasta', lambda: KmerCounter.from_fasta(\n"
    "    19, reads, '', True))\n"
    "adds = ld('adds')\n"
    "timed('adds', lambda: [c.add(int(x), int(v)) for x, v in adds])\n"
    "out['get'] = timed('get', lambda: [c.get(int(x)) for x in ld('probes')])\n"
    "out['size'] = c.size()\n"
    "ks, out['n_cut'] = timed('to_kmer_set', lambda: c.to_kmer_set(2))\n"
    "sv('counter_kmers', c.kmers); sv('counter_counts', c.counts)\n"
    "sv('counter_set', ks.kmers)\n"
    "kss = timed('get_random_kmer_set_set', lambda: get_random_kmer_set_set(\n"
    "    8, int(m), 15, True, np.random.default_rng(int(seed))))\n"
    "timed('dump', lambda: kss.dump(os.path.join(work, 'lib_sets_ref'), '', 'txt'))\n"
    "f = timed('get_kmer_set_from_file', lambda: get_kmer_set_from_file(\n"
    "    15, dump, '', True))\n"
    "out['file'] = [f.size(), f.hash()]\n"
    "print(json.dumps({'out': out, 'secs': secs}))\n"
)


class RefScript(RefCli):
    """A Python program (`code`) run with the reference's environment and
    working directory, beside the port's calls."""

    def __init__(self, tag: str, code: str, args):
        self._start(tag, ["-c", code, *args])


LIB_SETS_SEED = SEED + 20  # get_random_kmer_set_set's generator
LIB_SETS_M = 50_000  # k-mers per generated set
LIB_CUTOFFS = (1, 2)


def check_library(torch, rng, fasta_a: str, fasta_d: str, S: np.ndarray,
                  dump_a: str) -> dict:
    """Phase 20, the library surface on the card.  The unpacked-code count
    entries (ops/count.count_kmers, count_to_set at cutoffs 1 and 2) on
    run A's genome with window_validity's mask at k = 15 (B1), 23 and 31
    (B2); KmerSet's queries and algebra on run A's set S (k = 15) and a
    set T from the seed (half of S and as many random k-mers), with
    intersection_size, the hash and ops/join.intersection_count on the
    card; a KmerCounter of run D's reads (k = 19) on the card with 10^4
    adds, get, size and to_kmer_set(2); get_random_kmer_set_set (8 sets,
    k = 15) on the card, dumped; and utils/io.get_kmer_set_from_file of
    run A's dump, decoded on the card.  Each library call is driven once
    with the launch counts at 0, and those counts are returned; then each
    is held against the reference's same call in a subprocess (RefScript,
    _LIBRARY_REF), the count entries against backend.device_count and
    against their plain versions on the card, and each is timed."""
    from kmerset_tpu_torch.core.kmer_counter import KmerCounter, extract_kmers
    from kmerset_tpu_torch.core.kmer_set import KmerSet, intersection_size
    from kmerset_tpu_torch.ops import backend, compact, pack
    from kmerset_tpu_torch.ops import count as count_ops
    from kmerset_tpu_torch.ops.join import intersection_count
    from kmerset_tpu_torch.utils.io import get_kmer_set_from_file
    from kmerset_tpu_torch.utils.random import get_random_kmer_set_set

    t20 = time.perf_counter()
    tag = "20 library"
    k_s = 15
    # T: half of S and as many random k-mers not in S, built with sorts
    # (np.unique hashes on some numpy releases, which is far slower here).
    half = S[rng.random(S.size) < 0.5]
    new = np.sort(rng.integers(0, 1 << (2 * k_s), half.size))
    new = new[np.concatenate([[True], new[1:] != new[:-1]])]
    new = new[S[np.minimum(np.searchsorted(S, new), S.size - 1)] != new]
    T = np.sort(np.concatenate([half, new]))
    np.save(os.path.join(WORK, "lib_S.npy"), S)
    np.save(os.path.join(WORK, "lib_T.npy"), T)
    # Adds to run D's counter: canonical 19-mers of its first 1000 reads
    # (counted already) and random ones, a few of them saturating.
    codes_d, offsets_d = fasta_codes(fasta_d)
    cut = int(offsets_d[min(1000, offsets_d.size - 1)])
    seen = rng.choice(extract_kmers(codes_d[:cut], offsets_d[offsets_d <= cut],
                                    19, True), 5000)
    adds_k = np.concatenate([seen, rng.integers(0, 1 << 38, 5000)])
    adds_v = rng.integers(1, 4, adds_k.size)
    adds_v[:50] = 255
    adds = np.stack([adds_k, adds_v], axis=1)
    probes = np.concatenate([adds_k[::10], rng.integers(0, 1 << 38, 100)])
    np.save(os.path.join(WORK, "lib_adds.npy"), adds)
    np.save(os.path.join(WORK, "lib_probes.npy"), probes)
    for d in ("lib_sets_port", "lib_sets_ref"):
        shutil.rmtree(os.path.join(WORK, d), ignore_errors=True)
    ref = RefScript("lib", _LIBRARY_REF, [WORK, fasta_d, dump_a,
                                          str(LIB_SETS_SEED), str(LIB_SETS_M)])
    try:
        codes, offsets = fasta_codes(fasta_a)
        codes_t = torch.from_numpy(codes).to(DEVICE)
        valid_t = {}
        for k in (15, 23, 31):
            v = count_ops.window_validity(offsets, codes.size, k)
            valid_t[k] = torch.from_numpy(v).to(DEVICE)
        S_t, T_t = (torch.from_numpy(x).to(DEVICE) for x in (S, T))
        s_set, t_set = KmerSet(k_s, S, _sorted=True), KmerSet(k_s, T, _sorted=True)

        # The library calls, once each, with the launch counts at 0; the
        # host set algebra first, beside the reference's.
        launches0 = _launch_counts()
        got, mine = {}, {}

        def timed(name, fn):
            t0 = time.perf_counter()
            r = fn()
            mine[name] = time.perf_counter() - t0
            return r

        got["contains"] = timed("contains", lambda: s_set.contains(T))
        for op in ("union", "subtract", "intersection"):
            got[op] = timed(op, lambda: getattr(s_set, op)(t_set)).kmers
        scalars = {
            "diff_count": timed("diff_count", lambda: s_set.diff_count(t_set)),
            "intersection_size": timed("intersection_size",
                                       lambda: intersection_size(S, T)),
            "hash": timed("hash", lambda: [s_set.hash(), t_set.hash()]),
        }
        for k in (15, 23, 31):
            got[k, "count"] = count_ops.count_kmers(codes_t, valid_t[k], k, True)
            for c in LIB_CUTOFFS:
                got[k, c] = count_ops.count_to_set(codes_t, valid_t[k], k, True, c)
        got["intersection_count"] = int(intersection_count(S_t, T_t))
        counter = timed("counter from_fasta", lambda: KmerCounter.from_fasta(
            19, fasta_d, "", True, device=DEVICE))
        timed("adds", lambda: [counter.add(int(x), int(v)) for x, v in adds])
        got["get"] = timed("get", lambda: [counter.get(int(x)) for x in probes])
        got["size"] = counter.size()
        got["counter set"] = timed("to_kmer_set", lambda: counter.to_kmer_set(2))
        kss = timed("get_random_kmer_set_set", lambda: get_random_kmer_set_set(
            8, LIB_SETS_M, 15, True, np.random.default_rng(LIB_SETS_SEED),
            device=DEVICE))
        timed("dump", lambda: kss.dump(os.path.join(WORK, "lib_sets_port"),
                                       "", "txt"))
        f_set = timed("get_kmer_set_from_file", lambda: get_kmer_set_from_file(
            15, dump_a, "", True, device=DEVICE))
        torch.cuda.synchronize()
        launches = _launches_since(launches0)
        for name in ("B1", "B2", "B3"):
            if launches[name] <= 0:
                raise AssertionError(f"{tag}: kernel {name} was not launched")

        # The count entries against device_count and the plain versions.
        timing = []
        for k in (15, 23, 31):
            keys, counts, n = got[k, "count"]
            want_k, want_c = backend.device_count(codes, offsets, k, True,
                                                  device=DEVICE)
            _equal(f"count_kmers k={k} keys", keys.cpu().numpy(), want_k)
            _equal(f"count_kmers k={k} counts", counts.cpu().numpy(), want_c)
            for c in LIB_CUTOFFS:
                kept, m, n_cut = got[k, c]
                keep = want_c >= c
                _equal(f"count_to_set k={k} cutoff {c}", kept.cpu().numpy(),
                       want_k[keep])
                if (m, n_cut) != (int(keep.sum()), int((~keep).sum())):
                    raise AssertionError(f"count_to_set k={k} cutoff {c}: "
                                         f"n_kept, n_cut {m}, {n_cut}")
            kernel_fns = (count_ops.pack_windows, count_ops.compact_select)
            count_ops.pack_windows = pack.canonical_windows_plain
            count_ops.compact_select = compact.compact_select_plain
            try:
                plain = count_ops.count_kmers(codes_t, valid_t[k], k, True)
                plain_sets = [count_ops.count_to_set(codes_t, valid_t[k], k,
                                                     True, c) for c in LIB_CUTOFFS]
            finally:
                count_ops.pack_windows, count_ops.compact_select = kernel_fns
            for a, b in zip(plain[:2], got[k, "count"][:2]):
                _equal(f"count_kmers k={k} against its plain version",
                       a.cpu().numpy(), b.cpu().numpy())
            for c, p in zip(LIB_CUTOFFS, plain_sets):
                _equal(f"count_to_set k={k} cutoff {c} against its plain "
                       "version", p[0].cpu().numpy(), got[k, c][0].cpu().numpy())
            # One call per CUDA-event pair (each call reads its result's
            # length on the host).
            ms = [time_ms(lambda: count_ops.count_kmers(
                codes_t, valid_t[k], k, True), 3, 1)]
            ms += [time_ms(lambda: count_ops.count_to_set(
                codes_t, valid_t[k], k, True, c), 3, 1) for c in LIB_CUTOFFS]
            ms.append(time_ms(lambda: backend.device_count(
                codes, offsets, k, True, device=DEVICE), 3, 1))
            timing.append((k, n, ms))
        for k, n, ms in timing:
            say(tag, f"k={k} ({'B1' if k <= 15 else 'B2'} + B3), "
                     f"{codes.size - k + 1} windows, {n} distinct: count_kmers "
                     f"{ms[0]:.3f} ms, count_to_set cutoff 1 {ms[1]:.3f} ms, "
                     f"cutoff 2 {ms[2]:.3f} ms (CUDA events, codes and "
                     f"validity on the card); device_count {ms[3]:.3f} ms "
                     "(its staging upload and download included); keys and "
                     "counts equal to device_count's and to the plain "
                     "versions on the card")

        # The rest against the reference's subprocess.
        out, err, ref_s = ref.wait_output(900)
        res = json.loads(out.strip().splitlines()[-1])
        rout, rsecs = res["out"], res["secs"]
        ld = lambda n: np.load(os.path.join(WORK, f"lib_ref_{n}.npy"))
        for name in ("contains", "union", "subtract", "intersection"):
            _equal(name, got[name], ld(name))
        for name, v in scalars.items():
            if v != rout[name]:
                raise AssertionError(f"{name}: {v} against the reference's "
                                     f"{rout[name]}")
        ic_ms = time_ms(lambda: intersection_count(S_t, T_t), 3, 1)
        if got["intersection_count"] != scalars["intersection_size"]:
            raise AssertionError("intersection_count on the card: "
                                 f"{got['intersection_count']}")
        ks2, n_cut = got["counter set"]
        _equal("counter kmers", counter.kmers, ld("counter_kmers"))
        _equal("counter counts", counter.counts, ld("counter_counts"))
        _equal("counter to_kmer_set(2)", ks2.kmers, ld("counter_set"))
        if (got["get"], got["size"], n_cut) != (rout["get"], rout["size"],
                                                rout["n_cut"]):
            raise AssertionError("counter get/size/n_cut differ from the "
                                 "reference's")
        port_dir = os.path.join(WORK, "lib_sets_port")
        ref_dir = os.path.join(WORK, "lib_sets_ref")
        names = sorted(os.listdir(port_dir))
        if names != sorted(os.listdir(ref_dir)):
            raise AssertionError(f"generated directories hold other files: {names}")
        _, mismatch, errors = filecmp.cmpfiles(port_dir, ref_dir, names,
                                               shallow=False)
        if mismatch or errors:
            raise AssertionError(f"generated directories differ: {mismatch + errors}")
        if [f_set.size(), f_set.hash()] != rout["file"]:
            raise AssertionError(f"get_kmer_set_from_file: {f_set.size()}, "
                                 f"{f_set.hash()} against {rout['file']}")
    finally:
        ref.kill()
    say(tag, f"set algebra on run A's set S ({S.size} k-mers) and T ({T.size}: "
             f"{half.size} of S, {new.size} new) equal to the reference's: "
             f"|S & T| {scalars['intersection_size']}, diff_count "
             f"{scalars['diff_count']}, hashes {scalars['hash']}; "
             f"intersection_count on the card {ic_ms:.3f} ms (CUDA events)")
    say(tag, f"KmerCounter of run D's reads (k = 19, {counter.kmers.size} "
             f"k-mers after {adds.shape[0]} adds) on {DEVICE}: kmers, counts, "
             f"get at {probes.size} probes, size and to_kmer_set(2) "
             f"({ks2.size()} kept, {n_cut} cut) equal to the reference's")
    say(tag, f"get_random_kmer_set_set (8 x {LIB_SETS_M} k-mers, k = 15, seed "
             f"{LIB_SETS_SEED}) on {DEVICE}: dump ({len(names)} files) "
             f"byte-identical to the reference's; get_kmer_set_from_file of "
             f"run A's dump on {DEVICE}: size {f_set.size()}, hash "
             f"{f_set.hash()}, the reference's")
    say(tag, "wall s, port / reference (the set algebra and adds on the host "
             "on both sides; the port's count, builds and decode on the card, "
             "the reference's on its host): " + ", ".join(
                 f"{n} {mine[n]:.4f} / {rsecs[n]:.4f}" for n in mine))
    say(tag, f"launches of the library calls: {launches}; reference "
             f"subprocess {ref_s:.1f} s; phase 20 took "
             f"{time.perf_counter() - t20:.1f} s")
    return {"launches": launches}


# Debug lines of the link formats: the count's downloads (ops/backend.py),
# the gap format (ops/deltas.py), the side codes (ops/unitigs.py) and the
# host succ rebuild (core/spss.py's _phase).
_LINK_LINES = {
    "keys": re.compile(r"count: keys download (\d+) B in ([\d.]+) s"),
    "counts": re.compile(r"count: counts download (\d+) B in ([\d.]+) s"),
    "deltas": re.compile(r"deltas: key download (\d+) B \(.*\) in ([\d.]+) s, "
                         r"decode ([\d.]+) s \((\d+) keys, esc (\d+), (\d+) overflows\)"),
    "rejected": re.compile(r"deltas: format rejected \((\w+)\): (.*); raw key download"),
    "sides": re.compile(r"unitigs: side codes upload ([\d.]+) s, device ([\d.]+) s, "
                        r"download ([\d.]+) s \(\d+ k-mers, (\d+) B, (\w+)\)"),
    "rebuild": re.compile(r"unitigs: succ rebuild: ([\d.]+)s"),
    "resident": re.compile(r"unitigs: device [a-z -]+ upload ([\d.]+) s.*resident\)"),
}


def _link_metrics(lines) -> dict:
    """The groups of the first line matching each _LINK_LINES pattern."""
    out = {}
    for line in lines:
        for name, pat in _LINK_LINES.items():
            m = pat.fullmatch(line) if name != "resident" else pat.search(line)
            if m and name not in out:
                out[name] = m.groups()
    return out


def _download_line(lk: dict) -> str:
    if "deltas" in lk:
        b, s, dec, n, esc, over = lk["deltas"]
        keys = (f"keys gap-encoded {b} B ({int(b) / int(n):.3f} B/key, esc {esc}, "
                f"{over} overflows) in {float(s):.4f} s, decode {float(dec):.4f} s")
    else:
        keys = f"keys raw {lk['keys'][0]} B in {float(lk['keys'][1]):.4f} s"
    line = f"{keys}; counts {lk['counts'][0]} B in {float(lk['counts'][1]):.4f} s"
    if "sides" in lk:
        _, dev_s, dl_s, nbytes, _ = lk["sides"]
        line += (f"; side codes {nbytes} B, device {float(dev_s):.4f} s, download "
                 f"{float(dl_s):.4f} s, succ rebuild on the host "
                 f"{float(lk['rebuild'][0]):.3f} s")
    return line


def _agree(what: str, got, want) -> None:
    if not np.array_equal(got, want):
        raise AssertionError(f"{what} differs from its plain version")


def check_link(torch, plan, refs, runs, S: np.ndarray, fasta_d: str) -> list:
    """Phase 21, the link formats and the resident handle on the card.
    Runs A, C, E and F again with KMERSET_TPU_LINK=slow (the gap-encoded
    key download where its plan takes the set, the side-code route of the
    canonical front-end, the handle in place of the front-end's upload),
    each dump byte-identical to the reference dump of phases 5, 6, 12 and
    16; run A must take the gap format with no rejection, and each
    canonical run must build its side codes on the resident set, with no
    upload.  Then the delta encode on run
    A's keys and the side codes against their plain versions (the same
    torch functions on the CPU copy of the input, B3's plain version
    there), the successor rebuilt from the card's side codes against the
    card's front-end, and the handle's cutoff filter on run D's counter
    (cutoff 2), each of which must launch B3 once; those launches compare
    and stay out of the kernels line, which counts B3's encode and filter
    sites in the slow-link runs and run D.  Prints each download's
    bytes and seconds, the succ rebuild and the decode, peak device
    memory beside the fast link's runs, and the pooling allocator's
    state."""
    import kmerset_tpu_torch
    from kmerset_tpu_torch.core import native
    from kmerset_tpu_torch.core.kmer_counter import KmerCounter
    from kmerset_tpu_torch.ops import deltas, unitigs

    t21 = time.perf_counter()
    tag = "21 link"
    fast_a = _link_metrics(runs[0]["lines"])
    if "resident" not in fast_a or float(fast_a["resident"][0]) != 0.0:
        raise AssertionError("run A's front-end did not take the resident set")
    say(tag, f"fast link, run A: front-end on the resident set (no upload); "
             f"{_download_line(fast_a)}")
    out = []
    for i in (0, 1, 3, 4):
        name, fasta, k, cutoff, need, extra = plan[i]
        deltas.rejections = dict.fromkeys(deltas.rejections, 0)
        deltas.downloads = 0
        run = main_path_run(
            torch, f"{tag} {name.split(maxsplit=1)[1]}", fasta, k, cutoff,
            RefDone(refs[i], runs[i]["reference_host_total_s"]), need,
            device=DEVICE, extra=extra, link="slow")
        lk = _link_metrics(run.pop("lines"))
        canonical = not extra
        if "resident" not in lk and not canonical:
            raise AssertionError(f"{name}: the directed front-end took no handle")
        if canonical and (lk.get("sides", ())[-1:] != ("resident",)
                          or float(lk["sides"][0]) != 0.0):
            raise AssertionError(f"{name}: no side codes on the resident set: {lk}")
        if i == 0 and (deltas.downloads != 1 or any(deltas.rejections.values())):
            raise AssertionError(f"run A: gap format {deltas.downloads}, "
                                 f"rejections {deltas.rejections}")
        # A plan that fits never overflows its table nor fails the decode's
        # checks on sorted unique keys: either is a fault of the encode.
        if deltas.rejections["overflow"] or deltas.rejections["integrity"]:
            raise AssertionError(f"{name}: gap format rejections {deltas.rejections}")
        n = run["size"]
        plan_k = deltas.plan_escape(n, k, canonical)
        if "deltas" in lk:
            why = f"gap format, plan {plan_k}"
        else:
            why = (f"raw keys: {lk['rejected'][0]} rejected ({lk['rejected'][1]}); "
                   f"expected overflows at esc 255 / 65535: "
                   f"{deltas.expected_overflows(n, k, canonical, 255):.4g} / "
                   f"{deltas.expected_overflows(n, k, canonical, 65535):.4g} of "
                   f"{n} keys")
        say(tag, f"{name.split(maxsplit=1)[1]} slow link: {why}; " + _download_line(lk))
        say(tag, f"{name.split(maxsplit=1)[1]}: wall {run['total_s']:.3f} s "
                 f"(fast link {runs[i]['total_s']:.3f} s), build "
                 f"{run['spss_s']:.3f} s ({runs[i]['spss_s']:.3f} s), count "
                 f"{run['count_s']:.3f} s ({runs[i]['count_s']:.3f} s); peak "
                 f"device memory {run['peak_gib']:.3f} GiB ({runs[i]['peak_gib']:.3f})")
        out.append(run)

    # The encode and the side codes against their plain versions.
    n = S.size
    esc, cap, narrow = deltas.plan_escape(n, 15, True)
    keys = torch.from_numpy(S.astype(np.int32)).to(DEVICE)
    launches0 = _launch_counts()
    got = deltas.encode(keys, n, esc, cap, narrow)
    torch.cuda.synchronize()
    enc_launches = _launches_since(launches0)["B3"]
    if enc_launches != 1:
        raise AssertionError(f"the delta encode launched B3 {enc_launches} times")
    t0 = time.perf_counter()
    want = deltas.encode(keys.cpu(), n, esc, cap, narrow)
    plain_s = time.perf_counter() - t0
    for what, g, w in zip(("gaps", "exception table"), got, want):
        _agree(f"delta encode {what}", g.cpu().numpy(), w.numpy())
    enc_ms = time_ms(lambda: deltas.encode(keys, n, esc, cap, narrow), reps=3, inner=3)
    say(tag, f"delta encode of run A's {n} keys (esc {esc}, {cap} rows, narrow "
             f"{narrow}) equal to its plain version (CPU, B3's plain version): "
             f"{enc_ms:.3f} ms on the card (CUDA events), {plain_s * 1e3:.1f} ms "
             f"on the CPU; B3 launches {enc_launches}")
    A_t = torch.from_numpy(S).to(DEVICE)
    sub = A_t[: 1 << 18]
    _agree("side codes (2^18 k-mers)", unitigs.dispatch_sides(sub, 15).cpu().numpy(),
           unitigs.dispatch_sides(sub.cpu(), 15).numpy())
    sides_ms = time_ms(lambda: unitigs.dispatch_sides(A_t, 15), reps=3, inner=2)
    sides = unitigs.dispatch_sides(A_t, 15).cpu().numpy()
    fe_log = _Capture()
    logging.getLogger(CLI_LOGGER).addHandler(fe_log)
    try:
        (succ, term_l, term_r, _), fe_s = _timed(
            torch, lambda: unitigs.device_unitig_succ(S, 15, device=DEVICE))
    finally:
        logging.getLogger(CLI_LOGGER).removeHandler(fe_log)
    fe_io = _phase_times(msg for _, msg in fe_log.records)
    t0 = time.perf_counter()
    rebuilt = native.succ_from_sides(S, sides, 15)
    rebuild_s = time.perf_counter() - t0
    _agree("succ rebuilt from the card's side codes", rebuilt, succ)
    _agree("side codes' terminal bits", (sides & 1) != 0, term_r)
    _agree("side codes' left terminal bits", (sides & 16) != 0, term_l)
    say(tag, f"side codes on the card equal to the CPU's (2^18 k-mers); run A's "
             f"set: {sides_ms:.3f} ms on the card (CUDA events), {sides.nbytes} B, "
             f"succ rebuilt on the host in {rebuild_s:.3f} s equal to the card's "
             f"front-end's (upload, device and download {fe_s:.3f} s; its "
             f"upload of the host array, which the handle saves, "
             f"{fe_io['front-end upload']:.4f} s)")

    # The handle's cutoff filter (run D, cutoff 2).
    counter = KmerCounter.from_fasta(19, fasta_d, "", True, device=DEVICE)
    launches0 = _launch_counts()
    (ks, n_cut), filt_s = _timed(torch, lambda: counter.to_kmer_set(2))
    filt_launches = _launches_since(launches0)["B3"]
    if filt_launches != 1 or ks.device is None or not ks.device.valid_for(ks.kmers, 19):
        raise AssertionError(f"run D's handle filter: {filt_launches} B3 launches, "
                             f"handle {ks.device}")
    _agree("run D's filtered handle", ks.device.graph_input().cpu().numpy(), ks.kmers)
    h = counter._device
    say(tag, f"run D's handle ({h.n} k-mers, {h.arr.nbytes + h.counts.nbytes} B "
             f"on the card) filtered at cutoff 2 on the card: {ks.device.n} kept, "
             f"equal to the host filter's set; to_kmer_set(2) {filt_s:.4f} s; "
             f"B3 launches {filt_launches}")
    pool = kmerset_tpu_torch.pool
    say(tag, f"pooling allocator: {pool.how}"
             + (f", {os.path.relpath(pool.path, ROOT)}" if pool.path else "")
             + (f", compiled in {pool.build_s:.3f} s" if pool.build_s else "")
             + (f"; stats {pool.module.stats()}" if pool.module is not None else ""))
    say(tag, f"phase 21 took {time.perf_counter() - t21:.1f} s")
    return out


# Phase 22: the build at genome scale at the card's natural memory budget.
G23_BASES = 1 << 28  # the scale of GRCh38 chr1 (248,956,422 bp)
R19_BASES = 1 << 27  # about a Drosophila melanogaster genome
R19_COVERAGE = 8.0
PLAIN_GROUP_BASES = 1 << 27  # bases per group of reads of the plain check

_COUNT_PLAN = re.compile(r"(count|decode): (\d+) windows in (\d+) chunk\(s\) of "
                         r"at most (\d+) \(ceiling (\d+), budget (\d+)\)")
_FRONT_PLAN = re.compile(r"unitigs: (one-shot|bounded), query chunk (\d+) of "
                         r"(\d+) k-mers \(ceiling (\d+), budget (\d+)\)")
_MERGED = re.compile(r"(count|decode): merged (\d+) chunk\(s\) on the host in "
                     r"([\d.]+) s \((\d+) keys\)")
_FRONT_DOWN = re.compile(r"unitigs: device front-end upload [\d.]+ s, device "
                         r"[\d.]+ s, download ([\d.]+) s of (\d+) B \(.*\)")


class _PhasePeaks(logging.Handler):
    """Device memory at the CLI's phase lines: at each line of MARKS, the
    peak allocated since the last mark and what is allocated now; the
    peak is reset there."""

    MARKS = {"constructed kmer_counter": "count", "constructed kmer_set": "filter",
             "constructed kmer_set_compact": "spss",
             "kmer_set_compact -> KmerSet: ok": "check"}

    def __init__(self, torch):
        super().__init__(logging.DEBUG)
        self.torch = torch
        self.peak, self.held = {}, {}

    def emit(self, record):
        name = self.MARKS.get(record.getMessage())
        if name:
            self.peak[name] = self.torch.cuda.max_memory_allocated()
            self.held[name] = self.torch.cuda.memory_allocated()
            self.torch.cuda.reset_peak_memory_stats()


def _max_rss_gib() -> float:
    """This process's peak resident set so far (getrusage's ru_maxrss, in
    KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


class _RssSampler(threading.Thread):
    """The largest resident set of this process seen every 50 ms
    (/proc/self/statm) while it runs: a run's own peak, where ru_maxrss
    holds the whole process's.  peak is None where statm is unreadable."""

    def __init__(self):
        super().__init__(daemon=True)
        self.peak = None
        self.done = threading.Event()
        self.page = os.sysconf("SC_PAGE_SIZE")

    def run(self):
        while True:
            try:
                with open("/proc/self/statm") as f:
                    rss = int(f.read().split()[1]) * self.page
            except (OSError, ValueError, IndexError):
                return
            self.peak = max(self.peak or 0, rss)
            if self.done.wait(0.05):
                return


def _count_plan(tag: str, k: int, plan, budgets, merges) -> str:
    """Holds a count or decode plan line (backend.count_plan's decision)
    against window_ceiling at its budget, which must be one that
    memory_budget returned in the run, and against what ran: a chunked
    plan's host merge of as many chunks, a one-shot plan's none."""
    from kmerset_tpu_torch.ops import backend

    what, w, c, x, ceiling, budget = plan[0], *map(int, plan[1:])
    want_c, want_x = (1, w) if w <= ceiling else (-(-w // ceiling), ceiling)
    ran = [int(m[1]) for m in merges if m[0] == what] or [1]
    if budget not in budgets or ceiling != backend.window_ceiling(k, budget) \
            or (c, x) != (want_c, want_x) or ran != [c]:
        raise AssertionError(f"{tag}: {what} plan {plan} is not the one of "
                             f"its budget (budgets seen {budgets}) or not "
                             f"what ran ({ran} chunk(s) merged)")
    return (f"{what} {w} windows in {c} chunk(s) of at most {x} (ceiling "
            f"{ceiling}, budget {budget} B = {budget / (1 << 30):.2f} GiB)")


def _front_plan(tag: str, n: int, plan, budgets, keep: bool) -> str:
    """Holds the front-end's plan line against front_end_plan at its
    budget, with `keep` the run's walk_route answer."""
    from kmerset_tpu_torch.ops import backend

    mode, q, m, ceiling, budget = plan[0], *map(int, plan[1:])
    if budget not in budgets or m != n or ceiling != backend.front_end_ceiling(budget) \
            or backend.front_end_plan(n, budget, keep) != (mode == "bounded", q):
        raise AssertionError(f"{tag}: front-end plan {plan} is not the one of "
                             f"its budget (budgets seen {budgets})")
    return (f"front-end {mode}, query chunk {q} of {n} k-mers ({-(-n // q)} "
            f"chunk(s); ceiling {ceiling}, budget {budget} B = "
            f"{budget / (1 << 30):.2f} GiB)")


def _line_groups(lines, group_bases: int):
    """(codes, offsets) of consecutive groups of whole records of about
    group_bases bases each."""
    lo = size = 0
    for i, line in enumerate(lines):
        size += len(line)
        if size >= group_bases or i == len(lines) - 1:
            yield _codes_of_lines(lines[lo:i + 1])
            lo, size = i + 1, 0


def plain_set(torch, fasta: str, k: int, cutoff: int):
    """The counted set of the FASTA at k and the cutoff, on the card by
    plain PyTorch and independent of the port's plan: groups of whole
    reads of PLAIN_GROUP_BASES bases, each packed (count.pack_codes),
    keyed by the plain B2 (pack.canonical_windows_plain), its windows
    that cross a fragment boundary dropped, counted by torch.unique;
    the groups' counts merged by torch.unique again.  Returns (the sorted
    keys at the cutoff, the number cut, groups)."""
    from kmerset_tpu_torch.ops import pack
    from kmerset_tpu_torch.ops.count import pack_codes

    U = C = None
    groups = 0
    for codes, offsets in _line_groups(_sequence_lines(fasta), PLAIN_GROUP_BASES):
        L = codes.size
        ct = torch.from_numpy(codes).to(DEVICE)
        keys = pack.canonical_windows_plain(pack_codes(ct), L, k, True)
        lengths = torch.from_numpy(np.diff(offsets)).to(DEVICE)
        frag = torch.repeat_interleave(
            torch.arange(lengths.numel(), device=DEVICE), lengths)
        u, c = torch.unique(keys[frag[: L - k + 1] == frag[k - 1:]],
                            return_counts=True)
        del ct, keys, frag
        if U is not None:
            u, inv = torch.unique(torch.cat([U, u]), return_inverse=True)
            c = torch.zeros_like(u).scatter_add_(0, inv, torch.cat([C, c]))
        U, C = u, c
        groups += 1
    keep = C >= cutoff
    return U[keep], int((~keep).sum()), groups


def genome_run(torch, tag: str, fasta: str, k: int, cutoff: int,
               chunked: bool) -> dict:
    """kmerset-build --check at the card's natural budget, nothing forced,
    through the CLI's main as main_path_run; its plans held against the
    budgets memory_budget returned (a spy that changes nothing); then its
    dump against plain_set on the card, and kmerset-stat's size and hash
    of the dump.  chunked: the count must run in more than one chunk."""
    from kmerset_tpu_torch.cli import kmerset_build, kmerset_stat
    from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact
    from kmerset_tpu_torch.ops import backend

    out = os.path.join(WORK, f"{tag.split()[-1]}_port.txt")
    budgets = []
    budget_of = backend.memory_budget

    def spy(device):
        budgets.append(budget_of(device))
        return budgets[-1]

    torch.cuda.empty_cache()  # a user's build starts in a process of its own
    free, total = torch.cuda.mem_get_info()
    cap, peaks = _Capture(), _PhasePeaks(torch)
    log = logging.getLogger(CLI_LOGGER)
    log.addHandler(cap)
    log.addHandler(peaks)
    backend.memory_budget = spy
    launches0, routes0 = _launch_counts(), len(_ROUTES)
    held0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rss_before = _max_rss_gib()
    sampler = _RssSampler()
    sampler.start()
    t0 = time.time()
    try:
        kmerset_build.main(["--device", DEVICE, "--k", str(k), "--cutoff",
                            str(cutoff), "--check", "--out", out, fasta])
    finally:
        backend.memory_budget = budget_of
        log.removeHandler(cap)
        log.removeHandler(peaks)
        sampler.done.set()
        sampler.join()
    t_end = time.time()
    launches = _launches_since(launches0)
    rss = _max_rss_gib()
    msgs = [m for _, m in cap.records]
    at = {m: t for t, m in cap.records}
    if "kmer_set_compact -> KmerSet: ok" not in msgs:
        raise AssertionError(f"{tag}: the port's --check did not log ok")
    for name in ("B2", "B3"):
        if launches[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched")
    mine = _logged_values(msgs)
    n = mine["kmer_set.Size()"]
    plans = [m.groups() for m in map(_COUNT_PLAN.fullmatch, msgs) if m]
    fronts = [m.groups() for m in map(_FRONT_PLAN.fullmatch, msgs) if m]
    if [p[0] for p in plans] != ["count", "decode"] or len(fronts) != 1:
        raise AssertionError(f"{tag}: plan lines {plans} {fronts}")
    merges = [m.groups() for m in map(_MERGED.fullmatch, msgs) if m]
    count_line = _count_plan(tag, k, plans[0], budgets, merges)
    c_chunks, c_chunk = int(plans[0][2]), int(plans[0][3])
    if chunked and c_chunks < 2:
        raise AssertionError(f"{tag}: the count ran in one shot: {count_line}")
    # The set is walked on the card from either mode of the front-end:
    # W1's three launches, and walk.bounded where the bounded mode ran.
    bounded = fronts[0][0] == "bounded"
    if _check_walks(tag, launches, routes0) != 1 or launches["W1"] != 3 \
            or launches[BOUNDED_WALKS] != int(bounded):
        raise AssertionError(f"{tag}: sets walked {launches}")
    front_line = _front_plan(tag, n, fronts[0], budgets, keep=True)
    decode_line = _count_plan(tag, k, plans[1], budgets, merges)
    front_msg = next(m for m in msgs if _FRONT_DOWN.fullmatch(m))
    resident = front_msg.endswith("resident)")
    # Distinct keys of the first shot (int64 at k > 15): its run heads.
    n_heads = next(int(m.group(1)) for m in map(_LINK_LINES["keys"].fullmatch, msgs)
                   if m) // 8
    say(tag, f"plans at the natural budget (mem_get_info free {free} of {total} "
             f"B before the run): {count_line}; {front_line}, "
             + ("on the count's resident set" if resident else
                "on the host array uploaded (the chunked count keeps no "
                "resident set, as the reference's)")
             + f"; check {decode_line}: each the plan of window_ceiling / "
             f"front_end_plan at a budget memory_budget returned")

    # Against the plain version on the card.
    t1 = time.perf_counter()
    plain, plain_cut, groups = plain_set(torch, fasta, k, cutoff)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t1
    comp = KmerSetCompact.load(k, out, device=DEVICE)
    decoded = torch.from_numpy(comp.kmers(True)).to(DEVICE)
    if not torch.equal(decoded, plain):
        raise AssertionError(f"{tag}: the dump's set ({decoded.numel()}) is not "
                             f"the plain set ({plain.numel()})")
    lengths = np.diff(comp.spss.offsets)
    if lengths.min() < k or int((lengths - k + 1).sum()) != plain.numel():
        raise AssertionError(f"{tag}: the strings hold {int((lengths - k + 1).sum())} "
                             f"windows for {plain.numel()} k-mers")
    h = int(np.bitwise_xor.reduce(plain.cpu().numpy())) & ((1 << 64) - 1)
    stat_out, _, stat_s = _capture_run(kmerset_stat, ["--device", DEVICE, "--k",
                                                      str(k), out])
    _, _, size, hash_ = stat_out.split("\t")
    if (int(size), int(hash_)) != (plain.numel(), h) or \
            (n, mine["kmer_set.Hash()"], mine["cutoff_count"]) != (plain.numel(), h, plain_cut):
        raise AssertionError(f"{tag}: stat {size} {hash_.strip()}, logged {mine}; "
                             f"plain {plain.numel()} {h}, {plain_cut} cut")
    del decoded, plain, comp
    say(tag, f"the dump's set, decoded on the card, torch.equal to the plain "
             f"set on the card ({groups} groups of whole reads: plain B2, "
             f"torch.unique, merged; {plain_s:.3f} s); {n} k-mers, each once "
             f"in {lengths.size} strings (sum of len - k + 1 = the size); "
             f"--check ok; kmerset-stat size {size}, hash {hash_.strip()} = the "
             f"plain set's ({stat_s:.3f} s); cutoff_count {plain_cut} = the "
             f"plain count's; {os.path.getsize(out)} bytes")

    times = {
        "count_s": at["constructed kmer_counter"] - at["constructing kmer_counter"],
        "filter_s": at["constructed kmer_set"] - at["constructing kmer_set"],
        "spss_s": at["constructed kmer_set_compact"]
        - at["constructing kmer_set_compact"],
        "check_s": at["kmer_set_compact -> KmerSet: ok"]
        - at["constructed kmer_set_compact"],
        "total_s": t_end - t0,
    }
    spss = _phase_times(msgs)
    down_s, down_b = map(float, _FRONT_DOWN.fullmatch(front_msg).groups())
    say(tag, "wall s: " + ", ".join(f"{a} {v:.3f}" for a, v in times.items())
        + "; SPSS split, s: " + ", ".join(f"{a} {v:.4f}" for a, v in spss.items())
        + f"; front-end download {int(down_b)} B in {down_s:.4f} s"
        + "".join(f"; {w} host merge of {c} chunks {float(s):.4f} s ({kk} keys)"
                  for w, c, s, kk in merges))
    q = int(fronts[0][1])
    count_b = peaks.peak["count"] - held0
    spss_b = peaks.peak["spss"] - peaks.held["filter"]
    check_b = peaks.peak["check"] - peaks.held["spss"]
    dec_w = int(plans[1][1])
    whole = backend.WALK_BYTES_PER_KMER if bounded \
        else backend.FRONT_END_BYTES_PER_KMER
    planned = whole * n + q * backend.FRONT_END_BYTES_PER_QUERY
    peak_gib = max(peaks.peak.values()) / (1 << 30)
    say(tag, f"peak device memory {peak_gib:.3f} GiB; count {count_b / (1 << 30):.3f} "
             f"GiB above the run's start, {count_b / c_chunk:.2f} B per window "
             f"of its largest shot (ceiling uses "
             f"{backend.count_bytes_per_window(k)}); SPSS build "
             f"{spss_b / (1 << 30):.3f} GiB above what the count left "
             f"({peaks.held['filter'] / (1 << 30):.3f} GiB held), "
             f"{spss_b / n:.2f} B per k-mer, within its plan's {planned / (1 << 30):.3f} "
             f"GiB ({fronts[0][0]}: {whole} B per k-mer and {backend.FRONT_END_BYTES_PER_QUERY} "
             f"per queried k-mer): past {whole} B per k-mer, "
             f"{(spss_b - whole * n) / q:.2f} B per queried k-mer; check "
             f"{check_b / max(1, dec_w):.2f} B per window; host peak RSS "
             + (f"{sampler.peak / (1 << 30):.3f} GiB (sampled every 50 ms), "
                if sampler.peak else "not sampled, ")
             + f"the process's ru_maxrss {rss_before:.3f} GiB before the run, "
             f"{rss:.3f} after; launches {launches}")
    if count_b / c_chunk > backend.count_bytes_per_window(k):
        raise AssertionError(f"{tag}: {count_b / c_chunk:.2f} B/window above the "
                             "ceiling's constant")
    if check_b / max(1, dec_w) > backend.count_bytes_per_window(k):
        raise AssertionError(f"{tag}: the check's decode took {check_b / dec_w:.2f} "
                             "B/window, above the ceiling's constant")
    if spss_b > planned:
        raise AssertionError(f"{tag}: the SPSS build took {spss_b} B above its "
                             "plan's whole-set arrays and query chunk")
    return {"launches": launches, "shot": (c_chunk, min(1.0, n_heads / c_chunk))}


def check_kernels_at_scale(torch, shapes) -> None:
    """B2 and B3 against their plain versions on the card at the shapes
    phase 22's counts launched them (shapes: (tag, k, windows) of each
    run's largest shot), each timed beside its bound: B2 canonical with
    a `valid` mask over random codes; B3 over an int64 and an int32 lane
    (the count's keys and positions) with random keep at the share of run
    heads the run had.  These launches compare: they stay out of the
    kernels line."""
    from kmerset_tpu_torch.ops import compact, pack

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 23)
    rng = np.random.default_rng(SEED + 23)
    for tag, k, n, frac in shapes:
        L, packed = _packed_input(rng, k, n)
        valid = torch.rand(n, generator=gen, device=DEVICE) > 0.01
        got = pack.canonical_windows(packed, L, k, True, valid)
        want, plain_s = _timed(torch, lambda: pack.canonical_windows_plain(
            packed, L, k, True, valid))
        if not torch.equal(got, want):
            raise AssertionError(f"B2 k={k} n={n} differs from its plain version")
        del got, want
        ms = time_ms(lambda: pack.canonical_windows(packed, L, k, True, valid), 3, 2)
        n_bytes = packed.shape[0] + n * 9
        bound, by = bound_ms(n_bytes, PACK_OPS_PER_WINDOW * n)
        say(tag, f"B2 k={k} at {n} windows equal to its plain version: kernel "
                 f"{ms:.4f} ms, bound {bound:.4f} ms ({by}), {100 * bound / ms:.1f}% "
                 f"of bound; plain {plain_s * 1e3:.1f} ms")
        del packed, valid
        keys = torch.randint(0, 1 << 62, (n,), generator=gen, device=DEVICE)
        lanes = [keys, torch.arange(n, dtype=torch.int32, device=DEVICE)]
        keep = torch.rand(n, generator=gen, device=DEVICE) < frac
        (gk, gp), n_sel = compact.compact_select(lanes, keep)
        m = int(n_sel)
        (wk, wp), plain_s = _timed(torch, lambda: [lane[keep] for lane in lanes])
        if m != wk.numel() or not (torch.equal(gk[:m], wk) and torch.equal(gp[:m], wp)):
            raise AssertionError(f"B3 n={n} differs from its plain version")
        del gk, gp, wk, wp
        ms = time_ms(lambda: compact.compact_select(lanes, keep), 3, 2)
        n_bytes = n * 13 + m * 12
        bound, by = bound_ms(n_bytes, n * (COMPACT_OPS_PER_ELEMENT
                                           + 2 * COMPACT_OPS_PER_LANE_ELEMENT))
        say(tag, f"B3 int64+int32 lanes at {n} elements, {m} kept, equal to "
                 f"lane[keep]: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                 f"{100 * bound / ms:.1f}% of bound; lane[keep] per lane "
                 f"{plain_s * 1e3:.1f} ms (one call, with its sync)")
        del keys, lanes, keep
        torch.cuda.empty_cache()


def check_genome_scale(torch, strains) -> list:
    """Phase 22: runs M19 and M23 (the multi-set CLIs at k = 19 and 23 on
    the strains of runs M and M31), then G23 (a 2^28-base genome as 10 kb
    reads, k = 23) and R19 (8x coverage in 2 kb reads of both strands of
    a 2^27-base genome, k = 19, cutoff 2) through kmerset-build at the
    card's natural memory budget (genome_run)."""
    t22 = time.perf_counter()
    runs = [run_m(torch, "22 run M19", 19, strains),
            run_m(torch, "22 run M23", 23, strains)]
    rng = np.random.default_rng(SEED + 22)
    fasta = os.path.join(WORK, "g23.fa")
    t0 = time.perf_counter()
    write_genome_fasta(fasta, rng, G23_BASES)
    say("22 G23", f"a {G23_BASES}-base genome as 10 kb reads written in "
                  f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(fasta)} B)")
    runs.append(genome_run(torch, "22 G23", fasta, 23, 1, chunked=False))
    os.remove(fasta)
    fasta = os.path.join(WORK, "r19.fa")
    t0 = time.perf_counter()
    write_reads_fasta(fasta, rng, R19_BASES, R19_COVERAGE)
    say("22 R19", f"{R19_COVERAGE:g}x coverage of a {R19_BASES}-base genome in "
                  f"2 kb reads written in {time.perf_counter() - t0:.1f} s "
                  f"({os.path.getsize(fasta)} B)")
    runs.append(genome_run(torch, "22 R19", fasta, 19, 2, chunked=True))
    os.remove(fasta)
    check_kernels_at_scale(torch, [("22 G23", 23, *runs[2]["shot"]),
                                   ("22 R19", 19, *runs[3]["shot"])])
    say("22", f"phase 22 took {time.perf_counter() - t22:.1f} s")
    return runs


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
    import kmerset_tpu_torch  # noqa: F401 - fails outside a checkout

    t_start = time.perf_counter()
    os.makedirs(WORK, exist_ok=True)
    # The CLI's log lines, at info level, on stderr; the port's SPSS phase
    # times are debug lines, kept by main_path_run's capture only.  The
    # CLI's own logger set-up leaves a logger that already has a handler
    # as it is.
    log = logging.getLogger(CLI_LOGGER)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    echo = logging.StreamHandler(sys.stderr)
    echo.setLevel(logging.INFO)
    echo.setFormatter(logging.Formatter("[%(asctime)s] %(message)s"))
    log.addHandler(echo)
    environment(torch)
    build_kernels()
    _spy_walk_routes()
    fresh_cli_process()
    rng = np.random.default_rng(SEED)
    kernels = [
        check_pack(torch, rng, "B1", range(1, 16), (15,)),
        check_pack(torch, rng, "B2", range(16, 32), (31, 23, 19)),
        check_compact(torch, rng),
    ]
    check_front_end(torch, rng)
    # Its own generator: the later phases' inputs do not depend on it.
    kernels.append(check_walk(torch, np.random.default_rng(SEED + 4)))
    kernels.append(check_overlap(torch, np.random.default_rng(SEED + 5)))
    kernels.append(check_parse(torch, np.random.default_rng(SEED + 6)))

    fasta_a = os.path.join(WORK, "genome.fa")
    write_genome_fasta(fasta_a, rng, 1 << 24)
    fasta_d = os.path.join(WORK, "reads.fa")
    write_reads_fasta(fasta_d, rng, 1 << 22, 3.0)
    plan = (("5 run A", fasta_a, 15, 1, ("B1", "B3"), ()),
            ("6 run C", fasta_a, 23, 1, ("B2", "B3"), ()),
            ("7 run D", fasta_d, 19, 2, ("B2", "B3"), ()),
            ("12 run E", fasta_a, 31, 1, ("B2", "B3"), ()),
            ("16 run F", fasta_a, 15, 1, ("B1", "B3"), ("--canonical=false",)))
    refs = [RefRun(tag.split()[-1], fasta, k, cutoff, extra)
            for tag, fasta, k, cutoff, _, extra in plan]
    try:
        runs = [main_path_run(torch, tag, fasta, k, cutoff, ref, need,
                              extra=extra)
                for (tag, fasta, k, cutoff, need, extra), ref in zip(plan, refs)]
    finally:
        for ref in refs:
            ref.kill()

    # The mesh: runs A, C and E through the CLI on 4 shards of cuda:0,
    # against the same reference dumps; over distinct cards where there
    # are several.
    lists = [",".join(["cuda:0"] * 4)]
    n_gpus = torch.cuda.device_count()
    if n_gpus >= 2:
        lists.append(",".join(f"cuda:{i}" for i in range(n_gpus)))
    else:
        say("17 mesh", "one GPU visible: the mesh over distinct cards (runs A, "
                       "C, E on cuda:0,cuda:1,...) was not run")
    for devices in lists:
        for i in (0, 1, 3):
            tag, fasta, k, cutoff, need, _ = plan[i]
            runs.append(main_path_run(
                torch, f"17 mesh {tag.split(maxsplit=1)[1]}", fasta, k, cutoff,
                RefDone(refs[i], runs[i]["reference_host_total_s"]), need,
                device=devices))

    sets = check_out_of_core(torch, fasta_a,
                             os.path.join(WORK, f"{plan[1][0]}_port.txt"),
                             {15: runs[0]["size"], 23: runs[1]["size"],
                              31: runs[3]["size"]})
    check_mesh_programs(torch, fasta_a, sets)
    # Its own generator: the later phases' inputs do not depend on it.
    check_mesh_multiset(torch, np.random.default_rng(SEED + 14), sets["run A"], 15)
    time_mesh_graph(torch, sets["run A"], 15)
    check_sketch(torch, rng)
    strains = write_strains(rng)
    m15 = run_m(torch, "11 run M", 15, strains)
    m31 = run_m(torch, "13 run M31", 31, strains)
    runs += [m15, m31]
    # Runs M and M31 again on 4 shards of cuda:0, against the same
    # reference outputs; over distinct cards where there are several.
    if n_gpus < 2:
        say("18 mesh", "one GPU visible: runs M and M31 over distinct cards "
                       "(cuda:0,cuda:1,...) were not run")
    for devices in lists:
        runs.append(run_m_mesh(torch, "18 mesh run M", 15, m15, devices))
        runs.append(run_m_mesh(torch, "18 mesh run M31", 31, m31, devices))

    # A process group of two ranks sharing cuda:0 (3 shards, uneven):
    # runs A and C and run M's compress, beside the single-process 3-shard
    # mesh; then run C in a one-rank group on NCCL, and over one rank per
    # card where there are several.
    t19 = time.perf_counter()
    torch.cuda.empty_cache()  # the ranks plan with the card's free memory
    shared = ("cuda:0,cuda:0", "cuda:0")
    gloo_line = ("mesh: 3 shards over 2 processes, cuda:0 shared by 2 ranks: "
                 "exchanges through the host (gloo)")
    for i in (0, 1):
        tag, fasta, k, _, need, _ = plan[i]
        three = main_path_run(
            torch, f"19 group {tag.split(maxsplit=1)[1]} 3 shards", fasta, k, 1,
            RefDone(refs[i], runs[i]["reference_host_total_s"]), need,
            device=",".join(["cuda:0"] * 3))
        runs.append(three)
        runs.append(group_build(f"19 group {tag.split(maxsplit=1)[1]}",
                                fasta, k, refs[i], need, shared, gloo_line,
                                runs[i]["total_s"], three))
    three = run_m_mesh(torch, "19 group run M 3 shards", 15, m15,
                       ",".join(["cuda:0"] * 3))
    runs.append(three)
    three["serial_s"] = serial_compress(m15, ",".join(["cuda:0"] * 3))
    runs.append(group_compress("19 group run M", m15, shared, gloo_line,
                               three))
    runs.append(group_build(
        "19 group run C nccl", fasta_a, 23, refs[1], ("B2", "B3"),
        ("cuda:0,cuda:0",), "mesh: 2 shards over 1 processes, each card held "
        "by one rank: exchanges on the cards (NCCL)", runs[1]["total_s"], None))
    if n_gpus >= 2:
        runs.append(group_build(
            "19 group run C cards", fasta_a, 23, refs[1], ("B2", "B3"),
            tuple(f"cuda:{i}" for i in range(n_gpus)),
            f"mesh: {n_gpus} shards over {n_gpus} processes, each card held by "
            "one rank: exchanges on the cards (NCCL)", runs[1]["total_s"], None))
    else:
        say("19 group", "one GPU visible: run C over one rank per card (NCCL "
                        "across distinct cards) was not run")
    say("19 group", f"phase 19 took {time.perf_counter() - t19:.1f} s")
    runs.append(check_library(torch, np.random.default_rng(SEED + 20), fasta_a,
                              fasta_d, sets["run A"],
                              os.path.join(WORK, f"{plan[0][0]}_port.txt")))
    runs += check_link(torch, plan, refs, runs, sets["run A"], fasta_d)
    runs += check_genome_scale(torch, strains)

    for kern in kernels:
        name = kern["name"].split()[0]
        kern["launches"] = sum(run["launches"][name] for run in runs)
        if kern["launches"] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the runs")
    walks = {w: sum(run["launches"][w] for run in runs)
             for w in (*WALKS, BOUNDED_WALKS)}
    if "jax" in sys.modules:
        raise AssertionError("jax was imported during the port's run")
    ref_mods = [m for m in sys.modules
                if m == "kmerset_tpu" or m.startswith("kmerset_tpu.")]
    if ref_mods:
        raise AssertionError(f"the JAX package was imported: {ref_mods}")
    say(8, "launch counts over runs A, C, D, E, F, M and M31, their mesh "
           "runs, the process-group runs' ranks, phase 20's library calls, "
           "phase 21's slow-link runs and phase 22's runs M19, M23, G23 and "
           "R19: " + ", ".join(
        f"{k['name'].split()[0]} {k['launches']}" for k in kernels)
        + "; sets walked " + ", ".join(f"{w} {v}" for w, v in walks.items())
        + "; neither jax nor kmerset_tpu in sys.modules; "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
