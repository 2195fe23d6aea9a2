"""Builds the port's CUDA kernels (`kmerset_tpu_torch/csrc/*.cu`) at first
use and loads them with ctypes.

One `nvcc` per source compiles it for Hopper (`sm_90a`), all started
together, and one more links the objects into a shared library with a
plain C interface; no PyTorch header is included, so the build takes
seconds.  The library lands in `build/kmerset_tpu_torch/` at
the root of the checkout (git-ignored), named by a hash of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused.  A
file lock serialises concurrent builds.

Unlike the reference's best-effort native build (kmerset_tpu/_nativebuild.py),
a failed build raises: the wrappers have no host fallback for a CUDA
tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kmerset_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _sources() -> list:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
        "CUDA kernels are built from source at first use"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkmerset_kernels_{h.hexdigest()[:16]}.so")


def _compile(out: str) -> None:
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".build.lock"), "a+") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(out):  # another process built it while we waited
            return
        tmp = f"{out}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in _sources()]
        compiles = [
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            for src, obj in zip(_sources(), objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for cmd in compiles
        ]
        steps = [(cmd, *_finish(p)) for cmd, p in zip(compiles, procs)]
        if all(rc == 0 for _, rc, _ in steps):
            link = [nvcc, "-shared", "-o", tmp, *objs]
            steps.append((link, *_finish(subprocess.Popen(
                link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))))
        text = "".join(" ".join(cmd) + "\n" + o for cmd, _, o in steps)
        with open(out[: -len(".so")] + ".log", "w") as log:
            log.write(text)
        for f in objs:
            if os.path.exists(f):
                os.unlink(f)
        failed = [rc for _, rc, _ in steps if rc != 0]
        if failed:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed with exit code {failed[0]}:\n{text}"
            )
        os.replace(tmp, out)


def _finish(proc: subprocess.Popen):
    """(exit code, output) of a compiler process, killed after 900 s."""
    try:
        out, _ = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return proc.returncode, out


def build_log() -> str:
    """The compiler's output (ptxas register and shared-memory report) of
    the current library's build, or '' when it was built elsewhere."""
    path = library_path()[: -len(".so")] + ".log"
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

# Every extern "C" entry of csrc/*.cu: (argument types, result type).
SIGNATURES = {
    # packed, L, k, canonical, valid, out, n_out, stream
    "kmerset_pack_canonical": ([_P, _I64, _I32, _I32, _P, _P, _I64, _P], _I32),
    "kmerset_pack_canonical64": ([_P, _I64, _I32, _I32, _P, _P, _I64, _P], _I32),
    # src0-2, dst0-2, width0-2, n_lanes, keep, n, scratch, scratch_words,
    # n_sel, stream
    "kmerset_compact": ([_P] * 6 + [_I32] * 4 + [_P, _I64, _P, _I64, _P, _P], _I32),
    # succ, n_nodes, starts, ns, ends, lens, bad, stream
    "kmerset_walk_measure": ([_P, _I64, _P, _I64, _P, _P, _P, _P], _I32),
    # A, starts, ns, n_right, ends, lens, k, bad, rank, kept, before,
    # batch_count, batch_bytes, stream
    "kmerset_walk_rank": ([_P, _P, _I64, _I64, _P, _P, _I32] + [_P] * 7, _I32),
    # A, succ, n_nodes, k, ns, rank, kept, lens, before, batch_first,
    # batch_at, iso, n_iso, n_chains, chain_bytes, codes, offsets, covered,
    # bad, stream
    "kmerset_walk_emit": ([_P, _P, _I64, _I32, _I64] + [_P] * 7 + [_I64] * 3
                          + [_P] * 5, _I32),
    # P, S, n, k, p_keys, p_ord, s_keys, s_ord, counts, stream
    "kmerset_overlap_count": ([_P, _P, _I64, _I32] + [_P] * 6, _I32),
    # P, S, n, k, p_keys, p_ord, s_keys, s_ord, ends, m, out, stream
    "kmerset_overlap_fill": ([_P, _P, _I64, _I32] + [_P] * 5 + [_I64, _P, _P],
                             _I32),
    # buf, n, codes, ends, scratch, scratch_words, info, stream
    "kmerset_parse_fasta": ([_P, _I64, _P, _P, _P, _I64, _P, _P], _I32),
    # codes, L, out, stream
    "kmerset_pack_codes": ([_P, _I64, _P, _P], _I32),
    "kmerset_error_string": ([_I32], ctypes.c_char_p),
}


def _bind(lib: ctypes.CDLL) -> None:
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def load() -> ctypes.CDLL:
    """The kernels' library, built first if needed.  Raises on any build
    or load failure."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not os.path.isfile(path):
                _compile(path)
            lib = ctypes.CDLL(path)
            _bind(lib)
            _LIB = lib
        return _LIB


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raises if a kernel entry returned a CUDA error (its launch was
    refused, or an earlier asynchronous fault surfaced)."""
    if err != 0:
        msg = lib.kmerset_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
