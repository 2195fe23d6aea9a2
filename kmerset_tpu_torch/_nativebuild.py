"""Best-effort on-demand build of the native layer (native/Makefile).

The port's copy of kmerset_tpu/_nativebuild.py:1-80 (ensure_built), and
the port's own serial edition of the same library (build_serial).  Both
packages build and load the same C source, native/kmerio.c at the root
of the checkout, which belongs to neither.

The serial edition: native/Makefile forces -fopenmp, and a machine whose
compiler has no OpenMP runtime cannot build native/libkmerio.so.
kmerio.c guards its OpenMP calls with #ifdef _OPENMP, so the same source
built without -fopenmp is the same code on one thread, linked against
libc alone; --workers (kmerio_set_threads) does nothing in it.
build_serial compiles it into build/kmerset_tpu_torch/ at the root of
the checkout (git-ignored), named by a hash of kmerio.c and the flags,
once per process and under a file lock, as ops/_build.py builds the
kernels.  core/native.py loads it when native/libkmerio.so is missing
or does not load.

The pooling NumPy allocator (native/pool_alloc.c, a CPython extension
that kmerset_tpu_torch/__init__.py installs): build_pool compiles it the
same way, without OpenMP, against the running interpreter's and numpy's
headers, into the same directory, where the checkout's
native/kmerset_pool<EXT_SUFFIX> (built by `make -C native`, which forces
-fopenmp) is missing or does not load.

The dump's text codec (kmerset_tpu_torch/csrc/lines.c, the port's own
source): build_lines compiles it the same way, without OpenMP, into the
same directory, and core/native.py loads it apart from libkmerio, whose
source and ABI the two packages share.

The reference ships its native code through a CMake build the user runs
explicitly (reference: CMakeLists.txt:41-50, README.md:196-205).  Here the
native layer is an *optional accelerator*: every caller has a complete
NumPy/JAX fallback, so a missing library must never fail — but a fresh
checkout silently running 10-50x slower (and, worse, exercising different
code paths than CI) is a trap.  This module closes it: when the shared
library is missing or older than its C source, it runs `make -C native
<target>` once, serialized across processes with an exclusive file lock,
and stays silent on any failure.  A failed `make` is recorded in
build/kmerset_tpu_torch/, so that later processes go straight to the
serial edition until the Makefile, the source or the compiler changes.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional, Sequence, Tuple

_ATTEMPTED: set = set()
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "kmerset_tpu_torch",
)
SERIAL_FLAGS = ["-O3", "-fPIC", "-shared", "-Wno-unknown-pragmas"]
POOL_FLAGS = ["-O3", "-fPIC", "-shared"]
LINES_FLAGS = ["-O3", "-fPIC", "-shared"]
# The results in this process of build_serial ("result"), build_pool
# ("pool") and build_lines ("lines"): (path or None, compile seconds).
_SERIAL: dict = {}


def _native_dir() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "native")


def _lines_source() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "lines.c")


def ensure_built(target: str, sources: Sequence[str]) -> None:
    """Builds `native/<target>` from `sources` if missing/stale.

    Silent best-effort: no toolchain, read-only checkout, concurrent
    builds, and build errors all degrade to "library unavailable", which
    every caller already handles.  At most one attempt per process per
    target (the pytest suite and the CLIs spawn many subprocesses; each
    re-checks mtimes cheaply and only the first stale one pays the make),
    and none after a recorded failure (_make_failed_path).
    """
    if target in _ATTEMPTED or os.environ.get("KMERSET_TPU_NO_AUTOBUILD"):
        return
    _ATTEMPTED.add(target)
    ndir = _native_dir()
    srcs = [os.path.join(ndir, s) for s in sources]
    if not os.path.isfile(os.path.join(ndir, "Makefile")):
        return
    if not all(os.path.isfile(s) for s in srcs):
        return

    def _stale() -> bool:
        try:
            t_tgt = os.path.getmtime(os.path.join(ndir, target))
        except OSError:
            return True
        return any(os.path.getmtime(s) > t_tgt for s in srcs)

    if not _stale():
        return
    failed = _make_failed_path(target, srcs)
    if failed is None or os.path.exists(failed):
        return
    lock_path = os.path.join(ndir, ".build.lock")
    try:
        import fcntl

        with open(lock_path, "a+") as fh:
            fcntl.flock(fh, fcntl.LOCK_EX)
            if not _stale():  # another process built it while we waited
                return
            import sys

            # PY pins the Makefile's EXT_SUFFIX / header paths to the
            # *running* interpreter — PATH python3 may be a different
            # version, which would build a wrongly-suffixed (or
            # wrongly-headered) extension.
            subprocess.run(
                ["make", "-C", ndir, target, f"PY={sys.executable}"],
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                timeout=300,
                check=False,
            )
            if _stale():
                os.makedirs(BUILD_DIR, exist_ok=True)
                open(failed, "w").close()
    except Exception:  # noqa: BLE001 - the fallback paths are complete
        pass


def _make_failed_path(target: str, srcs: Sequence[str]) -> Optional[str]:
    """The file that records a failed `make` of `target`, named by a hash
    of the Makefile, the sources and the compiler (`$CC`, else `cc`: its
    path, size and mtime), so that a later process skips the same doomed
    build (the OpenMP build where the compiler has no OpenMP runtime,
    several seconds) and tries again only when one of them changes.
    Delete build/kmerset_tpu_torch/ to try again after installing a
    runtime.  None when a file cannot be read."""
    h = hashlib.sha256(target.encode())
    try:
        for path in (os.path.join(_native_dir(), "Makefile"), *srcs):
            with open(path, "rb") as f:
                h.update(f.read())
        cc = shutil.which(os.environ.get("CC") or "cc")
        if cc is not None:
            st = os.stat(cc)
            h.update(f"{os.path.realpath(cc)} {st.st_size} {st.st_mtime_ns}".encode())
    except OSError:
        return None
    return os.path.join(BUILD_DIR, f"make_failed_{h.hexdigest()[:16]}")


def serial_library_path() -> str:
    """Where the serial edition of the current native/kmerio.c lives."""
    h = hashlib.sha256(" ".join(SERIAL_FLAGS).encode())
    with open(os.path.join(_native_dir(), "kmerio.c"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkmerio_serial_{h.hexdigest()[:16]}.so")


def build_serial() -> Tuple[Optional[str], Optional[float]]:
    """(path, compile seconds) of the serial edition, compiled first if
    it is not there: seconds is None when it was already built.  (None,
    None) when there is no kmerio.c, no C compiler (`$CC`, else `cc`) or
    the compile fails; the callers then take their numpy paths.  One
    attempt per process."""
    if "result" not in _SERIAL:
        try:
            out = serial_library_path()
        except OSError:  # no native/kmerio.c
            out = None
        _SERIAL["result"] = _compile_once(
            out, os.path.join(_native_dir(), "kmerio.c"), SERIAL_FLAGS)
    return _SERIAL["result"]


def _pool_flags() -> Optional[list]:
    """POOL_FLAGS with the running interpreter's and numpy's include
    directories, or None when they cannot be found."""
    import sysconfig

    try:
        import numpy

        return POOL_FLAGS + [f"-I{sysconfig.get_paths()['include']}",
                             f"-I{numpy.get_include()}"]
    except (ImportError, KeyError):
        return None


def pool_library_path(flags) -> str:
    """Where build_pool puts the pooling allocator of the current
    native/pool_alloc.c built with `flags` (_pool_flags)."""
    import sysconfig

    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    h = hashlib.sha256(" ".join(flags).encode())
    with open(os.path.join(_native_dir(), "pool_alloc.c"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"kmerset_pool_{h.hexdigest()[:16]}{suffix}")


def build_pool() -> Tuple[Optional[str], Optional[float]]:
    """(path, compile seconds) of the pooling allocator extension,
    compiled as build_serial compiles the library: (None, None) when
    there is no pool_alloc.c, no headers, no compiler or the compile
    fails (no Python.h, say).  One attempt per process."""
    if "pool" not in _SERIAL:
        flags = _pool_flags()
        try:
            out = pool_library_path(flags) if flags is not None else None
        except OSError:  # no native/pool_alloc.c
            out = None
        _SERIAL["pool"] = _compile_once(
            out, os.path.join(_native_dir(), "pool_alloc.c"), flags)
    return _SERIAL["pool"]


def lines_library_path() -> str:
    """Where build_lines puts the text codec of the current csrc/lines.c."""
    h = hashlib.sha256(" ".join(LINES_FLAGS).encode())
    with open(_lines_source(), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"liblines_{h.hexdigest()[:16]}.so")


def build_lines() -> Tuple[Optional[str], Optional[float]]:
    """(path, compile seconds) of the dump's text codec, compiled as
    build_serial compiles the library: (None, None) when there is no
    lines.c, no compiler or the compile fails.  One attempt per process."""
    if "lines" not in _SERIAL:
        try:
            out = lines_library_path()
        except OSError:  # no csrc/lines.c
            out = None
        _SERIAL["lines"] = _compile_once(out, _lines_source(), LINES_FLAGS)
    return _SERIAL["lines"]


def _compile_once(out: Optional[str], source: str, flags) -> Tuple[Optional[str], Optional[float]]:
    """Compiles the C file `source` with `flags` into `out` unless it is
    there, under a file lock in BUILD_DIR: (out, seconds), seconds None
    when it was already built; (None, None) without `out`, with
    KMERSET_TPU_NO_AUTOBUILD set, or when the compile fails."""
    if out is None or os.environ.get("KMERSET_TPU_NO_AUTOBUILD"):
        return None, None
    if os.path.isfile(out):
        return out, None
    try:
        import fcntl

        os.makedirs(BUILD_DIR, exist_ok=True)
        with open(os.path.join(BUILD_DIR, ".native.lock"), "a+") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.isfile(out):  # built while we waited
                return out, None
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [os.environ.get("CC") or "cc", *flags, "-o", tmp, source],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=300, check=False,
            )
            if proc.returncode != 0:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                return None, None
            os.replace(tmp, out)
            return out, time.perf_counter() - t0
    except (OSError, subprocess.SubprocessError):  # no compiler, no disk
        return None, None
