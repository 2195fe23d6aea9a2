"""Best-effort on-demand build of the native layer (native/Makefile).

The port's copy of kmerset_tpu/_nativebuild.py:1-80, unchanged but for
this paragraph: both packages build and load the same C library,
native/kmerio.c at the root of the checkout, which belongs to neither.

The reference ships its native code through a CMake build the user runs
explicitly (reference: CMakeLists.txt:41-50, README.md:196-205).  Here the
native layer is an *optional accelerator*: every caller has a complete
NumPy/JAX fallback, so a missing library must never fail — but a fresh
checkout silently running 10-50x slower (and, worse, exercising different
code paths than CI) is a trap.  This module closes it: when the shared
library is missing or older than its C source, it runs `make -C native
<target>` once, serialized across processes with an exclusive file lock,
and stays silent on any failure.
"""

from __future__ import annotations

import os
import subprocess
from typing import Sequence

_ATTEMPTED: set = set()


def _native_dir() -> str:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(here, "native")


def ensure_built(target: str, sources: Sequence[str]) -> None:
    """Builds `native/<target>` from `sources` if missing/stale.

    Silent best-effort: no toolchain, read-only checkout, concurrent
    builds, and build errors all degrade to "library unavailable", which
    every caller already handles.  At most one attempt per process per
    target (the pytest suite and the CLIs spawn many subprocesses; each
    re-checks mtimes cheaply and only the first stale one pays the make).
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
    except Exception:  # noqa: BLE001 - the fallback paths are complete
        pass
