"""kmerset_tpu_torch — the PyTorch/CUDA edition of the k-mer set engine.

A second package beside `kmerset_tpu` (the JAX/Pallas reference).  The
device layer is PyTorch plus hand-written CUDA kernels for Hopper
(`csrc/*.cu`, built on first use by `ops/_build.py`).  The host layer
(FASTA parsing, the ctypes bindings of the native C library, the SPSS
chain walk and path cover, set types, file formats, CLI plumbing) is the
port's own copy of the reference's host code, without its JAX routers
(the mesh of shards, `parallel/`, is reached through an explicit
`Mesh`): no module of this package imports `jax` or `kmerset_tpu`, and
nothing here reads the reference's backend switches.  Module names follow
the reference so that each counterpart can be found by path, and each
copy names the lines it copies.  Both packages load the same C library,
`native/libkmerio.so` at the root of the checkout, built from
`native/kmerio.c` on first use.  In this package "the reference" is
`kmerset_tpu`; citations of the form "reference: lib/..." in the copied
code point to the original C++ project, as they do there.

The device is always explicit: every entry point takes a `device`, and a
request for CUDA where none is present raises instead of running on the
CPU.

At import the package installs the pooling NumPy data allocator of
native/pool_alloc.c, as the reference does (kmerset_tpu/__init__.py:
28-59); `pool` says how that went.
"""

from __future__ import annotations

import os
import sys
from typing import NamedTuple, Optional

import torch

__version__ = "0.1.0"


class Pool(NamedTuple):
    """How the pooling allocator was installed at import: `how` is
    "checkout" (native/kmerset_pool<EXT_SUFFIX>), "built" (the port's
    build of native/pool_alloc.c, build_s its compile seconds, None when
    an earlier process built it), "present" (a kmerset_pool module was
    already imported, as the reference's import installs it), "off"
    (KMERSET_TPU_POOL=0) or "unavailable" (it neither loads nor builds);
    `module` is the extension (its stats() counts pool hits), or None."""

    how: str
    path: Optional[str]
    build_s: Optional[float]
    module: object


def _load_pool(path: str):
    """The kmerset_pool extension at `path`, or None when it does not
    load (a file for another interpreter or numpy, say)."""
    import importlib.util

    try:
        spec = importlib.util.spec_from_file_location("kmerset_pool", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    except (ImportError, OSError):
        return None
    return mod


def _install_pool_allocator() -> Pool:
    """Installs the pooling NumPy data allocator (native/pool_alloc.c), the
    counterpart of the original project's mimalloc link (reference
    kmerset_tpu/__init__.py:28-59): large NumPy temporaries reuse warm
    pages instead of fresh ones from the OS.  It takes the checkout's
    native/kmerset_pool<EXT_SUFFIX> where that loads, else compiles
    pool_alloc.c without OpenMP into build/ (_nativebuild.build_pool;
    native/Makefile forces -fopenmp, which a compiler without an OpenMP
    runtime refuses).  It installs nothing when a kmerset_pool module is
    already imported (one pool per process) or KMERSET_TPU_POOL=0, and,
    like the reference, skips quietly when the extension neither loads
    nor builds: it is a host allocator, neither the device nor a
    kernel."""
    if os.environ.get("KMERSET_TPU_POOL", "1") == "0":
        return Pool("off", None, None, None)
    present = sys.modules.get("kmerset_pool")
    if present is not None:
        return Pool("present", getattr(present, "__file__", None), None, present)
    import sysconfig

    from ._nativebuild import _native_dir, build_pool

    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    checkout = os.path.join(_native_dir(), "kmerset_pool" + suffix)
    how, path, secs = "checkout", checkout, None
    mod = _load_pool(checkout) if os.path.isfile(checkout) else None
    if mod is None:
        how, (path, secs) = "built", build_pool()
        mod = _load_pool(path) if path is not None else None
    if mod is None:
        return Pool("unavailable", None, None, None)
    mod.install()
    sys.modules["kmerset_pool"] = mod
    return Pool(how, path, secs, mod)


def resolve_device(name) -> torch.device:
    """`name` ("cuda", "cuda:0", "cpu" or a torch.device) as a
    torch.device.  Raises when CUDA is asked for and not available: the
    port never continues on the CPU in its place."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is False"
            )
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but "
                f"{torch.cuda.device_count()} CUDA devices are visible"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use cuda or cpu)")
    return dev


pool = _install_pool_allocator()
