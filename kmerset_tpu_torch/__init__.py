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
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


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
