"""kmerset_tpu_torch — the PyTorch/CUDA edition of the k-mer set engine.

A second package beside `kmerset_tpu` (the JAX/Pallas reference).  The
device layer is PyTorch plus hand-written CUDA kernels for Hopper
(`csrc/*.cu`, built on first use by `ops/_build.py`); the host layer (FASTA
parsing, the native C runtime, the SPSS build, set types, file formats) is
the reference package's own JAX-free code, imported and never copied or
patched.  Module names follow the reference so that each counterpart can
be found by path.

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
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use cuda or cpu)")
    return dev
