"""Kernel B1: canonical window keys for k <= 15 (csrc/pack.cu).

Counterpart of kmerset_tpu/ops/pallas_pack.py:canonical_windows_pallas and
of the XLA roll formulation in kmerset_tpu/ops/count.py (_pack_contig,
_pack_span_rc, _single_windows).  The kernel also fuses two neighbours of
the reference pipeline: it reads the 2-bit packed upload (the reference
unpacks it first, count.py:_unpack2) and writes the sort sentinel where a
window is invalid (count.py:257).  `unpack2` below is the plain form of
that unpack.
"""

from __future__ import annotations

from typing import Optional

import torch

S_SENT = (1 << 31) - 1  # reference ops/count.py _S_SENT
MAX_K = 15  # 2k <= 30 bits: one non-negative int32 key

# Kernel launches since the last reset (plain integer; a run sets it to 0
# and reads it to show its main path went through the kernel).
launches = 0


def unpack2(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(ceil(L/4),) uint8 packed 4 codes/byte, low bits first (the
    native kmerio_pack2 layout) -> (L,) int32 base codes."""
    four = torch.stack(
        [packed & 3, (packed >> 2) & 3, (packed >> 4) & 3, (packed >> 6) & 3],
        dim=1,
    )
    return four.reshape(-1)[:L].to(torch.int32)


def canonical_windows_plain(
    packed: torch.Tensor, L: int, k: int, canonical: bool = True,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch B1: a direct k-step loop over shifted code slices."""
    codes = unpack2(packed, L)
    n = L - k + 1
    fwd = torch.zeros(n, dtype=torch.int32, device=packed.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[j : j + n]
        fwd = (fwd << 2) | c
        rc = rc | ((3 - c) << (2 * j))
    key = torch.minimum(fwd, rc) if canonical else fwd
    if valid is not None:
        key = torch.where(valid, key, torch.full_like(key, S_SENT))
    return key


def _check(packed, L, k, valid) -> int:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pack kernel takes 1 <= k <= {MAX_K}, got {k}")
    if packed.dtype != torch.uint8 or packed.dim() != 1:
        raise TypeError("packed must be a 1-D uint8 tensor")
    if not packed.is_contiguous():
        raise ValueError("packed must be contiguous")
    if packed.shape[0] != (L + 3) // 4:
        raise ValueError(
            f"packed holds {packed.shape[0]} bytes; L={L} needs {(L + 3) // 4}"
        )
    n = L - k + 1
    if n <= 0:
        raise ValueError(f"L={L} holds no window of k={k}")
    if n > (1 << 31) - 1:
        raise ValueError(f"{n} windows exceed the int32 index range")
    if valid is not None:
        if valid.dtype != torch.bool or valid.shape != (n,):
            raise TypeError(f"valid must be a ({n},) bool tensor")
        if valid.device != packed.device or not valid.is_contiguous():
            raise ValueError("valid must be contiguous and on packed's device")
    return n


def canonical_windows(
    packed: torch.Tensor, L: int, k: int, canonical: bool = True,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(L - k + 1,) int32 window keys of the L codes in `packed`: the
    canonical min(fwd, rc) (fwd alone if not `canonical`), with S_SENT
    where `valid` (optional, one bool per window) is False.

    A CUDA tensor runs kernel B1; a CPU tensor runs the plain version."""
    n = _check(packed, L, k, valid)
    if packed.device.type == "cpu":
        return canonical_windows_plain(packed, L, k, canonical, valid)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    from . import _build

    lib = _build.load()
    out = torch.empty(n, dtype=torch.int32, device=packed.device)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.kmerset_pack_canonical(
            packed.data_ptr(), L, k, int(canonical),
            valid.data_ptr() if valid is not None else None,
            out.data_ptr(), n, stream,
        )
    _build.check(lib, err, "pack kernel")
    global launches
    launches += 1
    return out
