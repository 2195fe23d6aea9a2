"""Kernels B1 (k <= 15) and B2 (15 < k <= 31): canonical window keys
(csrc/pack.cu).

Counterpart of kmerset_tpu/ops/pallas_pack.py:canonical_windows_pallas
(B1) and canonical_windows_pair_pallas (B2), and of the XLA roll
formulation in kmerset_tpu/ops/count.py (_pack_contig, _pack_span_rc,
_single_windows, _pair_windows, _int64_windows).  B1 writes one int32 key
per window.  B2 writes one int64 key: for k <= 23 it is (hi << 2*klo) |
lo, where the TPU kernel writes the (hi, lo) int32 lanes (the reference
combines them that way itself, count.py:canonical_windows, and the int64
order is the lanes' lexicographic order); for 23 < k <= 31 it is the
reference's XLA int64 key (_int64_windows), which no Pallas kernel
computes.  Both are the same 2k-bit number.  The kernels also fuse two
neighbours of the
reference pipeline: they read the 2-bit packed upload (the reference
unpacks it first, count.py:_unpack2) and write the sort sentinel where a
window is invalid (count.py:257, 269).  `unpack2` below is the plain form
of that unpack.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import trace

S_SENT = (1 << 31) - 1  # reference ops/count.py _S_SENT (int32 keys)
SENTINEL = 1 << 62  # reference ops/count.py SENTINEL (int64 keys)
SINGLE_MAX_K = 15  # 2k <= 30 bits: one non-negative int32 key (B1)
MAX_K = 31  # 2k <= 62 bits: one int64 key below SENTINEL (B2)


def key_dtype(k: int) -> torch.dtype:
    """The window keys' dtype at k: int32 through SINGLE_MAX_K, else int64."""
    return torch.int32 if k <= SINGLE_MAX_K else torch.int64


def key_sentinel(k: int) -> int:
    """The sort sentinel of invalid windows at k (sorts after every key)."""
    return S_SENT if k <= SINGLE_MAX_K else SENTINEL


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
    """Plain PyTorch B1/B2: a direct k-step loop over shifted code slices,
    on int32 through SINGLE_MAX_K and on int64 above.  Every operand is
    non-negative, so no shift sees a sign bit."""
    codes = unpack2(packed, L).to(key_dtype(k))
    n = L - k + 1
    fwd = torch.zeros(n, dtype=codes.dtype, device=packed.device)
    rc = torch.zeros_like(fwd)
    for j in range(k):
        c = codes[j : j + n]
        fwd = (fwd << 2) | c
        rc = rc | ((3 - c) << (2 * j))
    key = torch.minimum(fwd, rc) if canonical else fwd
    if valid is not None:
        key = torch.where(valid, key, torch.full_like(key, key_sentinel(k)))
    return key


def _check(packed, L, k, valid) -> int:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"pack kernels take 1 <= k <= {MAX_K}, got {k}")
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
    """(L - k + 1,) window keys of the L codes in `packed`: the canonical
    min(fwd, rc) (fwd alone if not `canonical`), with the sentinel where
    `valid` (optional, one bool per window) is False.  int32 keys and
    S_SENT for k <= SINGLE_MAX_K (kernel B1), int64 keys and SENTINEL
    above (kernel B2).

    A CUDA tensor runs the kernel, which takes `packed` and `valid`
    16-byte aligned (it stages them with 16-byte copies; a fresh tensor
    or a slice from its start is), counted in launch.B1 or launch.B2
    (utils/trace.py); a CPU tensor runs the plain version."""
    n = _check(packed, L, k, valid)
    if packed.device.type == "cpu":
        return canonical_windows_plain(packed, L, k, canonical, valid)
    if packed.device.type != "cuda":
        raise ValueError(f"unsupported device {packed.device}")
    out = torch.empty(n, dtype=key_dtype(k), device=packed.device)
    for name, t in (("packed", packed), ("valid", valid), ("out", out)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (16-byte copies)")
    from . import _build

    lib = _build.load()
    single = k <= SINGLE_MAX_K
    entry = lib.kmerset_pack_canonical if single else lib.kmerset_pack_canonical64
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = entry(
            packed.data_ptr(), L, k, int(canonical),
            valid.data_ptr() if valid is not None else None,
            out.data_ptr(), n, stream,
        )
    _build.check(lib, err, "pack kernel B1" if single else "pack kernel B2")
    trace.add("launch.B1" if single else "launch.B2")
    return out
