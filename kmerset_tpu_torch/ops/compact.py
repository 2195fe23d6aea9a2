"""Kernel B3: order-preserving stream compaction (csrc/compact.cu).

Counterpart of kmerset_tpu/ops/pallas_compact.py:compact_select_multi.
Where the TPU version needs sorted lanes with flag-bit headroom and a
length that is a multiple of its 8192-element row (it partitions each row
with a sort first), this one takes any 1-3 int32 lanes of any length: on
the reference's domain the kept prefix and n_sel are the same.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MAX_LANES = 3

# Wrapper calls that launched the kernels since the last reset.
launches = 0


def compact_select_plain(
    lanes: Sequence[torch.Tensor], keep: torch.Tensor
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Plain PyTorch B3: `lane[keep]`, zero-padded back to n."""
    n = keep.shape[0]
    mask = keep.to(torch.bool)
    out = torch.zeros(len(lanes), n, dtype=torch.int32, device=keep.device)
    n_sel = mask.sum(dtype=torch.int32)
    for b, lane in enumerate(lanes):
        sel = lane[mask]
        out[b, : sel.shape[0]] = sel
    return tuple(out.unbind(0)), n_sel


def _check(lanes, keep) -> int:
    if not 1 <= len(lanes) <= MAX_LANES:
        raise ValueError(f"compact takes 1..{MAX_LANES} lanes, got {len(lanes)}")
    if keep.dim() != 1 or keep.dtype not in (torch.bool, torch.uint8):
        raise TypeError("keep must be a 1-D bool or uint8 tensor")
    n = keep.shape[0]
    if n > (1 << 31) - 1:
        raise ValueError(f"n={n} exceeds the int32 index range")
    for lane in (*lanes, keep):
        if lane.device != keep.device:
            raise ValueError("lanes and keep must be on one device")
        if not lane.is_contiguous():
            raise ValueError("lanes and keep must be contiguous")
    for lane in lanes:
        if lane.dtype != torch.int32 or lane.shape != (n,):
            raise TypeError(f"every lane must be a ({n},) int32 tensor")
    return n


def compact_select(
    lanes: Sequence[torch.Tensor], keep: torch.Tensor
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Compacts the kept positions of every lane to a prefix, in order.

    Returns (lanes_out, n_sel): lanes_out[b][:n_sel] = lanes[b][keep];
    entries from n_sel on are undefined (callers fill them).  n_sel is a
    0-dim int32 tensor on the lanes' device (reading it syncs).

    A CUDA tensor runs kernel B3; a CPU tensor runs the plain version."""
    n = _check(lanes, keep)
    dev = keep.device
    if dev.type == "cpu":
        return compact_select_plain(lanes, keep)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty(len(lanes), n, dtype=torch.int32, device=dev)
    if n == 0:
        return tuple(out.unbind(0)), torch.zeros((), dtype=torch.int32, device=dev)
    from . import _build

    lib = _build.load()
    tile = lib.kmerset_compact_tile()
    counts = torch.empty((n + tile - 1) // tile, dtype=torch.int32, device=dev)
    keep8 = keep.view(torch.uint8) if keep.dtype == torch.bool else keep
    ptrs = [lane.data_ptr() for lane in lanes]
    ptrs += [None] * (MAX_LANES - len(ptrs))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(
            lib,
            lib.kmerset_compact_count(keep8.data_ptr(), n, counts.data_ptr(), stream),
            "compact count kernel",
        )
        inclusive = torch.cumsum(counts, 0, dtype=torch.int32)
        offsets = inclusive - counts
        _build.check(
            lib,
            lib.kmerset_compact_scatter(
                *ptrs, len(lanes), keep8.data_ptr(), n, offsets.data_ptr(),
                out.data_ptr(), stream,
            ),
            "compact scatter kernel",
        )
    global launches
    launches += 1
    return tuple(out.unbind(0)), inclusive[-1]
