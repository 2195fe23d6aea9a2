"""Kernel B3: order-preserving stream compaction (csrc/compact.cu).

Counterpart of kmerset_tpu/ops/pallas_compact.py:compact_select_multi.
Where the TPU version needs sorted int32 lanes with flag-bit headroom and
a length that is a multiple of its 8192-element row (it partitions each
row with a sort first), this one takes any 1-3 int32 or int64 lanes of
any length: on the reference's domain the kept prefix and n_sel are the
same.  The kernel is one pass with decoupled look-back over tiles of
TILE elements.  An int64 lane carries the k = 19/23 keys that the
reference splits into (hi, lo) int32 lanes.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..utils import trace

MAX_LANES = 3
LANE_DTYPES = (torch.int32, torch.int64)
TILE = 4096  # elements per tile of csrc/compact.cu (kTile)


def compact_select_plain(
    lanes: Sequence[torch.Tensor], keep: torch.Tensor
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Plain PyTorch B3: `lane[keep]`, zero-padded back to n."""
    mask = keep.to(torch.bool)
    outs = []
    for lane in lanes:
        out = torch.zeros_like(lane)
        sel = lane[mask]
        out[: sel.shape[0]] = sel
        outs.append(out)
    return tuple(outs), mask.sum(dtype=torch.int32)


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
        if lane.dtype not in LANE_DTYPES or lane.shape != (n,):
            raise TypeError(f"every lane must be a ({n},) int32 or int64 tensor")
    return n


def compact_select(
    lanes: Sequence[torch.Tensor], keep: torch.Tensor
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Compacts the kept positions of every lane to a prefix, in order.

    Returns (lanes_out, n_sel): lanes_out[b][:n_sel] = lanes[b][keep],
    each in its lane's dtype; entries from n_sel on are undefined (callers
    trim them).  n_sel is a 0-dim int32 tensor on the lanes' device
    (reading it syncs).

    A CUDA tensor runs kernel B3: one memset of its scratch and one
    launch, reading `keep` once, counted in launch.B3 (utils/trace.py);
    any nonzero `keep` byte is kept.  Views
    at any element offset are taken (the kernel reads a tensor that is not
    16-byte aligned element by element).  A CPU tensor runs the plain
    version."""
    n = _check(lanes, keep)
    dev = keep.device
    if dev.type == "cpu":
        return compact_select_plain(lanes, keep)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    outs = tuple(torch.empty_like(lane) for lane in lanes)
    if n == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=dev)
    from . import _build

    lib = _build.load()
    n_sel = torch.empty((), dtype=torch.int32, device=dev)
    # The tile counter, then one status word per tile (cleared by the entry).
    scratch = torch.empty(1 + (n + TILE - 1) // TILE, dtype=torch.int64, device=dev)
    keep8 = keep.view(torch.uint8) if keep.dtype == torch.bool else keep
    pad = [None] * (MAX_LANES - len(lanes))
    srcs = [lane.data_ptr() for lane in lanes] + pad
    dsts = [out.data_ptr() for out in outs] + pad
    widths = [lane.element_size() for lane in lanes] + [0] * len(pad)
    with torch.cuda.device(dev):
        _build.check(
            lib,
            lib.kmerset_compact(
                *srcs, *dsts, *widths, len(lanes), keep8.data_ptr(), n,
                scratch.data_ptr(), scratch.shape[0], n_sel.data_ptr(),
                torch.cuda.current_stream().cuda_stream,
            ),
            "compact kernel B3",
        )
    trace.add("launch.B3")
    return outs, n_sel
