"""Host <-> device staging for the port's counting pipeline.

Counterpart of the single-device one-shot path of
kmerset_tpu/ops/backend.py: device_count (:694-820), device_unique
(:499-519) and the staging they share (_staged_windows_u8, :460-496).
The reference's host state is the (codes uint8, offsets int64) pair that
the native FASTA parser (core/native.parse_fasta_bytes) and
core/io.reads_to_codes produce; `stage` turns it into the tensors that
ops/count.py takes, and the fetches turn the device outputs back into the
reference's numpy layout.

There is no host fallback: on CUDA an error raises.  Left for later slices
(ROADMAP A): the slow-link probe and gap-encoded key downloads, resident
device handles and side-code prefetch, the out-of-core chunked path and
the mesh.  No pow2 padding either (good_sort_size exists for the TPU
sort).  The unitig front-end stages its set itself
(ops/unitigs.py:device_unitig_succ), under MAX_DEVICE_GRAPH_KMERS.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kmerset_tpu.core import native

from . import count as count_ops

# The kernels index windows and keys with int32 (the position lane of the
# compaction carries run-head positions as int32).
MAX_WINDOWS = (1 << 31) - 1
# The one-shot device unitig front-end (ops/unitigs.py) takes sets up to
# the reference's cap (kmerset_tpu/ops/backend.py:390); larger sets need
# the out-of-core front-end (ROADMAP A.6).
MAX_DEVICE_GRAPH_KMERS = 1 << 26


class Staged(NamedTuple):
    packed: torch.Tensor  # (ceil(L/4),) uint8, kmerio_pack2 layout
    bounds: torch.Tensor  # (n_fragments,) int32 fragment ends (offsets[1:])
    total: int  # number of codes
    L: int  # codes in `packed` (== total: no padding)


def stage(
    codes: np.ndarray, offsets: np.ndarray, k: int, device
) -> Optional[Staged]:
    """Uploads the 2-bit packed codes and the int32 fragment bounds to
    `device`.  Returns None for inputs that hold no window."""
    total = int(codes.shape[0])
    if total < k:
        return None
    if total - (k - 1) > MAX_WINDOWS:
        raise ValueError(
            f"{total - (k - 1)} windows exceed the int32 position lane of "
            f"the port's kernels ({MAX_WINDOWS}); out-of-core counting is "
            "ROADMAP A.6"
        )
    packed = native.pack2(np.ascontiguousarray(codes, dtype=np.uint8))
    bounds = np.asarray(offsets, dtype=np.int64)[1:].astype(np.int32)
    return Staged(
        torch.from_numpy(packed).to(device),
        torch.from_numpy(bounds).to(device),
        total,
        total,
    )


def host_library_loaded() -> bool:
    """Whether the reference's native host library (native/kmerio.c) is
    loaded.  Without it the FASTA parse, the 2-bit pack and the SPSS build
    run on the reference's numpy fallbacks."""
    return native.get_lib() is not None


def _count_fetch(keys, counts, value_max: int) -> Tuple[np.ndarray, np.ndarray]:
    """(keys int64, counts) on the host.  With value_max > 0 the counts are
    saturated on the device and, up to 255, downloaded as uint8
    (reference backend.py:776-789).  Keys cross in their device dtype:
    int32 for k <= 15, int64 above."""
    keys = keys.cpu().numpy().astype(np.int64, copy=False)
    if value_max:
        counts = torch.clamp(counts, max=value_max)
        if value_max <= 255:
            return keys, counts.to(torch.uint8).cpu().numpy()
    return keys, counts.cpu().numpy().astype(np.int64)


def device_count(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool, *,
    device, value_max: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted distinct (canonical) k-mers of the fragment stream and their
    counts, counted on `device`."""
    staged = stage(codes, offsets, k, device)
    if staged is None:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    keys, counts, _ = count_ops.count_kmers_frag(*staged, k, canonical)
    return _count_fetch(keys, counts, value_max)


def device_unique(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool, *, device
) -> np.ndarray:
    """Sorted distinct (canonical) k-mers of the fragment stream: the
    decode direction, the counting pipeline at cutoff 1 without counts."""
    staged = stage(codes, offsets, k, device)
    if staged is None:
        return np.empty(0, np.int64)
    keys, _, _ = count_ops.count_to_set_frag(*staged, k, canonical, 1)
    return keys.cpu().numpy().astype(np.int64, copy=False)
