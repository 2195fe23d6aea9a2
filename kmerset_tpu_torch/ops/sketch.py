"""Device sketch table for multi-set similarity.

Counterpart of kmerset_tpu/ops/sketch.py:DeviceSketchTable (:59-129).
The multi-set compressor weighs every pair of sets by the intersection
size of their sampled-bucket sketches (reference:
lib/core/kmer_set_set.h:158-219).  The sketches live on the device as one
(rows, S) int64 matrix, each row sorted, duplicate-free and padded with
SENTINEL.

The reference sorts each concatenated row pair and counts adjacent equal
keys (sketch.py:41-47), because a TPU gathers slowly.  Its rows are
already sorted (KmerSet.sample_buckets returns contiguous slices of a
sorted array), so here a batched torch.searchsorted of row b into row a,
one gather and one compare answer the same question, with no sort:
|A ∩ B| is the number of live keys of b found in a.  Every count is an
exact int64, so the multi-set greedy's tie-break sees the reference's
weights.

Not carried over, because they feed jit caches: the pow2 row and column
padding and the pow2 batch sizes.  A batch of pairs is bounded by the
device's memory budget (backend.memory_budget) in place of the
reference's fixed _MAX_ELEMENTS = 2^26.  The mesh table
(MeshSketchTable, :132-225) is the multi-set half of the mesh (ROADMAP
A.8b).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from . import backend
from .pack import SENTINEL

# Peak bytes per key slot of one pair in a batch: rows a and b gathered
# (16), the positions (8), row a at them (8) and two masks (2).
_BYTES_PER_PAIR_SLOT = 34


def _row_intersections(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) int64 |a[i] ∩ b[i]| of (B, S) sorted, duplicate-free,
    SENTINEL-padded rows."""
    S = a.shape[1]
    pos = torch.searchsorted(a, b).clamp_(max=S - 1)
    hit = (torch.gather(a, 1, pos) == b) & (b != SENTINEL)
    return hit.sum(dim=1, dtype=torch.int64)


class DeviceSketchTable:
    """Matrix of per-set sketches on `device` with batched pair weights."""

    def __init__(self, sketches: Sequence[np.ndarray], *, device):
        self.device = resolve_device(device)
        self.n = len(sketches)
        self.S = max(1, max((s.shape[0] for s in sketches), default=1))
        # Filled on the host and uploaded once.
        mat = np.full((max(1, self.n), self.S), SENTINEL, dtype=np.int64)
        for i, s in enumerate(sketches):
            mat[i, : s.shape[0]] = s
        self._sk = torch.from_numpy(mat).to(self.device)

    @property
    def rows(self) -> torch.Tensor:
        """The live (n, S) rows, on the table's device."""
        return self._sk[: self.n]

    def _row(self, sketch: np.ndarray) -> torch.Tensor:
        """A sketch as a padded row.  The greedy loop's later sketches are
        subsets of its first ones (residuals and intersections), so the
        width of the first is enough, as in the reference."""
        m = sketch.shape[0]
        if m > self.S:
            raise ValueError(f"sketch of size {m} exceeds capacity {self.S}")
        row = np.full(self.S, SENTINEL, dtype=np.int64)
        row[:m] = sketch
        return torch.from_numpy(row).to(self.device)

    def set_row(self, i: int, sketch: np.ndarray) -> None:
        if not 0 <= i < self.n:
            raise IndexError(f"row {i} of a table of {self.n}")
        self._sk[i] = self._row(sketch)

    def append_row(self, sketch: np.ndarray) -> int:
        """Appends a row and returns its index.  The capacity doubles when
        it is full, so appends cost amortized O(S)."""
        row = self._row(sketch)
        if self.n == self._sk.shape[0]:
            grow = torch.full_like(self._sk, SENTINEL)
            self._sk = torch.cat([self._sk, grow], dim=0)
        self._sk[self.n] = row
        self.n += 1
        return self.n - 1

    def batch_pairs(self) -> int:
        """Pairs per batch within the device's memory budget."""
        per_pair = _BYTES_PER_PAIR_SLOT * self.S
        return max(1, backend.memory_budget(self.device) // per_pair)

    def pair_weights(self, pairs: List[Tuple[int, int]]) -> np.ndarray:
        """(len(pairs),) int64 intersection sizes of the (i, j) row
        pairs."""
        if not pairs:
            return np.empty(0, dtype=np.int64)
        idx = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        if idx.min() < 0 or idx.max() >= self.n:
            raise IndexError(f"a pair names a row outside 0..{self.n - 1}")
        with backend.device_lock(self.device):
            idx = torch.from_numpy(idx).to(self.device)
            batch = self.batch_pairs()
            out = torch.empty(idx.shape[0], dtype=torch.int64, device=self.device)
            for s in range(0, idx.shape[0], batch):
                ia, ib = idx[s : s + batch].unbind(1)
                out[s : s + batch] = _row_intersections(
                    self._sk[ia], self._sk[ib]
                )
            return out.cpu().numpy()
