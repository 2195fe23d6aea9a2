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

MeshSketchTable (reference :132-225) holds the same rows key-range
sharded over a mesh (parallel/mesh.Mesh): shard d holds its
owner_edges range of every row, and parallel/mesh.sharded_sketch_weights
answers each pair on every shard's range and sums the counts.

Not carried over, because they feed jit caches: the pow2 row and column
padding and the pow2 batch sizes.  A batch of pairs is bounded by the
device's memory budget (backend.memory_budget) in place of the
reference's fixed _MAX_ELEMENTS = 2^26.  The mesh table's shard widths
are each shard's own (the reference gives every shard the widest whole
sketch's pow2 width, n times what a shard holds of it).
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
        self._sk = backend.upload("sketch table", mat, self.device)

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
        return backend.upload("sketch row", row, self.device)

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
            idx = backend.upload("pairs", idx, self.device)
            batch = self.batch_pairs()
            out = torch.empty(idx.shape[0], dtype=torch.int64, device=self.device)
            for s in range(0, idx.shape[0], batch):
                ia, ib = idx[s : s + batch].unbind(1)
                out[s : s + batch] = _row_intersections(
                    self._sk[ia], self._sk[ib]
                )
            return backend.download("pair weights", out)


class MeshSketchTable:
    """The sketch table key-range sharded over `mesh` (reference
    MeshSketchTable, ops/sketch.py:132-225), with DeviceSketchTable's
    interface.  Shard d holds, on its device, its owner_edges(k, n) range
    of every row, as an (rows, S_d) matrix; over a process group each
    rank holds its own shards' matrices.  S_d is the widest of the first
    sketches' parts in d's range: the greedy loop's later rows are subsets
    of its first ones, so that is enough, and a row whose part overflows a
    shard raises.  Every rank computes every S_d from the same host
    sketches, so the widths agree without an exchange.  Pair weights never
    move a sketch."""

    def __init__(self, sketches: Sequence[np.ndarray], k: int, mesh):
        from ..parallel.mesh import owner_edges

        self.mesh = mesh
        self._inner = owner_edges(k, mesh.size)[1:-1]
        self.n = len(sketches)
        self._cap = max(1, self.n)
        parts = [self._split(s) for s in sketches]
        self.widths = [max(1, max((p[d].shape[0] for p in parts), default=1))
                       for d in range(mesh.size)]
        self._sk = []
        for d, dev in zip(mesh.local, mesh.devices):
            mat = np.full((self._cap, self.widths[d]), SENTINEL, dtype=np.int64)
            for i, p in enumerate(parts):
                mat[i, : p[d].shape[0]] = p[d]
            self._sk.append(backend.upload("sketch table", mat, dev))

    @property
    def rows(self) -> List[torch.Tensor]:
        """Each local shard's live (n, S_d) rows, on its device."""
        return [sk[: self.n] for sk in self._sk]

    def _split(self, sketch: np.ndarray) -> List[np.ndarray]:
        """A sorted sketch's part in each shard's key range."""
        return np.split(sketch, np.searchsorted(sketch, self._inner))

    def _rows_of(self, sketch: np.ndarray) -> List[torch.Tensor]:
        """A sketch as one padded row per local shard, on the shard's
        device; a part that overflows any shard raises on every rank."""
        parts = self._split(sketch)
        for d, part in enumerate(parts):
            if part.shape[0] > self.widths[d]:
                raise ValueError(
                    f"sketch part of size {part.shape[0]} in shard {d}'s range "
                    f"exceeds its capacity {self.widths[d]}")
        out = []
        for d, dev in zip(self.mesh.local, self.mesh.devices):
            row = np.full(self.widths[d], SENTINEL, dtype=np.int64)
            row[: parts[d].shape[0]] = parts[d]
            out.append(backend.upload("sketch row", row, dev))
        return out

    def set_row(self, i: int, sketch: np.ndarray) -> None:
        if not 0 <= i < self.n:
            raise IndexError(f"row {i} of a table of {self.n}")
        for sk, row in zip(self._sk, self._rows_of(sketch)):
            sk[i] = row

    def append_row(self, sketch: np.ndarray) -> int:
        """Appends a row and returns its index; every shard's row capacity
        doubles when it is full, as DeviceSketchTable's."""
        rows = self._rows_of(sketch)
        if self.n == self._cap:
            self._cap *= 2
            self._sk = [torch.cat([sk, torch.full_like(sk, SENTINEL)]) for sk in self._sk]
        for sk, row in zip(self._sk, rows):
            sk[self.n] = row
        self.n += 1
        return self.n - 1

    def batch_pairs(self) -> int:
        """Pairs per batch: each physical device's share of memory
        (Mesh.budget) is shared by the shards it holds (at
        _BYTES_PER_PAIR_SLOT per key slot of their widths), as
        driver.shard_query_chunk shares it; the least over the ranks, since
        it fixes the number of batches."""
        per_pair: dict = {}
        for d in self.mesh.local:
            dev = self.mesh.physical_of(d)
            per_pair[dev] = per_pair.get(dev, 0) + _BYTES_PER_PAIR_SLOT * self.widths[d]
        return max(1, self.mesh.agree_min(min(
            (self.mesh.budget(dev) // b for dev, b in per_pair.items()),
            default=1 << 62)))

    def pair_weights(self, pairs: List[Tuple[int, int]]) -> np.ndarray:
        """(len(pairs),) int64 intersection sizes of the (i, j) row pairs:
        one mesh step (parallel/driver "sketch weights") of batches of
        parallel/mesh.sharded_sketch_weights."""
        from ..parallel import driver
        from ..parallel.mesh import sharded_sketch_weights

        if not pairs:
            return np.empty(0, dtype=np.int64)
        idx = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
        if idx.min() < 0 or idx.max() >= self.n:
            raise IndexError(f"a pair names a row outside 0..{self.n - 1}")
        with driver._step("sketch weights", self.mesh):
            idx = backend.upload("pairs", idx, self.mesh.home)
            batch = self.batch_pairs()
            blocks = self.rows
            out = [sharded_sketch_weights(self.mesh, blocks, idx[s : s + batch])
                   for s in range(0, idx.shape[0], batch)]
            return backend.download("pair weights", torch.cat(out))
