"""Disjoint set (union-find), vectorized.

The port's copy of kmerset_tpu/core/disjoint_set.py:14-69, whole: host
numpy, as in the reference, where it serves host-side component
bookkeeping over small graphs (the production cycle detection is
min-label pointer doubling, core/graph.py).

The original project implements an Anderson-Woll wait-free union-find
with CAS on rank||parent packed atomics (reference:
lib/core/parallel_disjoint_set.h).  This class provides the same
union-find API with union-by-rank + path-halving, plus a batched
`unite_edges` that replays an edge array.
"""

from __future__ import annotations

import numpy as np


class DisjointSet:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int32)

    def find(self, i: int) -> int:
        p = self.parent
        while p[i] != i:
            p[i] = p[p[i]]  # path halving (reference: :24-40)
            i = int(p[i])
        return i

    def unite(self, i: int, j: int) -> None:
        """Union by rank (reference: :53-78)."""
        ri, rj = self.find(i), self.find(j)
        if ri == rj:
            return
        if self.rank[ri] < self.rank[rj]:
            ri, rj = rj, ri
        self.parent[rj] = ri
        if self.rank[ri] == self.rank[rj]:
            self.rank[ri] += 1

    def is_same(self, i: int, j: int) -> bool:
        return self.find(i) == self.find(j)

    def unite_edges(self, a: np.ndarray, b: np.ndarray) -> None:
        for i, j in zip(a.tolist(), b.tolist()):
            self.unite(i, j)

    def roots(self) -> np.ndarray:
        """Fully-compressed root of every element, vectorized doubling."""
        p = self.parent.copy()
        while True:
            pp = p[p]
            if np.array_equal(pp, p):
                return p
            p = pp


def connected_components(n: int, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Component label (min member id) per node for edge list (a, b), via
    iterated min-label propagation — the data-parallel equivalent the
    production code paths use on device."""
    label = np.arange(n, dtype=np.int64)
    while True:
        m = label.copy()
        np.minimum.at(m, a, label[b])
        np.minimum.at(m, b, label[a])
        m = np.minimum(m, m[m])  # pointer-jump
        if np.array_equal(m, label):
            return label
        label = m
