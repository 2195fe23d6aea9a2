"""Batched membership lookup in a sorted set, and the size of the
intersection of two.

Counterpart of kmerset_tpu/ops/join.py.  lookup_join covers the contract
shared by the reference's three sort-joins (lookup_join :33-72, and by
design lookup_join32 :76-117 and lookup_join_pair :121-162, which exist
for the TPU's int32 lanes): for every query, whether it is in the sorted
unique set and, where it is, its position.  The reference sort-joins
because a TPU gather is slow (join.py:3-8); a GPU gathers well, so this
is a binary search (torch.searchsorted) plus one gather and compare.  It
takes the set as it is, int32 or int64: no padding (there is no jit
cache to feed), no tag fusion and so no headroom or size limit on the
keys.  intersection_count (:165-170, an XLA function there, not a Pallas
kernel) counts the hits of the same search.
"""

from __future__ import annotations

from typing import Tuple

import torch


def lookup_join(A: torch.Tensor, Q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found, idx) for the queries Q in the sorted unique 1-D set A (both
    on one device, compared in their promoted dtype): found[i] says Q[i]
    is in A, idx[i] (int64) is its position there, and 0 where it is
    not."""
    if A.dim() != 1 or Q.dim() != 1:
        raise ValueError("lookup_join takes a 1-D set and 1-D queries")
    if A.device != Q.device:
        raise ValueError("set and queries must be on one device")
    n = A.shape[0]
    if n == 0:
        return (torch.zeros(Q.shape, dtype=torch.bool, device=Q.device),
                torch.zeros(Q.shape, dtype=torch.int64, device=Q.device))
    dtype = torch.promote_types(A.dtype, Q.dtype)
    A, Q = A.to(dtype), Q.to(dtype)
    pos = torch.searchsorted(A, Q).clamp_(max=n - 1)  # above A[-1]: n
    found = A[pos] == Q
    return found, pos.masked_fill_(~found, 0)


def intersection_count(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """|A ∩ B| of the sorted unique 1-D sets A and B on one device, as a
    0-dim int64 tensor there (the sketch-similarity kernel, reference:
    lib/core/kmer_set_set.h:158-184): the smaller set looked up in the
    larger."""
    if A.shape[0] > B.shape[0]:
        A, B = B, A
    found, _ = lookup_join(B, A)
    return found.sum()
