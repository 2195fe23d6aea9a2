"""Degree / first-neighbour side tables of the canonical de Bruijn graph,
from one batched membership lookup.

Counterpart of kmerset_tpu/ops/neighbors.py:tables_traced (the canonical
arms, :56-202) and of the host kmerset_tpu/core/spss.py:
_side_table_canonical (:79-103): the 8 extension candidates of every
k-mer (4 right, 4 left) are made canonical and answered by one
ops/join.lookup_join over the sorted set.  The reference's int32 and
(hi, lo) pair lanes exist to halve TPU sort bytes and avoid emulated
64-bit compares; here every key is one int64.
"""

from __future__ import annotations

import torch

from .join import lookup_join

_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_M32 = 0x00000000FFFFFFFF


def reverse_complement(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of int64 2k-bit packed k-mers (k <= 31): the
    five shuffle rounds of kmerset_tpu/core/kmer.py:reverse_complement.

    It starts from ~x, so values are negative in between, and torch's >>
    on a signed int is arithmetic: every right shift is followed by a mask
    whose top bits are clear, which drops the copied sign bits (left
    shifts wrap, as torch shifts the unsigned bits).  Each round works in
    place on one copy of x, so the peak is about three arrays of x's
    size."""
    x = ~x
    for shift, m in ((2, _M2), (4, _M4), (8, _M8), (16, _M16), (32, _M32)):
        hi = (x >> shift).bitwise_and_(m)
        x.bitwise_and_(m).bitwise_left_shift_(shift).bitwise_or_(hi)
    x = x >> (64 - 2 * k)
    return x.bitwise_and_((1 << (2 * k)) - 1)


def side_tables(
    A: torch.Tensor, k: int, canonical: bool = True, lo: int = 0,
    hi: int | None = None,
):
    """((rdeg, rnbr, rsame), (ldeg, lnbr, lsame)) of the k-mers A[lo:hi]
    (all of A by default) in the graph of the sorted unique canonical
    k-mers A (int32 or int64, odd k): deg (int32) counts the distinct
    neighbours on that side, nbr (int64) is the position in A of the first
    one in base order c = 0..3 (0 where deg == 0), and same (bool) says
    that neighbour is entered on its own same side (its candidate was not
    canonical).  A k-mer is never its own neighbour.  Every k-mer's row
    depends only on the k-mer and A, so the rows of a range equal those
    rows of the whole; a range bounds the peak memory, which is ~8 int64
    candidates and their lookups per k-mer of the range.

    Only the canonical graph is built here; the directed one
    (canonical=False) stays on the reference's host build."""
    if not canonical:
        raise ValueError(
            "the port builds canonical side tables only; the directed "
            "graph is the reference's host build (ROADMAP A.10)"
        )
    A = A.to(torch.int64)
    Q = A[lo:hi]
    mask = (1 << (2 * k)) - 1
    c = torch.arange(4, dtype=torch.int64, device=A.device)[:, None]
    # At k = 31, Q << 2 wraps into the sign bit; the mask drops bits 62-63.
    right = ((Q << 2) & mask) | c  # next(a, c)
    left = (Q >> 2) | (c << (2 * (k - 1)))  # prev(a, c); a >= 0
    cand = torch.cat([right, left])  # (8, m): group g = side * 4 + c
    del right, left
    ncan = torch.minimum(cand, reverse_complement(cand, k))
    same_all = cand != ncan
    del cand
    found, idx = lookup_join(A, ncan.view(-1))
    found = found.view(8, -1) & (ncan != Q)  # no self-loop
    idx = idx.view(8, -1)
    out = []
    for side in range(2):
        deg = torch.zeros_like(Q, dtype=torch.int32)
        nbr = torch.zeros_like(Q)
        same = torch.zeros_like(Q, dtype=torch.bool)
        for g in range(4 * side, 4 * side + 4):
            first = found[g] & (deg == 0)
            nbr = torch.where(first, idx[g], nbr)
            same = torch.where(first, same_all[g], same)
            deg += found[g]
        out.append((deg, nbr, same))
    return out[0], out[1]
