"""Degree / first-neighbour side tables of the de Bruijn graph, from one
batched membership lookup.

Counterpart of kmerset_tpu/ops/neighbors.py:tables_traced (:56-202, both
values of `canonical`) and of the host kmerset_tpu/core/spss.py:
_side_table_canonical and _side_table_plain (:79-119): the 8 extension
candidates of every k-mer (4 right, 4 left), made canonical in the
canonical graph and taken as they are in the directed one, are answered
by one ops/join.lookup_join over the sorted set.  The reference's int32
and (hi, lo) pair lanes exist to halve TPU sort bytes and avoid emulated
64-bit compares; here every key is one int64.  `candidates` and `tables`
are the two halves around the lookup, which the mesh's side tables
(parallel/mesh.py) answer on the owner of each candidate instead.
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


def candidates(Q: torch.Tensor, k: int, canonical: bool):
    """(ncan, same), each (8, m), of the int64 k-mers Q: row g = side * 4
    + c holds next(q, c) (side 0) or prev(q, c) (side 1), as its canonical
    min in the canonical graph (same: the candidate was not canonical) and
    as it is in the directed one (same all False)."""
    mask = (1 << (2 * k)) - 1
    c = torch.arange(4, dtype=torch.int64, device=Q.device)[:, None]
    # At k = 31, Q << 2 wraps into the sign bit; the mask drops bits 62-63.
    right = ((Q << 2) & mask) | c  # next(a, c)
    left = (Q >> 2) | (c << (2 * (k - 1)))  # prev(a, c); a >= 0
    cand = torch.cat([right, left])  # (8, m): group g = side * 4 + c
    del right, left
    if not canonical:
        return cand, torch.zeros_like(cand, dtype=torch.bool)
    ncan = torch.minimum(cand, reverse_complement(cand, k))
    return ncan, cand != ncan


def tables(Q: torch.Tensor, ncan, same_all, found, idx, with_base: bool = False):
    """((rdeg, rnbr, rsame), (ldeg, lnbr, lsame)) of the k-mers Q from
    their candidates (`candidates`) and each candidate's membership:
    found (8, m) bool and idx (8, m) int64, the position of the member
    (any value where not found).  A k-mer is never its own neighbour.
    with_base appends to each side the extension base c of its first
    neighbour (int32, 0 where deg == 0), as the reference's
    tables_traced(with_base=True) does (kmerset_tpu/ops/neighbors.py:
    63-65, 150-153): the side codes' link format carries it."""
    found = found & (ncan != Q)  # no self-loop
    out = []
    for side in range(2):
        deg = torch.zeros_like(Q, dtype=torch.int32)
        nbr = torch.zeros_like(Q)
        same = torch.zeros_like(Q, dtype=torch.bool)
        base = torch.zeros_like(Q, dtype=torch.int32) if with_base else None
        for g in range(4 * side, 4 * side + 4):
            first = found[g] & (deg == 0)
            nbr = torch.where(first, idx[g], nbr)
            same = torch.where(first, same_all[g], same)
            if with_base:
                base = torch.where(first, g - 4 * side, base)
            deg += found[g]
        out.append((deg, nbr, same, base) if with_base else (deg, nbr, same))
    return out[0], out[1]


def side_tables(
    A: torch.Tensor, k: int, canonical: bool = True, lo: int = 0,
    hi: int | None = None, with_base: bool = False,
):
    """((rdeg, rnbr, rsame), (ldeg, lnbr, lsame)) of the k-mers A[lo:hi]
    (all of A by default) in the graph of the sorted unique k-mers A
    (int32 or int64): deg (int32) counts the distinct neighbours on that
    side, nbr (int64) is the position in A of the first one in base order
    c = 0..3 (0 where deg == 0), and same (bool) says that neighbour is
    entered on its own same side (its candidate was not canonical; all
    False in the directed graph, canonical=False, whose A holds forward
    k-mers).  The canonical graph takes odd k, as the reference's does.
    A k-mer is never its own neighbour.  Every k-mer's row depends only on
    the k-mer and A, so the rows of a range equal those rows of the whole;
    a range bounds the peak memory, which is ~8 int64 candidates and their
    lookups per k-mer of the range.  with_base: as in `tables`."""
    A = A.to(torch.int64)
    Q = A[lo:hi]
    ncan, same_all = candidates(Q, k, canonical)
    found, idx = lookup_join(A, ncan.view(-1))
    return tables(Q, ncan, same_all, found.view(8, -1), idx.view(8, -1),
                  with_base)
