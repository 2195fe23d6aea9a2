"""Kernel J1: the canonical path cover's candidate overlap edges on the
device (csrc/overlap.cu).

Replaces no Pallas kernel: it takes over the host's edge discovery of the
canonical path cover (core/spss.py:_candidate_port_edges_canonical and
_dedup_port_edges, through core/native.overlap_edges and dedup_edges: the
hash multimap join of kmerio_overlap_edges_fp / _part and the first-
occurrence dedup of kmerio_dedup_edges).  From the unitigs' first and last
k-mers P and S it gives the kept edges (pa, pb) in the host's discovery
order, which the host matching consumes as its priority: ports 2i (right
side of unitig i) and 2i + 1 (left side); passes A_c, B_c for c = 0..3,
then C_c, D_c; unitig-minor; ascending j within a probe, j == i skipped;
each undirected edge at its first occurrence.

Each edge is found exactly twice, once from each end, and the pass of its
mirror is known from the probing unitig's own key, so the dedup is a rule
on (pass, i, j) and needs no table (csrc/overlap.cu states it): every C_c
edge is dropped, every A_c edge kept, and a B_c or D_c edge is kept where
c < c' (c' the mirror's base) or c == c' and j > i.

Two launches a set on a CUDA tensor (counted in launch.J1, utils/trace.py):
count (each probe's kept matches in the stably sorted P or S), then, after
an inclusive scan of the 12 n counts and one download of the total, fill
(each probe writes its kept edges at its offset).  On a CPU tensor the
plain PyTorch version computes the same edges pass by pass.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import backend

PASSES = 12  # A_c, B_c for c = 0..3, then D_c; no C_c edge is kept


def _rc(x: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complements of the k-mers x (int64)."""
    c = ~x
    out = torch.zeros_like(x)
    for j in range(k):
        out = (out << 2) | ((c >> (2 * j)) & 3)
    return out


def _probes(P: torch.Tensor, S: torch.Tensor, k: int):
    """The 12 kept passes in discovery order: (queries, table 'P' or 'S',
    source port side 0 or 1, destination side bit, c, the mirror's base
    c' per unitig or None where every match is kept)."""
    kmask = (1 << (2 * k)) - 1
    top = 2 * (k - 1)
    for c in range(4):
        nx = ((S << 2) | c) & kmask
        yield nx, "P", 0, 1, c, None
        yield _rc(nx, k), "S", 0, 0, c, 3 - ((S >> top) & 3)
    for c in range(4):
        yield _rc((P >> 2) | (c << top), k), "P", 1, 1, c, 3 - (P & 3)


def edges_plain(P: torch.Tensor, S: torch.Tensor, k: int) -> torch.Tensor:
    """Plain J1: (2, m) int32, the kept edges' ports (pa, pb) in discovery
    order, probe by probe over the stably sorted P and S."""
    n = P.shape[0]
    dev = P.device
    i = torch.arange(n, device=dev)
    tables = {name: torch.sort(X, stable=True) for name, X in (("P", P), ("S", S))}
    out_a, out_b = [], []
    for q, name, side, bit, c, cm in _probes(P, S, k):
        keys, order = tables[name]
        lo = torch.searchsorted(keys, q)
        cnt = torch.searchsorted(keys, q, right=True) - lo
        rows = torch.repeat_interleave(i, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        j = order[torch.arange(rows.shape[0], device=dev) - first[rows] + lo[rows]]
        keep = j != rows
        if cm is not None:
            keep &= (c < cm[rows]) | ((c == cm[rows]) & (j > rows))
        out_a.append(2 * rows[keep] + side)
        out_b.append(2 * j[keep] + bit)
    return torch.stack([torch.cat(out_a), torch.cat(out_b)]).to(torch.int32)


def _lib():
    from . import _build

    return _build.load(), _build.check


def edges(P: torch.Tensor, S: torch.Tensor, k: int) -> torch.Tensor:
    """(2, m) int32 on P's device: the ports (pa, pb) of the kept
    candidate edges of the unitigs whose first and last k-mers (int64)
    are P and S, in the host join's discovery order (native.overlap_edges,
    then core/spss._dedup_port_edges): kernel J1 on CUDA, with one
    download of the edge count; edges_plain on the CPU.  Requires n < 2^30
    unitigs, so that a port fits int32."""
    n = P.shape[0]
    if (P.dtype != torch.int64 or S.dtype != torch.int64 or P.dim() != 1
            or S.shape != P.shape or S.device != P.device):
        raise ValueError("kernel J1 takes P and S as one-dimensional int64 "
                         "tensors of one length on one device")
    if n >= 1 << 30:
        raise ValueError(f"kernel J1 takes fewer than 2^30 unitigs; got {n}")
    if P.device.type == "cpu":
        return edges_plain(P, S, k)
    if not n:
        return torch.empty((2, 0), dtype=torch.int32, device=P.device)
    P, S = P.contiguous(), S.contiguous()
    p_keys, p_ord = torch.sort(P, stable=True)
    s_keys, s_ord = torch.sort(S, stable=True)
    ends = torch.empty(PASSES * n, dtype=torch.int64, device=P.device)
    tables = (p_keys.data_ptr(), p_ord.data_ptr(), s_keys.data_ptr(),
              s_ord.data_ptr())
    lib, check = _lib()
    with torch.cuda.device(P.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib, lib.kmerset_overlap_count(
            P.data_ptr(), S.data_ptr(), n, k, *tables, ends.data_ptr(), stream),
            "overlap kernel J1 (count)")
        trace.add("launch.J1")
        ends.cumsum_(0)
        m = int(backend.download("overlap edge count", ends[-1:])[0])
        out = torch.empty(2 * m, dtype=torch.int32, device=P.device)
        check(lib, lib.kmerset_overlap_fill(
            P.data_ptr(), S.data_ptr(), n, k, *tables, ends.data_ptr(), m,
            out.data_ptr(), stream), "overlap kernel J1 (fill)")
        trace.add("launch.J1")
    return out.view(2, m)
