"""Data-parallel graph primitives: pointer doubling and handshake matching.

The port's copy of kmerset_tpu/core/graph.py:31-242 (pointer_double,
handshake_matching with its mesh hook, expand_ranges, filter_groups, and
permute_groups and led_group_selection, which the mesh's chain grouping
uses).  The hook takes an explicit `mesh` (parallel/mesh.Mesh) where the
reference's reads its backend switches.  pointer_double's size guard
raises ValueError where the reference asserts.

These replace the reference's three inherently sequential/lock-based
mechanisms with log-depth, vectorizable iterations:

- sequential path walks (reference: lib/core/spss.h:394-423,1159-1183)
  -> pointer doubling over a successor array;
- wait-free CAS union-find for cycle detection
  (reference: lib/core/parallel_disjoint_set.h:24-78)
  -> min-label propagation fused into the same doubling loop;
- try_lock opportunistic greedy edge selection
  (reference: lib/core/spss.h:796-817,1445-1498)
  -> deterministic handshake matching rounds (each free port proposes its
  best candidate edge; an edge is accepted iff it is the best proposal at
  both of its ports).  At least the globally best live edge is accepted
  every round, so the result is a maximal matching in O(log) expected
  rounds, and — unlike the reference, whose matching depends on thread
  interleaving — it is deterministic.

Everything is NumPy here (host orchestration).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def pointer_double(succ: np.ndarray, labels: np.ndarray | None = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]:
    """Resolves chains and cycles of a functional successor graph.

    succ: int64 array, succ[u] in [0, n) or -1 (chain end).  Every node has
    at most one successor and (by construction in this package) at most one
    predecessor, so components are simple chains or simple cycles.

    Returns (end, dist, is_chain, min_label):
      end[u]      — the chain end reached from u (valid where is_chain);
      dist[u]     — number of steps from u to end[u];
      is_chain[u] — True iff u's walk terminates;
      min_label   — if labels given: min label over all nodes reachable
                    from u; for cycle nodes this is the min over the whole
                    cycle (the leader-election primitive replacing
                    union-find roots).

    For chain nodes, min_label covers a prefix of the walk only — its
    contract is leader election on cycles, where propagation runs the full
    log rounds (chain nodes resolve early and stop accumulating).

    Implementation: (done, dist, ptr) are packed into one int64
    (1 | 31 | 31 bits) so each doubling round costs a single fancy-gather
    instead of three, and resolved nodes leave the active set so per-round
    work shrinks geometrically with the longest-chain length.
    """
    n = succ.shape[0]
    if n == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), np.empty(0, bool), (labels.copy() if labels is not None else None)
    if n >= 1 << 31:  # not an assert, which python -O strips
        raise ValueError(
            f"pointer_double packs node ids into 31 bits; {n} nodes do not fit"
        )
    ids = np.arange(n, dtype=np.int64)
    done0 = succ < 0
    p0 = np.where(done0, ids, succ)
    d0 = np.where(done0, 0, 1).astype(np.int64)
    m = labels.copy() if labels is not None else None
    MASK = (1 << 31) - 1
    packed = (done0.astype(np.int64) << 62) | (d0 << 31) | p0
    active = np.flatnonzero(~done0)
    rounds = max(1, int(np.ceil(np.log2(max(n, 2)))) + 1)
    for _ in range(rounds):
        if active.size == 0:
            break
        pa = packed[active]
        tgt = pa & MASK
        t = packed[tgt]
        if m is not None:
            m[active] = np.minimum(m[active], m[tgt])
        t_done = (t >> 62) != 0
        new_d = ((pa >> 31) & MASK) + np.where(t_done, 0, (t >> 31) & MASK)
        new_p = np.where(t_done, tgt, t & MASK)
        # Mask the dist write: cycle dists double every round and would
        # overflow into the done bit past n > 2^30 (the DIST_MASK hazard
        # of the mesh twin, kmerset_tpu/parallel/mesh.py).  Cycle dists
        # are unused; chain dists are true distances < n and unmasked.
        packed[active] = ((new_d & MASK) << 31) | new_p
        # Nodes whose pointer landed on an end are final.
        active = active[~t_done]
    p = packed & MASK
    d = (packed >> 31) & MASK
    is_chain = succ[p] < 0
    return p, d, is_chain, m


def handshake_matching(
    pa: np.ndarray, pb: np.ndarray, n_ports: int, mesh=None
) -> np.ndarray:
    """Deterministic maximal matching over ports.

    pa, pb: endpoints (port ids) of candidate edges, ordered by priority
    (index 0 = highest priority — the order the reference would have
    considered them on one thread).  Each port may be matched at most once.

    Returns match[port] = partner port, or -1 if unmatched.

    This is the data-parallel stand-in for the reference's bucket-locked
    greedy `if (!HasEdge(i) && !HasEdge(j)) AddEdge(...)` scans
    (reference: lib/core/spss.h:796-817 directed, 1445-1498 bidirected).
    With a `mesh` the rounds run on it (parallel/driver.mesh_matching)
    where its gate takes n_ports.
    """
    match = np.full(n_ports, -1, dtype=np.int64)
    # Self-loop edges (a == b) are meaningless for a path-cover matching
    # (a port cannot join a string to itself); strip them up front so the
    # native greedy scan and the vectorized fixpoint below agree by
    # construction on any input.
    loop = pa == pb
    if loop.any():
        pa, pb = pa[~loop], pb[~loop]
    n_e = pa.shape[0]
    if n_e == 0:
        return match
    # Mesh path: the greedy matching is unique, so the distributed
    # handshake rounds return the same match array bit for bit.
    from ..parallel import driver as mesh_driver

    if mesh_driver.should_use_mesh_graph(mesh, n_ports):
        return mesh_driver.mesh_matching(pa, pb, n_ports, mesh=mesh)
    # Native fast path: the priority-ordered handshake fixpoint equals
    # the sequential greedy scan (an edge survives all rounds iff it is
    # the minimum live edge at both ports, which is exactly the
    # greedy-accept condition), so one O(E) C pass replaces the
    # O(rounds * E) vectorized loop below.
    from . import native

    nm = native.greedy_match(pa, pb, n_ports)
    if nm is not None:
        return nm
    prio = np.arange(n_e, dtype=np.int64)
    alive = np.ones(n_e, dtype=bool)
    free = np.ones(n_ports, dtype=bool)
    sentinel = np.int64(n_e)
    for _ in range(n_e + 1):
        alive &= free[pa] & free[pb]
        if not alive.any():
            break
        live = np.flatnonzero(alive)
        best = np.full(n_ports, sentinel, dtype=np.int64)
        np.minimum.at(best, pa[live], prio[live])
        np.minimum.at(best, pb[live], prio[live])
        win = live[(best[pa[live]] == prio[live]) & (best[pb[live]] == prio[live])]
        if win.size == 0:  # cannot happen: the min live edge always wins
            break
        wa, wb = pa[win], pb[win]
        match[wa] = wb
        match[wb] = wa
        free[wa] = False
        free[wb] = False
    return match


def expand_ranges(lo: np.ndarray, hi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Expands per-query index ranges [lo, hi) into flat (row, index) pairs.

    Used to enumerate all matches of a searchsorted range query (the
    sorted-join replacing the reference's hash-multimap prefix/suffix
    lookups, reference: lib/core/spss.h:619-695).
    """
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    rows = np.repeat(np.arange(lo.shape[0], dtype=np.int64), counts)
    starts = np.zeros(lo.shape[0], dtype=np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    idx = np.arange(total, dtype=np.int64) - starts[rows] + lo[rows]
    return rows, idx


def filter_groups(
    nodes: np.ndarray, groups: np.ndarray, keep: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Keeps the selected (non-empty) chain groups."""
    from . import native

    counts = np.diff(groups)
    keep = keep & (counts > 0)
    if keep.all():
        return nodes, groups
    lo, hi = groups[:-1][keep], groups[1:][keep]
    new_groups = np.zeros(int(keep.sum()) + 1, dtype=np.int64)
    np.cumsum(counts[keep], out=new_groups[1:])
    gathered = native.gather_ranges(nodes, lo, hi)
    if gathered is None:
        _, idx = expand_ranges(lo, hi)
        gathered = nodes[idx]
    return gathered, new_groups


def permute_groups(
    nodes: np.ndarray, groups: np.ndarray, order: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Reorders chain groups by `order` (a permutation of group indices)."""
    from . import native

    counts = np.diff(groups)[order]
    lo, hi = groups[:-1][order], groups[1:][order]
    new_groups = np.zeros(order.shape[0] + 1, dtype=np.int64)
    np.cumsum(counts, out=new_groups[1:])
    gathered = native.gather_ranges(nodes, lo, hi)
    if gathered is None:
        _, idx = expand_ranges(lo, hi)
        gathered = nodes[idx]
    return gathered, new_groups


def led_group_selection(
    nodes: np.ndarray, groups: np.ndarray, starts: np.ndarray, n_nodes: int
):
    """Selects exactly the chain groups led by `starts`, with the stable
    reorder back to `starts` order — the shared parity-critical guard of
    the mesh chain-grouping/emission drivers.  Chains are node-disjoint
    (in-degree <= 1), so each group's first node is its chain's origin.
    Returns (led_mask, nodes_kept, groups_kept, order), or None when the
    grouping does not cover every start exactly once (callers take the
    host walk rather than emit from a foreign origin)."""
    counts = np.diff(groups)
    # A trailing empty group's start index equals len(nodes): clamp the
    # gather and mask empties out of `led` (they cannot be led by a
    # start) instead of tripping an IndexError.
    lo = np.where(counts > 0, groups[:-1], 0)
    firsts = nodes[lo] if nodes.size else np.zeros(counts.shape, np.int64)
    pos = np.full(n_nodes, -1, dtype=np.int64)
    pos[starts] = np.arange(starts.size, dtype=np.int64)
    led = (pos[firsts] >= 0) & (counts > 0)
    nodes_k, groups_k = filter_groups(nodes, groups, led)
    if groups_k.shape[0] - 1 != starts.size:
        return None
    order = np.argsort(pos[nodes_k[groups_k[:-1]]], kind="stable")
    return led, nodes_k, groups_k, order
