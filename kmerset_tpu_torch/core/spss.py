"""SPSS construction and decode: the port's unitig graph front-end on an
explicit torch device or a mesh of shards, and its own copy of the
reference's host half.

The port's copy of kmerset_tpu/core/spss.py, function by function, with
the native library reached through the port's own bindings
(core/native.py):
- the chain machinery: _phase, _keep_rule, _chains_grouped,
  _group_endpoints, _kept_native_order, _oriented_kmers,
  _emit_kmer_chains, _walk_cycles and _concat_packed (reference
  spss.py:55-62, 175-322, 459-522);
- the mesh's chain and cycle walks: _mesh_emit_ordered,
  _mesh_chain_walk_kept_emit, _mesh_walk_cycles and _mesh_chain_walk_kept
  (:324-456, 530-556);
- the greedy path cover: _candidate_port_edges_canonical,
  _dedup_port_edges, _break_cycles, _emit_string_chains, _take_strings,
  _emit_matched_paths, get_spss_canonical_from_unitigs and
  _sequential_matching (:778-859, 887-1048, 1132-1171);
- the directed build: get_unitigs (:733-770), _candidate_edges_directed,
  get_spss_from_unitigs and get_spss (:862-884, 1051-1079), with the host
  side tables of the native library or the numpy _side_table_plain
  (:69-119, 151-167) kept as the plain version of the device's.

A mesh (parallel/mesh.Mesh) is passed explicitly as `mesh=`; every
router takes it where the reference's read its backend switches, and
parallel/driver.should_use_mesh_graph / should_use_mesh stand for the
reference's gates.  A mesh program that fails raises: the reference's
`None` returns survive only where they are routing decisions (k = 31
overlap edges, 2^30 nodes and up, chains not led by the requested
starts, cycles the reference's walk stops inside).

The mesh emits strings in the order of the host walk of the loaded
`libkmerio` edition: with the library, the native walk's start order
(the reference's mesh order, _kept_native_order); without it, the numpy
walk's end order (_chains_grouped's fallback), which the reference's
mesh does not reproduce (it orders as the native walk in both).

The port's own editions:
- get_unitigs_canonical (:559-730): the front half (side tables, terminal
  tests, oriented successor, :580-652) is one call of the port's device
  front-end (ops/unitigs.device_unitig_succ) or of the mesh's
  (driver.mesh_unitig_succ); on a slow link (ops/backend.side_code_route)
  it is the side-code route of :598-622 instead: the 1 B/k-mer side
  codes (ops/unitigs.device_unitig_sides) and the successor rebuilt on
  the host (native.succ_from_sides).  The set's resident handle
  (KmerSet.device, validated as the reference does, :586-592) stands in
  for the upload on one device; a mesh ignores it.  The chain walk and
  string emission half (:653-730) follows the reference line for line,
  except where backend.walk_route sends it to the card (_device_walk,
  kernel W1 of ops/walk.py: the same strings from the front-end's arrays
  left there by either of its modes);
- get_unitigs (:733-770): its directed side tables are built on the
  device (ops/unitigs.device_side_tables_directed, from the resident
  handle where there is a valid one, :742-746) or on the mesh
  (driver.mesh_side_tables) where the reference builds them on the host
  (under its host pin) or through ops/neighbors.device_side_tables;
- _candidate_port_edges_canonical (:778-845): on a CUDA device with no
  mesh, where backend.edges_route admits the unitigs, the join and the
  dedup are kernel J1 (ops/overlap.py, _device_edges): the same edges in
  the same order from the host-packed first and last k-mers;
- get_spss_canonical (:1082-1084), which hands its device to the path
  cover;
- decode_unique_kmers (:1087-1118) and get_kmer_set_from_spss
  (:1121-1124), which decode on the mesh (driver.mesh_count), or through
  the port's device_unique, in halo chunks (device_unique_chunked) above
  the device's one-shot ceiling.

Citations of the form "reference: lib/core/spss.h" point to the original
C++ project, as they do in kmerset_tpu.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import List, Tuple

import numpy as np

from ..ops import backend
from ..ops import overlap as overlap_ops
from ..ops import walk as walk_ops
from ..ops.unitigs import (
    device_side_tables_directed,
    device_unitig_sides,
    device_unitig_succ,
)
from ..parallel import driver as mesh_driver
from ..utils import trace
from . import kmer as kmer_ops
from . import native
from .graph import (
    expand_ranges,
    filter_groups as _filter_groups,
    handshake_matching,
    led_group_selection,
    permute_groups as _permute_groups,
    pointer_double,
)
from .kmer_set import KmerSet
from .strings import PackedStrings

logger = logging.getLogger("kmerset")


@contextmanager
def _phase(span: str, line: str):
    """Debug-level phase timing, mirroring the reference's debug-log
    narration of algorithm phases (reference: lib/core/spss.h:315-353):
    the span `span`, and a line "LINE: S.SSSSs" at its end."""
    with trace.timed(span) as s:
        yield
    logger.debug("%s: %.4fs", line, s.seconds)


# ---------------------------------------------------------------------------
# Directed side tables (host: the plain version of the device's)
# ---------------------------------------------------------------------------


def _lookup(A: np.ndarray, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(found, index) of queries in sorted-unique A."""
    if A.shape[0] == 0:
        return np.zeros(q.shape, bool), np.zeros(q.shape, np.int64)
    idx = np.searchsorted(A, q)
    idx_c = np.minimum(idx, A.shape[0] - 1)
    found = A[idx_c] == q
    return found, idx_c


def _side_table_plain(A: np.ndarray, k: int, right: bool):
    """Directed-graph degree / unique-neighbor tables
    (reference: lib/core/spss.h:76-94)."""
    n = A.shape[0]
    deg = np.zeros(n, dtype=np.int64)
    nbr = np.zeros(n, dtype=np.int64)
    for c in range(4):
        cand = kmer_ops.next_kmer(A, k, c) if right else kmer_ops.prev_kmer(A, k, c)
        found, idx = _lookup(A, cand)
        found &= cand != A
        first = found & (deg == 0)
        nbr = np.where(first, idx, nbr)
        deg += found
    return deg, nbr


def _side_tables_directed(A: np.ndarray, k: int):
    """Directed-graph side tables ((outdeg, next), (indeg, prev)) on the
    host: the native library's, else the numpy _side_table_plain (the
    host arm of the reference's _side_tables, spss.py:151-167).  The plain
    version of ops/unitigs.device_side_tables_directed, which get_unitigs
    runs."""
    res = native.side_tables_directed(A, k)
    if res is not None:
        return res
    return _side_table_plain(A, k, right=True), _side_table_plain(A, k, right=False)


# ---------------------------------------------------------------------------
# Chain machinery (shared by the k-mer level and the unitig level)
# ---------------------------------------------------------------------------


def _entity_flip(nodes: np.ndarray, oriented: bool) -> Tuple[np.ndarray, np.ndarray]:
    if oriented:
        return nodes >> 1, (nodes & 1).astype(bool)
    return nodes, np.zeros(nodes.shape, dtype=bool)


def _keep_rule(A: np.ndarray, firsts, lasts):
    """The reference's canonical orientation tie-break: keep the chain
    whose start k-mer is >= its end k-mer (lib/core/spss.h:511,555).
    ONE definition for the native-callback and numpy-fallback paths (and
    the reference's mesh paths) — the byte-parity of every backend hangs
    on the sites applying the identical predicate.  Works elementwise on arrays and
    on scalar node ids."""
    return A[firsts >> 1] >= A[lasts >> 1]


def _native_walk_order() -> bool:
    """Whether the host walk in this process is the native library's
    (groups in start order) rather than the numpy fallback's (groups in
    end order): the order a mesh emits in, so that its bytes equal the
    host build's."""
    return native.get_lib() is not None


def _mesh_walks(mesh, succ: np.ndarray, oriented: bool) -> bool:
    """Whether the walk over `succ` (oriented: 2 nodes per entity) runs on
    `mesh`: its gate takes the entity count, as every phase's does, and
    the node ids stay below driver.MAX_MESH_NODES (the reference's
    routers return None from 2^30 nodes on, a routing decision kept
    here)."""
    n_ents = succ.shape[0] >> 1 if oriented else succ.shape[0]
    return (mesh_driver.should_use_mesh_graph(mesh, n_ents)
            and succ.shape[0] < mesh_driver.MAX_MESH_NODES)


def _chains_grouped(
    succ: np.ndarray, starts: np.ndarray, oriented: bool = False, mesh=None
) -> Tuple[np.ndarray, np.ndarray]:
    """Groups the nodes of the chains led by `starts` contiguously in
    (chain, position) order; returns (nodes, group_starts).

    Mesh path: pointer doubling and one owner-routed grouping
    (driver.mesh_chain_group), in the host walk's group order.  Native
    path: a sequential C pointer chase, O(total chain length)
    (native/kmerio.c kmerio_chain_walk — the data-parallel equivalent of
    the reference's threaded walks, lib/core/spss.h:394-423).  Fallback:
    pointer doubling + lexsort (log-depth, used when the native library is
    unbuilt).  Group order may differ between the two paths; both are
    valid chain groupings of the same chains.  `oriented` marks a
    2-nodes-per-entity succ so the mesh gate compares entity counts.
    """
    if starts.size == 0:
        return np.empty(0, np.int64), np.zeros(1, np.int64)
    if _mesh_walks(mesh, succ, oriented):
        res = mesh_driver.mesh_chain_group(
            succ, starts, mesh=mesh, by_starts=_native_walk_order()
        )
        if res is not None:
            return res
    res = native.chain_walk(succ, starts)
    if res is not None:
        return res
    end, dist, is_chain, _ = pointer_double(succ)
    keep_end = np.zeros(succ.shape[0], dtype=bool)
    keep_end[end[starts]] = True
    sel = np.flatnonzero(is_chain & keep_end[end])
    if sel.size == 0:
        return sel, np.zeros(1, np.int64)
    order = np.lexsort((-dist[sel], end[sel]))
    nodes_sorted = sel[order]
    ends_sorted = end[nodes_sorted]
    boundaries = np.flatnonzero(np.diff(ends_sorted)) + 1
    group_starts = np.concatenate(
        ([0], boundaries, [nodes_sorted.shape[0]])
    ).astype(np.int64)
    return nodes_sorted, group_starts


def _group_endpoints(
    nodes: np.ndarray, groups: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(first, last, nonempty) node of every chain group; first/last are 0
    where a group is empty."""
    counts = np.diff(groups)
    nonempty = counts > 0
    lo = np.where(nonempty, groups[:-1], 0)
    hi = np.where(nonempty, groups[1:] - 1, 0)
    return nodes[lo], nodes[hi], nonempty


def _kept_native_order(
    A: np.ndarray,
    succ: np.ndarray,
    starts: np.ndarray,
    nodes: np.ndarray,
    groups: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]:
    """Shared parity-critical block of the mesh chain emitters: applies
    the canonical orientation keep rule (A[first] >= A[last], the
    reference tie-break, lib/core/spss.h:511,555) and reconstructs
    native/kmerio.c::kmerio_chain_pairs' 64-lane batched emission order
    — the winner of each mirror pair is the lower-positioned start, and
    within a 64-wide batch records land in (chain length, lane) order
    because shorter walks finish earlier.  Returns
    (keep, nodes_kept, groups_kept, order); order is None when fewer
    than two groups survive (nothing to reorder)."""
    firsts, lasts, nonempty = _group_endpoints(nodes, groups)
    keep = nonempty & _keep_rule(A, firsts, lasts)
    nodes_k, groups_k = _filter_groups(nodes, groups, keep)
    if groups_k.shape[0] <= 1:
        return keep, nodes_k, groups_k, None
    fk, lk, _ = _group_endpoints(nodes_k, groups_k)
    pos = np.full(succ.shape[0], np.int64(1) << 60, dtype=np.int64)
    pos[starts] = np.arange(starts.size, dtype=np.int64)
    minpos = np.minimum(pos[fk], pos[lk ^ 1])
    lens = np.diff(groups_k)
    order = np.lexsort((minpos & 63, lens, minpos >> 6))
    return keep, nodes_k, groups_k, order


def _oriented_kmers(A: np.ndarray, k: int, entity: np.ndarray, flip: np.ndarray) -> np.ndarray:
    vals = A[entity]
    rc = kmer_ops.reverse_complement(vals, k)
    return np.where(flip, rc, vals)


def _emit_kmer_chains(
    A: np.ndarray,
    k: int,
    nodes_sorted: np.ndarray,
    group_starts: np.ndarray,
    oriented: bool,
) -> PackedStrings:
    """Builds unitig strings from chain-grouped nodes: the first node of a
    chain contributes k bases, every following node one base
    (reference ConcatenateKmers, lib/core/spss.h:25-41)."""
    n_chains = group_starts.shape[0] - 1
    if nodes_sorted.size == 0:
        return PackedStrings.empty()
    res = native.emit_kmer_chains(A, k, nodes_sorted, group_starts, oriented)
    if res is not None:
        return PackedStrings(res[0], res[1])
    counts = np.diff(group_starts)
    nonempty = counts > 0
    # Empty groups emit length-0 strings, matching the native binding's
    # documented contract (core/native.py emit_kmer_chains); the old
    # unconditional counts + k - 1 gave an empty group k-1 garbage bytes.
    str_lens = np.where(nonempty, counts + k - 1, 0)
    offsets = np.zeros(n_chains + 1, dtype=np.int64)
    np.cumsum(str_lens, out=offsets[1:])
    codes = np.zeros(int(offsets[-1]), dtype=np.uint8)

    entity, flip = _entity_flip(nodes_sorted, oriented)
    ov = _oriented_kmers(A, k, entity, flip)
    group_of = np.repeat(np.arange(n_chains, dtype=np.int64), counts)
    t = np.arange(nodes_sorted.shape[0], dtype=np.int64) - group_starts[group_of]

    first_vals = ov[group_starts[:-1][nonempty]]
    codes_first = kmer_ops.codes_from_kmer(first_vals, k)  # (n_nonempty, k)
    first_pos = offsets[:-1][nonempty, None] + np.arange(k)
    codes[first_pos.ravel()] = codes_first.ravel().astype(np.uint8)

    rest = t > 0
    pos = offsets[group_of[rest]] + k - 1 + t[rest]
    codes[pos] = (ov[rest] & 3).astype(np.uint8)
    return PackedStrings(codes, offsets)


def _mesh_emit_ordered(
    A: np.ndarray,
    k: int,
    succ: np.ndarray,
    starts: np.ndarray,
    oriented: bool,
    mesh,
    pd=None,
    by_starts: bool = True,
) -> Tuple[PackedStrings, np.ndarray] | None:
    """Distributed chain grouping + on-device string emission
    (driver.mesh_emit_chains), selected and ordered by `starts` exactly
    like mesh_chain_group + _emit_kmer_chains — but the base codes are
    rendered on the mesh, so the host never gathers through A.  With
    by_starts=False the strings stay in the order of their ends, as the
    numpy walk groups them.  Returns (strings, chain nodes), or None where
    the groups are not led by exactly the starts (callers take the host
    walk)."""
    nodes, groups, codes, str_offsets = mesh_driver.mesh_emit_chains(
        A, k, succ, starts, oriented, mesh=mesh, pd=pd
    )
    ps = PackedStrings(codes, str_offsets)
    if not by_starts:
        return ps, nodes
    sel = led_group_selection(nodes, groups, starts, succ.shape[0])
    if sel is None:
        return None
    led, nodes_k, _groups_k, order = sel
    return _take_strings(ps, np.flatnonzero(led)[order]), nodes_k


def _mesh_chain_walk_kept_emit(
    A: np.ndarray, k: int, succ: np.ndarray, starts: np.ndarray, mesh, pd=None
) -> Tuple[PackedStrings, np.ndarray] | None:
    """Distributed form of the canonical unitig walk WITH on-device
    emission: groups and renders every chain on the mesh
    (driver.mesh_emit_chains), applies the orientation skip rule
    (reference: lib/core/spss.h:511,555) per string group, and orders the
    kept strings as the host walk of this process does: the native
    mirror-dedup order (_kept_native_order), or the numpy walk's end
    order.  Returns (strings, chain nodes), or None where the groups are
    not led by exactly the starts (native order only; callers take the
    host walk)."""
    nodes, groups, codes, str_offsets = mesh_driver.mesh_emit_chains(
        A, k, succ, starts, True, mesh=mesh, pd=pd
    )
    ps = PackedStrings(codes, str_offsets)
    if not _native_walk_order():
        firsts, lasts, nonempty = _group_endpoints(nodes, groups)
        keep = nonempty & _keep_rule(A, firsts, lasts)
        return _take_strings(ps, np.flatnonzero(keep)), nodes
    # Every group must begin at one of the requested starts (chains are
    # node-disjoint, so firsts are chain origins) or the keep rule below
    # would judge the wrong endpoint.  Empty groups are checked first: a
    # trailing one would make nodes[groups[:-1]] index past the end.
    in_starts = np.zeros(succ.shape[0], dtype=bool)
    in_starts[starts] = True
    if (
        groups.shape[0] - 1 != starts.size
        or (np.diff(groups) <= 0).any()
        or not in_starts[nodes[groups[:-1]]].all()
    ):
        return None
    keep, nodes_k, _groups_k, order = _kept_native_order(
        A, succ, starts, nodes, groups
    )
    keep_idx = np.flatnonzero(keep)
    if order is None:
        return _take_strings(ps, keep_idx), nodes_k
    return _take_strings(ps, keep_idx[order]), nodes_k


def _mesh_walk_cycles(
    A: np.ndarray, k: int, succ: np.ndarray, visited: np.ndarray,
    oriented: bool, mesh,
) -> PackedStrings | None:
    """Distributed leftover-cycle emission: min-node leader election via
    mesh pointer doubling picks each orbit's start (the reference scans
    entities ascending, so a cycle is entered at its minimum entity in
    orientation 0, lib/core/spss.h:583-612); cutting the start's
    predecessor edge turns every orbit into a chain, which the
    owner-routed grouping lays out in walk order, in start order (the
    host walk's in both editions).  Byte-identical to native.walk_cycles;
    returns None (the host walk) on inputs whose reference walk stops
    early — a visited entity inside an orbit, or a self-mirror orbit
    carrying both orientations of one entity."""
    n_nodes = succ.shape[0]
    _, _, is_chain, mins = mesh_driver.mesh_pointer_double(
        succ, np.arange(n_nodes, dtype=np.int64), mesh=mesh
    )
    cyc = ~is_chain
    if not cyc.any():
        return PackedStrings.empty()
    cnodes = np.flatnonzero(cyc)
    ents = (cnodes >> 1) if oriented else cnodes
    if visited[ents].any():
        return None
    if oriented:
        key = mins[cnodes] * np.int64(n_nodes) + ents
        ks = np.sort(key)
        if ks.size > 1 and (ks[1:] == ks[:-1]).any():
            return None  # self-mirror orbit: partial-walk semantics
        starts = np.unique(mins[cnodes])
        starts = starts[starts % 2 == 0]
    else:
        starts = np.unique(mins[cnodes])
    if starts.size == 0:
        return None
    succ2 = succ.copy()
    has_succ = np.flatnonzero(succ >= 0)
    pred = np.full(n_nodes, -1, dtype=np.int64)
    pred[succ[has_succ]] = has_succ
    pv = pred[starts]
    succ2[pv[pv >= 0]] = -1
    # One distributed doubling over the cut graph, shared by the emit
    # attempt and its grouping-only alternative.
    pd2 = mesh_driver.mesh_pointer_double(succ2, mesh=mesh)
    em = _mesh_emit_ordered(A, k, succ2, starts, oriented, mesh, pd=pd2)
    if em is not None:
        ps, nodes = em
        visited[(nodes >> 1) if oriented else nodes] = True
        return ps
    grouped = mesh_driver.mesh_chain_group(succ2, starts, mesh=mesh, pd=pd2)
    if grouped is None:
        return None
    nodes, groups = grouped
    visited[(nodes >> 1) if oriented else nodes] = True
    return _emit_kmer_chains(A, k, nodes, groups, oriented)


def _walk_cycles(
    A: np.ndarray, k: int, succ: np.ndarray, visited: np.ndarray,
    oriented: bool, mesh=None,
) -> PackedStrings:
    """Sequential walk of leftover pure cycles, in ascending k-mer order,
    stopping at the first already-visited k-mer (reference:
    lib/core/spss.h:203-224,583-612).  On a mesh, the distributed walk
    (_mesh_walk_cycles) where it applies.  Native one-pass C walk when the
    library is built (all-cycle worst-case inputs — circular plasmids,
    repeat-heavy genomes — run at chain-emission speed); the Python
    per-k-mer loop below is the byte-identical fallback."""
    if visited.all():
        # Chains + isolated k-mers covered every entity, so no orbit
        # exists and every backend would emit nothing — skip the scan.
        return PackedStrings.empty()
    if _mesh_walks(mesh, succ, oriented):
        res = _mesh_walk_cycles(A, k, succ, visited, oriented, mesh)
        if res is not None:
            return res
    res = native.walk_cycles(succ, A, k, oriented, visited)
    if res is not None:
        codes, offsets = res
        return PackedStrings(codes, offsets)
    out: List[np.ndarray] = []
    for i0 in np.flatnonzero(~visited):
        if visited[i0]:
            continue
        u = 2 * int(i0) if oriented else int(i0)
        codes: List[int] = []
        first = True
        while True:
            ent = (u >> 1) if oriented else u
            if visited[ent]:
                break
            visited[ent] = True
            val = int(A[ent])
            if oriented and (u & 1):
                val = int(kmer_ops.reverse_complement(np.int64(val), k))
            if first:
                codes.extend(int(x) for x in kmer_ops.codes_from_kmer(np.int64(val), k))
                first = False
            else:
                codes.append(val & 3)
            u = int(succ[u])
        out.append(np.array(codes, dtype=np.uint8))
    return PackedStrings.from_code_lists(out)


def _concat_packed(parts: List[PackedStrings]) -> PackedStrings:
    parts = [p for p in parts if len(p) > 0]
    if not parts:
        return PackedStrings.empty()
    if len(parts) == 1:
        return parts[0]
    codes = np.concatenate([p.codes for p in parts])
    lens = np.concatenate([p.lengths() for p in parts])
    offsets = np.zeros(lens.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    return PackedStrings(codes, offsets)


# ---------------------------------------------------------------------------
# Unitigs
# ---------------------------------------------------------------------------


def _mesh_chain_walk_kept(
    A: np.ndarray, succ: np.ndarray, starts: np.ndarray, mesh, pd=None
) -> Tuple[np.ndarray, np.ndarray] | None:
    """Distributed form of native.chain_walk_kept: group every chain on
    the mesh (pointer doubling + owner-routed exchange), apply the
    orientation skip rule per group, and reorder to the exact emission
    order of the native mirror-dedup walk so the two backends stay
    byte-identical (_kept_native_order).  Native order only: the numpy
    walk's order is _mesh_chain_walk_kept_emit's.  Returns None where the
    groups are not led by exactly the starts."""
    grouped = mesh_driver.mesh_chain_group(succ, starts, mesh=mesh, pd=pd)
    if grouped is None:
        return None
    nodes, groups = grouped
    _keep, nodes_k, groups_k, order = _kept_native_order(
        A, succ, starts, nodes, groups
    )
    if order is None:
        return nodes_k, groups_k
    return _permute_groups(nodes_k, groups_k, order)


def _resident(kmer_set: KmerSet, device):
    """The set's resident handle (KmerSet.device) when it mirrors the set
    and lies on `device`, else None: the front-end then uploads the host
    array, which stays authoritative (reference spss.py:586-592,
    742-746).  The port's handle holds int64 keys at every k, the layout
    of both graphs' front-ends, so the reference's lane check (a literal
    k <= 15 for its int32 handles, spss.py:134) has no counterpart."""
    res = kmer_set.device
    if res is None or not res.valid_for(kmer_set.kmers, kmer_set.k) or not res.on(device):
        return None
    return res


def _device_walk(A: np.ndarray, k: int, succ, term_l, term_r, both, At):
    """The canonical unitigs of the host walk, walked and emitted on the
    device by kernel W1 (ops/walk.py) from the front-end's arrays there
    (At: the set's tensor), in the same phases and debug lines; only the
    strings, and only where pure cycles are left the successor and the
    covered entities, are downloaded.  Raises where W1 refuses succ: the
    front-end's arrays keep the chain contract, so a refusal is a fault
    of the device walk, and no host walk hides it."""
    with backend.device_lock(succ.device):
        with _phase("spss.chain_walk", "unitigs: chain walk"):
            chains = walk_ops.chain_walk(succ, term_l, term_r, At, k)
        if chains is None:
            raise RuntimeError("kernel W1 refused the front-end's successor (measure/rank)")
        with _phase("spss.emission", "unitigs: emission + cycles"):
            out = walk_ops.emit_strings(chains, succ, both, At, k)
            if out is None:
                raise RuntimeError("kernel W1 refused the front-end's successor (emit)")
            parts = [PackedStrings(backend.download("unitig codes", out.codes),
                                   backend.download("unitig offsets", out.offsets))]
            if out.n_covered < A.shape[0]:
                # Pure cycles, which W1 does not walk: the host's cycle
                # walk over the successor, as the host build runs it.
                visited = backend.download("covered", out.covered).view(bool)
                parts.append(_walk_cycles(
                    A, k, backend.download("succ", succ), visited, oriented=True))
    trace.add("walk.device")
    return _concat_packed(parts)


def get_unitigs_canonical(kmer_set: KmerSet, *, device, mesh=None) -> PackedStrings:
    """Maximal non-branching paths of the bidirected de Bruijn graph
    (reference: lib/core/spss.h:231-615), with the graph front-end on
    `device`, or on `mesh` with the chain walk and emission there too.
    On a CUDA device with no mesh, from backend.WALK_MIN_KMERS k-mers up
    to backend.walk_ceiling, the chain walk and emission run there too
    (_device_walk, kernel W1), from either mode of the front-end, else on
    the host; the counters walk.device and walk.host count the sets
    walked each way (device_unitig_succ counts walk.bounded).  Requires
    odd k, as the reference does."""
    A = kmer_set.kmers
    k = kmer_set.k
    if k % 2 == 0:
        raise ValueError(
            "canonical SPSS construction requires odd k (palindromic "
            f"k-mers exist for even k); got k={k}"
        )
    n = A.shape[0]
    if n == 0:
        return PackedStrings.empty()

    on_mesh = mesh_driver.should_use_mesh_graph(mesh, n)
    device_walk = False
    with _phase("spss.front_end", "unitigs: device front-end"):
        if on_mesh:
            # Sharded side tables + mate exchange + successor assembly.
            succ, term_l, term_r, both = mesh_driver.mesh_unitig_succ(A, k, mesh)
        elif backend.side_code_route(n, device):
            # The slow link's format: 1 byte per k-mer of side codes in
            # place of the 8-byte successor and 3 mask bytes; the host
            # rebuilds the same successor with one probe per side.
            res = _resident(kmer_set, device)
            with _phase("spss.side_code_fetch", "unitigs: side-code fetch"):
                sides = device_unitig_sides(A, k, device=device, resident=res)
            with _phase("spss.succ_rebuild", "unitigs: succ rebuild"):
                succ = native.succ_from_sides(A, sides, k)
            if succ is None:
                raise RuntimeError(
                    "the native succ rebuild refused the device's side codes"
                )
            term_r = (sides & 1).astype(bool)
            term_l = (sides & 16).astype(bool)
            both = term_l & term_r
        else:
            device_walk = mesh is None and backend.walk_route(n, device)
            front = device_unitig_succ(
                A, k, device=device, resident=_resident(kmer_set, device),
                keep=device_walk,
            )
            succ, term_l, term_r, both = front[:4]
    if device_walk:
        return _device_walk(A, k, *front)
    trace.add("walk.host")
    with _phase("spss.chain_walk", "unitigs: chain walk"):
        starts_r_exit = np.flatnonzero(term_l & ~term_r) * 2
        starts_l_exit = np.flatnonzero(term_r & ~term_l) * 2 + 1
        starts = np.concatenate([starts_r_exit, starts_l_exit])

        # Each chain exists once per orientation; keep the one whose start
        # k-mer is >= its end k-mer (reference skip rule,
        # lib/core/spss.h:511,555).  Mesh path first (distributed pointer
        # doubling + owner-routed grouping and rendering — no sequential
        # walk anywhere); then the native fast path: measure all chains,
        # apply the rule, emit only winners; fallback: walk everything and
        # filter.
        kept = None
        chains = None
        if 0 < starts.size and _mesh_walks(mesh, succ, True):
            # Pointer doubling runs once; the grouping-only walk reuses it.
            pd = mesh_driver.mesh_pointer_double(succ, mesh=mesh)
            em = _mesh_chain_walk_kept_emit(A, k, succ, starts, mesh, pd=pd)
            if em is not None:
                chains, nodes = em
            else:
                kept = _mesh_chain_walk_kept(A, succ, starts, mesh, pd=pd)
        if chains is None:
            if kept is None:
                kept = native.chain_walk_kept(
                    succ, starts, lambda s, e: _keep_rule(A, s, e)
                )
            if kept is not None:
                nodes_kept, groups_kept = kept
                nodes = nodes_kept  # kept chains cover the same entities
            else:
                nodes, groups = _chains_grouped(succ, starts, oriented=True)
                firsts, lasts, nonempty = _group_endpoints(nodes, groups)
                keep = nonempty & _keep_rule(A, firsts, lasts)
                nodes_kept, groups_kept = _filter_groups(nodes, groups, keep)
    with _phase("spss.emission", "unitigs: emission + cycles"):
        if chains is None:
            chains = _emit_kmer_chains(A, k, nodes_kept, groups_kept, oriented=True)

        parts: List[PackedStrings] = [chains]

        # Isolated k-mers (terminals on both sides), one string each
        # (reference: lib/core/spss.h:459-493).
        both_idx = np.flatnonzero(both)
        if both_idx.size:
            res = native.emit_kmer_chains(
                A,
                k,
                2 * both_idx,
                np.arange(both_idx.size + 1, dtype=np.int64),
                oriented=True,
            )
            if res is not None:
                parts.append(PackedStrings(res[0], res[1]))
            else:
                codes = kmer_ops.codes_from_kmer(A[both_idx], k).astype(np.uint8)
                offsets = np.arange(both_idx.size + 1, dtype=np.int64) * k
                parts.append(PackedStrings(codes.ravel(), offsets))

        # Non-branching loops (reference: lib/core/spss.h:583-612).  Every
        # entity on any walked chain is covered by a kept chain (kept chains
        # and their dropped mirrors visit the same k-mers).
        visited = np.zeros(n, dtype=bool)
        visited[nodes >> 1] = True
        visited[both_idx] = True
        parts.append(_walk_cycles(A, k, succ, visited, oriented=True, mesh=mesh))

    return _concat_packed(parts)


def get_unitigs(kmer_set: KmerSet, *, device, mesh=None) -> PackedStrings:
    """Maximal non-branching paths of the directed de Bruijn graph
    (reference: lib/core/spss.h:74-227), with the side tables on `device`
    (in query chunks) or on `mesh`, the chain walk and emission on the
    mesh too."""
    A = kmer_set.kmers
    k = kmer_set.k
    n = A.shape[0]
    if n == 0:
        return PackedStrings.empty()

    on_mesh = mesh_driver.should_use_mesh_graph(mesh, n)
    device_walk = False
    with _phase("spss.front_end", "unitigs: device front-end"):
        if on_mesh:
            (outdeg, nxt, _), (indeg, prv, _) = mesh_driver.mesh_side_tables(
                A, k, False, mesh
            )
        else:
            (outdeg, nxt), (indeg, prv) = device_side_tables_directed(
                A, k, device=device, resident=_resident(kmer_set, device)
            )
    with _phase("spss.chain_walk", "unitigs: chain walk"):
        # Start/end tests (reference: lib/core/spss.h:96-146).
        is_start = (indeg != 1) | (outdeg[prv] != 1)
        is_end = (outdeg != 1) | (indeg[nxt] != 1)

        succ = np.where(is_end, -1, nxt)
        starts = np.flatnonzero(is_start)

        chains = None
        if starts.size and _mesh_walks(mesh, succ, False):
            em = _mesh_emit_ordered(
                A, k, succ, starts, False, mesh, by_starts=_native_walk_order()
            )
            if em is not None:
                chains, nodes = em
        if chains is None:
            nodes, groups = _chains_grouped(succ, starts, mesh=mesh)
    with _phase("spss.emission", "unitigs: emission + cycles"):
        if chains is None:
            chains = _emit_kmer_chains(A, k, nodes, groups, oriented=False)
        visited = np.zeros(n, dtype=bool)
        visited[nodes] = True
        cycles = _walk_cycles(A, k, succ, visited, oriented=False, mesh=mesh)
    return _concat_packed([chains, cycles])


# ---------------------------------------------------------------------------
# Greedy path cover over the unitig graph (SPSS proper)
# ---------------------------------------------------------------------------


def _candidate_port_edges_canonical(
    unitigs: PackedStrings, k: int, mesh=None, device=None
) -> Tuple[np.ndarray, np.ndarray]:
    """All (k-1)-overlap port edges of the bidirected unitig graph.

    Ports: 2i = right side of unitig i, 2i+1 = left side.  An edge between
    ports p, q means the two sides can be glued with k-1 overlap
    (reference GetEdgesRight/GetEdgesLeft, lib/core/spss.h:1057-1145).
    The reference looks candidates up in hash multimaps of unitig
    prefixes/suffixes (lib/core/spss.h:619-695); here it is a sorted join.
    Returned deduplicated, ordered by first-discovery priority.  On a
    mesh the join runs there (driver.mesh_overlap_edges) up to k = 30; the
    reference keeps k = 31 on the host join (parallel/mesh.py:1047-1050),
    and so does the port.  With no mesh, where backend.edges_route sends
    the unitigs to `device`, kernel J1 joins and dedups there
    (_device_edges).  The counters edges.device and edges.host count the
    calls each way.
    """
    n = len(unitigs)
    with _phase("spss.first_last", "spss: first/last kmers"):
        P = unitigs.first_kmers(k)
        S = unitigs.last_kmers(k)

    if mesh is None and device is not None and backend.edges_route(n, device):
        return _device_edges(P, S, k, device)
    trace.add("edges.host")
    if k <= mesh_driver.MAX_MESH_OVERLAP_K and mesh_driver.should_use_mesh_graph(mesh, n):
        a, b = mesh_driver.mesh_overlap_edges(P, S, k, mesh=mesh)
        return _dedup_port_edges(a, b, n)
    with _phase("spss.overlap_join", "spss: overlap join"):
        res = native.overlap_edges(P, S, k)
    if res is not None:
        a, b = res
        with _phase("spss.edge_dedup", "spss: edge dedup"):
            return _dedup_port_edges(a, b, n)

    p_order = np.argsort(P, kind="stable")
    s_order = np.argsort(S, kind="stable")
    P_sorted, S_sorted = P[p_order], S[s_order]

    all_a: List[np.ndarray] = []
    all_b: List[np.ndarray] = []

    def _join(queries, sorted_vals, order, src_ports, dst_side_bit):
        lo = np.searchsorted(sorted_vals, queries, side="left")
        hi = np.searchsorted(sorted_vals, queries, side="right")
        rows, idx = expand_ranges(lo, hi)
        j = order[idx]
        a = src_ports[rows]
        b = 2 * j + dst_side_bit
        ok = (a >> 1) != j
        all_a.append(a[ok])
        all_b.append(b[ok])

    ar = np.arange(n, dtype=np.int64)
    for c in range(4):
        q = kmer_ops.next_kmer(S, k, c)
        # right(i) -- left(j): suffix_next == prefix(j)
        _join(q, P_sorted, p_order, 2 * ar, 1)
        # right(i) -- right(j): revcomp(suffix_next) == suffix(j)
        _join(kmer_ops.reverse_complement(q, k), S_sorted, s_order, 2 * ar, 0)
    for c in range(4):
        r = kmer_ops.prev_kmer(P, k, c)
        # left(i) -- right(j): prefix_prev == suffix(j)
        _join(r, S_sorted, s_order, 2 * ar + 1, 0)
        # left(i) -- left(j): revcomp(prefix_prev) == prefix(j)
        _join(kmer_ops.reverse_complement(r, k), P_sorted, p_order, 2 * ar + 1, 1)

    a = np.concatenate(all_a) if all_a else np.empty(0, np.int64)
    b = np.concatenate(all_b) if all_b else np.empty(0, np.int64)
    return _dedup_port_edges(a, b, n)


def _device_edges(P: np.ndarray, S: np.ndarray, k: int, device):
    """The host join's deduplicated edges, found on `device` by kernel J1
    (ops/overlap.py) from the unitigs' first and last k-mers, in the same
    phases and debug lines: the join times the upload and J1 to a
    synchronised end, the dedup (which J1 has done) the download of the
    kept int32 ports and their widening.  A CUDA fault raises: no host
    join hides it."""
    with backend.device_lock(device):
        with _phase("spss.overlap_join", "spss: overlap join"):
            ends = backend.upload("unitig ends", np.stack([P, S]), device)
            pairs = overlap_ops.edges(ends[0], ends[1], k)
            backend.sync(pairs.device)
        with _phase("spss.edge_dedup", "spss: edge dedup"):
            pa, pb = backend.download("overlap edges", pairs).astype(np.int64)
    trace.add("edges.device")
    return pa, pb


def _dedup_port_edges(
    a: np.ndarray, b: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Each undirected edge is discovered from both endpoints; keep the
    first-priority occurrence.  Native one-pass hash dedup when built
    (numpy unique-with-index costs a full sort + stable argsort:
    measured 1.8-3.9 s at 6M edges vs ~0.4 s for the hash pass)."""
    idx = native.dedup_edges(a, b)
    if idx is not None:
        return a[idx], b[idx]
    key = np.minimum(a, b) * (2 * n) + np.maximum(a, b)
    _, first_idx = np.unique(key, return_index=True)
    first_idx.sort()
    return a[first_idx], b[first_idx]


def _candidate_edges_directed(
    unitigs: PackedStrings, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Directed overlap edges i -> j (suffix(i).next == prefix(j), i != j),
    in discovery order (reference GetEdgesOut, lib/core/spss.h:707-727)."""
    P = unitigs.first_kmers(k)
    S = unitigs.last_kmers(k)
    p_order = np.argsort(P, kind="stable")
    P_sorted = P[p_order]
    outs: List[np.ndarray] = []
    ins: List[np.ndarray] = []
    for c in range(4):
        q = kmer_ops.next_kmer(S, k, c)
        lo = np.searchsorted(P_sorted, q, side="left")
        hi = np.searchsorted(P_sorted, q, side="right")
        rows, idx = expand_ranges(lo, hi)
        j = p_order[idx]
        ok = rows != j
        outs.append(rows[ok])
        ins.append(j[ok])
    a = np.concatenate(outs) if outs else np.empty(0, np.int64)
    b = np.concatenate(ins) if ins else np.empty(0, np.int64)
    return a, b


def _break_cycles(
    succ: np.ndarray, match: np.ndarray | None, oriented: bool, mesh=None
) -> np.ndarray:
    """Detects succ-cycles, elects the min-entity leader of each, and cuts
    one edge so every component becomes a chain (replacing union-find
    loop-removal, reference: lib/core/spss.h:877-933,1541-1647).  On a
    mesh the election is min-label pointer doubling there."""
    leaders = None
    if _mesh_walks(mesh, succ, oriented):
        ids = np.arange(succ.shape[0], dtype=np.int64)
        labels = (ids >> 1) if oriented else ids
        _, _, is_chain, mins = mesh_driver.mesh_pointer_double(
            succ, labels, mesh=mesh
        )
        cyc = ~is_chain
        leaders = np.unique(mins[cyc]) if cyc.any() else np.empty(0, np.int64)
    if leaders is None:
        leaders = native.cycle_leaders(succ, oriented)
        if leaders is not None:
            # oriented cycles are discovered once per orientation with the
            # same entity min — collapse mirrors like unique(mins[cyc]) does
            leaders = np.unique(leaders)
    if leaders is None:
        ids = np.arange(succ.shape[0], dtype=np.int64)
        labels = (ids >> 1) if oriented else ids
        _, _, is_chain, mins = pointer_double(succ, labels)
        cyc = ~is_chain
        leaders = np.unique(mins[cyc]) if cyc.any() else np.empty(0, np.int64)
    if leaders.size == 0:
        return succ
    succ = succ.copy()
    if oriented:
        # Cut the match at every leader's left port (reference removes
        # edge_left of the group leader, lib/core/spss.h:1626-1643).  All
        # writes are the constant -1, so the vectorized form is
        # order-independent even if cut ports coincide.
        a = 2 * leaders + 1
        succ[a] = -1
        succ[match[a]] = -1
    else:
        # Cut each leader's outgoing edge (reference:
        # lib/core/spss.h:924-930).
        succ[leaders] = -1
    return succ


def _emit_string_chains(
    unitigs: PackedStrings,
    k: int,
    nodes_sorted: np.ndarray,
    group_starts: np.ndarray,
    oriented: bool,
) -> PackedStrings:
    """Concatenates oriented unitigs along each chain with (k-1)-overlap
    elision (reference GetStringFromPath, lib/core/spss.h:1186-1206)."""
    if nodes_sorted.size == 0:
        return PackedStrings.empty()
    res = native.emit_string_chains(
        unitigs.codes, unitigs.offsets, k, nodes_sorted, group_starts, oriented
    )
    if res is not None:
        return PackedStrings(res[0], res[1])
    n_chains = group_starts.shape[0] - 1
    counts = np.diff(group_starts)
    entity, flip = _entity_flip(nodes_sorted, oriented)
    ulens = unitigs.lengths()[entity]
    group_of = np.repeat(np.arange(n_chains, dtype=np.int64), counts)
    t = np.arange(nodes_sorted.shape[0], dtype=np.int64) - group_starts[group_of]
    contrib = np.where(t == 0, ulens, ulens - (k - 1))

    out_lens = np.zeros(n_chains, dtype=np.int64)
    np.add.at(out_lens, group_of, contrib)
    offsets = np.zeros(n_chains + 1, dtype=np.int64)
    np.cumsum(out_lens, out=offsets[1:])

    contrib_cum = np.cumsum(contrib) - contrib
    chain_base = contrib_cum[group_starts[:-1]]
    node_out_start = offsets[group_of] + (contrib_cum - chain_base[group_of])

    total = int(offsets[-1])
    node_of_char = np.repeat(np.arange(nodes_sorted.shape[0]), contrib)
    within = np.arange(total, dtype=np.int64) - node_out_start[node_of_char]
    skip = np.where(t[node_of_char] == 0, 0, k - 1)
    src = within + skip
    ent_c = entity[node_of_char]
    fwd_idx = unitigs.offsets[ent_c] + src
    rev_idx = unitigs.offsets[ent_c + 1] - 1 - src
    use_rev = flip[node_of_char]
    gather_idx = np.where(use_rev, rev_idx, fwd_idx)
    vals = unitigs.codes[gather_idx].astype(np.int64)
    vals = np.where(use_rev, 3 - vals, vals)
    return PackedStrings(vals.astype(np.uint8), offsets)


def _take_strings(ps: PackedStrings, idx: np.ndarray) -> PackedStrings:
    if idx.size == 0:
        return PackedStrings.empty()
    lens = ps.lengths()[idx]
    offsets = np.zeros(idx.size + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    lo, hi = ps.offsets[idx], ps.offsets[idx + 1]
    codes = native.gather_ranges(ps.codes, lo, hi)
    if codes is None:
        _, within = expand_ranges(lo, hi)
        codes = ps.codes[within]
    return PackedStrings(codes, offsets)


def _emit_matched_paths(
    unitigs: PackedStrings, k: int, succ: np.ndarray, mesh=None
) -> PackedStrings:
    """Emits all maximal paths of a bidirected matched graph, with the
    start-index <= end-index dedup rule (reference:
    lib/core/spss.h:1649-1831)."""
    matched = succ >= 0
    has_right = matched[0::2]
    has_left = matched[1::2]
    both_free = ~has_left & ~has_right
    starts_r = np.flatnonzero(~has_left & has_right) * 2
    starts_l = np.flatnonzero(~has_right & has_left) * 2 + 1
    starts = np.concatenate([starts_r, starts_l])
    nodes, groups = _chains_grouped(succ, starts, oriented=True, mesh=mesh)
    firsts, lasts, nonempty = _group_endpoints(nodes, groups)
    keep = nonempty & ((firsts >> 1) <= (lasts >> 1))
    nodes_kept, groups_kept = _filter_groups(nodes, groups, keep)
    chains = _emit_string_chains(unitigs, k, nodes_kept, groups_kept, oriented=True)
    solo = _take_strings(unitigs, np.flatnonzero(both_free))
    return _concat_packed([chains, solo])


def get_spss_canonical_from_unitigs(
    unitigs: PackedStrings, k: int, fast: bool = True, mesh=None, device=None
) -> PackedStrings:
    """Greedy path cover of the bidirected unitig graph
    (reference: lib/core/spss.h:1039-1858); with a `mesh`, its overlap
    edges, matching, cycle breaking and chain grouping run there; with
    a CUDA `device` and no mesh, its overlap edges may run there
    (_candidate_port_edges_canonical)."""
    n = len(unitigs)
    if n == 0:
        return PackedStrings.empty()
    with _phase("spss.candidate_edges", "spss: candidate overlap edges"):
        pa, pb = _candidate_port_edges_canonical(unitigs, k, mesh, device)
    with _phase("spss.matching", "spss: greedy matching"):
        if not fast:
            match = _sequential_matching(n, pa, pb)
        else:
            match = handshake_matching(pa, pb, 2 * n, mesh=mesh)

    # Exiting port u continues through the matched partner port and leaves
    # by that node's other side: succ[u] = match[u] ^ 1.
    succ = np.where(match >= 0, match ^ 1, -1)
    if fast:
        with _phase("spss.cycle_breaking", "spss: cycle breaking"):
            succ = _break_cycles(succ, match, oriented=True, mesh=mesh)
    with _phase("spss.path_emission", "spss: path emission"):
        return _emit_matched_paths(unitigs, k, succ, mesh)


def get_spss_from_unitigs(
    unitigs: PackedStrings, k: int, mesh=None
) -> PackedStrings:
    """Greedy path cover of the directed unitig graph
    (reference: lib/core/spss.h:697-1016); with a `mesh`, its matching,
    cycle breaking and chain grouping run there."""
    n = len(unitigs)
    if n == 0:
        return PackedStrings.empty()
    ea, eb = _candidate_edges_directed(unitigs, k)
    # Ports: out-port of i = 2i, in-port of j = 2j+1; the matching enforces
    # <=1 selected out- and in-edge per node (reference:
    # lib/core/spss.h:796-817).
    match = handshake_matching(2 * ea, 2 * eb + 1, 2 * n, mesh=mesh)
    succ = np.where(match[0::2] >= 0, match[0::2] >> 1, -1)
    succ = _break_cycles(succ, None, oriented=False, mesh=mesh)

    has_in = np.zeros(n, dtype=bool)
    has_in[succ[succ >= 0]] = True
    starts = np.flatnonzero(~has_in)
    nodes, groups = _chains_grouped(succ, starts, mesh=mesh)
    return _emit_string_chains(unitigs, k, nodes, groups, oriented=False)


# ---------------------------------------------------------------------------
# Top-level entry points (reference: lib/core/spss.h:1018-1036,1834-1858)
# ---------------------------------------------------------------------------


def get_spss(kmer_set: KmerSet, *, device, mesh=None) -> PackedStrings:
    unitigs = get_unitigs(kmer_set, device=device, mesh=mesh)
    with _phase("spss.path_cover", "spss: path cover"):
        return get_spss_from_unitigs(unitigs, kmer_set.k, mesh)


def get_spss_canonical(
    kmer_set: KmerSet, fast: bool = True, *, device, mesh=None
) -> PackedStrings:
    unitigs = get_unitigs_canonical(kmer_set, device=device, mesh=mesh)
    with _phase("spss.path_cover", "spss: path cover"):
        return get_spss_canonical_from_unitigs(unitigs, kmer_set.k, fast, mesh,
                                               device)


def decode_unique_kmers(
    spss: PackedStrings, k: int, canonical: bool, *, device, mesh=None
) -> np.ndarray:
    """Sorted distinct (canonical) k-mers of an SPSS, counted at cutoff 1
    on `mesh` (driver.mesh_count, keys only) where its gate takes the
    windows, else on `device`: the span "spss.decode"."""
    n_windows = int(spss.codes.shape[0]) - k + 1
    if n_windows <= 0:
        return np.empty(0, np.int64)
    with trace.span("spss.decode", windows=n_windows):
        return _decode_unique(spss, k, canonical, n_windows, device, mesh)


def _decode_unique(spss: PackedStrings, k: int, canonical: bool,
                   n_windows: int, device, mesh) -> np.ndarray:
    if mesh_driver.should_use_mesh(mesh, n_windows):
        return mesh_driver.mesh_count(
            spss.codes, spss.offsets, k, canonical, mesh, need_counts=False
        )[0]
    chunk = backend.count_plan("decode", n_windows, k, device)
    if chunk < n_windows:
        return backend.device_unique_chunked(
            spss.codes, spss.offsets, k, canonical, device=device,
            chunk_windows=chunk,
        )
    return backend.device_unique(
        spss.codes, spss.offsets, k, canonical, device=device
    )


def get_kmer_set_from_spss(
    spss: PackedStrings, k: int, canonical: bool, *, device, mesh=None
) -> KmerSet:
    return KmerSet(
        k, decode_unique_kmers(spss, k, canonical, device=device, mesh=mesh),
        _sorted=True,
    )


# ---------------------------------------------------------------------------
# Sequential reference-quality matching (fast=false) for spss-benchmark
# ---------------------------------------------------------------------------


def _sequential_matching(n: int, pa: np.ndarray, pb: np.ndarray) -> np.ndarray:
    """Single-threaded greedy path extension, the reference's
    higher-quality mode (reference: lib/core/spss.h:1208-1356).  Exists for
    the spss-benchmark A/B comparison; native one-pass C when available
    (the Python loop below is its byte-identical specification)."""
    nm = native.seq_match(pa, pb, n)
    if nm is not None:
        return nm
    adj: List[List[int]] = [[] for _ in range(2 * n)]
    for a, b in zip(pa.tolist(), pb.tolist()):
        adj[a].append(b)
        adj[b].append(a)
    match = np.full(2 * n, -1, dtype=np.int64)

    for i in range(n):
        if match[2 * i] >= 0 or match[2 * i + 1] >= 0:
            continue
        if adj[2 * i]:
            port = 2 * i
        elif adj[2 * i + 1]:
            port = 2 * i + 1
        else:
            continue
        while True:
            if match[port] >= 0:
                break
            nxt = -1
            for q in adj[port]:
                if (q >> 1) == i:  # would close a loop with the path start
                    continue
                if match[q] >= 0:
                    continue
                nxt = q
                break
            if nxt < 0:
                break
            match[port] = nxt
            match[nxt] = port
            port = nxt ^ 1
    return match
