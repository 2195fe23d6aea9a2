"""A 1-D mesh of shards over the k-mer key space, its collectives, and the
shard programs of kmerset-build and of the multi-set CLIs.

Counterpart of kmerset_tpu/parallel/mesh.py: make_mesh and _owner_edges
(:44-69), the collectives its shard_map bodies use (all_to_all, psum,
all_gather), the build half of its programs: sharded_count_fn
(:71-135), the side tables and unitig front-end (:138-516), pointer
doubling (:518-601), chain grouping and emission (:699-864), matching
(:866-1037) and overlap edges (:1039-1164); and the multi-set half:
sharded_hash_fn, sharded_set_algebra_fn and sharded_sketch_weights_fn
(:602-697).

A Mesh is a list of shards, each on an explicit torch.device; several
shards may share one device (the CPU tests and a one-card machine run
meshes of 3, 4 or 8 shards that way, as the reference's tests run 8
virtual XLA CPU devices).  Shard d owns either a key range
(owner_edges: counting, side tables, overlap edges) or a stride of node
ids [d * cap, (d + 1) * cap) (pointer doubling, grouping, matching), as
in the reference.  Each program here is the reference's per-device step
run shard by shard in one process, with every exchange between shards
going through Mesh.all_to_all, so that a multi-process edition can swap
in torch.distributed behind the same calls.

What differs from the reference's programs, which are XLA code with
static shapes:
- exchanges send exact split sizes (the owner of each record, counted
  with one bincount), so there is no per-lane capacity, no `dropped`
  count and no retry with a doubled capacity;
- an owner answers a routed query by a gather at its local index, or by
  ops/join.lookup_join, where the reference sort-joins and scans with
  cummax because a TPU gather is slow; answers return by a scatter to
  the query's slot, where the reference re-sorts by slot;
- keys and node ids are int64 throughout (the reference's int32 lanes
  halve TPU bytes).  Where the reference packs int32 fields its guards
  stay: pointer doubling's dist is int32, masked to 30 bits where it is
  exchanged (:538-545), and the driver keeps node ids below 2^30.
Every program raises on an error; none returns a "fall back" marker.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..ops import backend
from ..ops import count as count_ops
from ..ops.compact import compact_select
from ..ops.join import lookup_join
from ..ops.neighbors import candidates, reverse_complement, tables
from ..ops.pack import S_SENT, SENTINEL, key_dtype, key_sentinel
from ..ops.sketch import _row_intersections

# Pointer doubling exchanges dist in 30 bits beside the done flag
# (reference mesh.py:538-545): cycle nodes' dist doubles each round.
DIST_MASK = (1 << 30) - 1


class Mesh:
    """Shards of a 1-D mesh, each on a torch.device (reference make_mesh,
    mesh.py:44-59).  `forced`: routed to the mesh whatever the input's
    size, as an explicit mesh is (the reference's forced mesh backend,
    driver.py:79-81); an automatic mesh (driver.auto_mesh) is taken only
    above the reference's size gates."""

    def __init__(self, devices: Sequence, *, forced: bool = True):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one shard")
        self.devices = devs
        self.forced = forced

    @property
    def size(self) -> int:
        return len(self.devices)

    def physical_of(self, shard: int) -> torch.device:
        """The physical device of one shard (a bare `cuda` is the current
        one)."""
        d = self.devices[shard]
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return d

    def physical(self) -> Dict[torch.device, int]:
        """Each physical device of the mesh with the number of shards it
        holds, in device order."""
        counts: Dict[torch.device, int] = {}
        for d in range(self.size):
            dev = self.physical_of(d)
            counts[dev] = counts.get(dev, 0) + 1
        return dict(sorted(counts.items(), key=lambda kv: (kv[0].type, kv[0].index or 0)))

    @contextlib.contextmanager
    def lock(self):
        """Holds backend.device_lock of every physical device of the mesh,
        each once and in device order (the lock is not reentrant, and
        shards share devices), for one mesh step."""
        with contextlib.ExitStack() as stack:
            for d in self.physical():
                stack.enter_context(backend.device_lock(d))
            yield

    def all_to_all(self, parts: List[List[torch.Tensor]]) -> List[List[torch.Tensor]]:
        """parts[src][dst], a 1-D tensor on shard src's device, arrives as
        recv[dst][src] on shard dst's device.  The split sizes are the
        parts' own lengths; a process-group edition exchanges them first
        and then sends with exactly those sizes."""
        n = self.size
        if len(parts) != n or any(len(row) != n for row in parts):
            raise ValueError(f"all_to_all takes {n} x {n} parts")
        return [[parts[s][d].to(self.devices[d]) for s in range(n)]
                for d in range(n)]

    def all_gather(self, values: Sequence[int]) -> List[int]:
        """Every shard's value (a host int), on every shard."""
        if len(values) != self.size:
            raise ValueError(f"all_gather takes {self.size} values")
        return [int(v) for v in values]

    def psum(self, values: Sequence[int]) -> int:
        """The sum of every shard's value (a host int)."""
        return sum(self.all_gather(values))

    def _reduce(self, values: Sequence[torch.Tensor], shard: int, op):
        if len(values) != self.size:
            raise ValueError(f"a reduction takes {self.size} tensors")
        if any(v.shape != values[0].shape for v in values):
            raise ValueError("a reduction takes one same-shaped tensor per shard")
        dev = self.devices[shard]
        out = values[0].to(dev)
        for v in values[1:]:
            out = op(out, v.to(dev))
        return out

    def sum_to(self, values: Sequence[torch.Tensor], shard: int = 0) -> torch.Tensor:
        """The element-wise sum of one same-shaped tensor per shard, on
        shard `shard`'s device (the reference's psum of a vector)."""
        return self._reduce(values, shard, torch.add)

    def xor_to(self, values: Sequence[torch.Tensor], shard: int = 0) -> torch.Tensor:
        """The element-wise XOR of one same-shaped integer tensor per shard,
        on shard `shard`'s device (the reference's all_gather + XOR)."""
        return self._reduce(values, shard, torch.bitwise_xor)

    def __str__(self) -> str:
        cards = ",".join(str(d) for d in self.physical())
        return f"mesh of {self.size} shards ({cards})"


def owner_edges(k: int, n_shards: int) -> np.ndarray:
    """Key-range boundaries: shard d owns [edges[d], edges[d + 1])
    (reference _owner_edges, mesh.py:62-67)."""
    space = 1 << (2 * k)
    i = np.arange(n_shards + 1, dtype=np.int64)
    return i * (space // n_shards) + np.minimum(i, space % n_shards)


def _key_owner(edges: np.ndarray, keys: torch.Tensor) -> torch.Tensor:
    """The shard owning each key under owner_edges `edges`."""
    inner = torch.from_numpy(edges[1:-1]).to(device=keys.device, dtype=keys.dtype)
    return torch.searchsorted(inner, keys, right=True)


class Routing(NamedTuple):
    """How to_owners sent each source shard's records: their positions,
    grouped by owner, and the counts per owner."""
    order: List[torch.Tensor]
    sizes: List[List[int]]
    lengths: List[int]


def to_owners(mesh: Mesh, owners, lanes, valid=None):
    """Sends records to their owner shards.  owners[s] (int64) names the
    owner of each record of shard s, lanes[s] is a list of 1-D tensors
    aligned with it, and valid[s] (optional, bool) selects the records
    that travel.  Returns (recv, routing): recv[d] is shard d's list of
    lanes, every source's records concatenated in source order (each in
    its own order), and routing serves from_owners."""
    n = mesh.size
    order, sizes, lengths = [], [], []
    parts = [[] for _ in range(n)]
    for s in range(n):
        own = owners[s]
        lengths.append(int(own.shape[0]))
        if valid is None:
            idx = torch.arange(own.shape[0], device=own.device)
        else:
            idx = torch.nonzero(valid[s]).squeeze(1)
        own = own[idx]
        srt = torch.argsort(own, stable=True)
        idx = idx[srt]
        cnt = torch.bincount(own, minlength=n).tolist()
        order.append(idx)
        sizes.append(cnt)
        parts[s] = [list(torch.split(lane[idx], cnt)) for lane in lanes[s]]
    n_lanes = len(lanes[0])
    recv = [[] for _ in range(n)]
    for j in range(n_lanes):
        got = mesh.all_to_all([[parts[s][j][d] for d in range(n)] for s in range(n)])
        for d in range(n):
            recv[d].append(torch.cat(got[d]))
    return recv, Routing(order, sizes, lengths)


def from_owners(mesh: Mesh, routing: Routing, answers, fill: int = 0):
    """Returns each owner's answers to the records to_owners brought it
    (answers[d]: a list of lanes aligned with recv[d]) to their source
    slots: out[s] is a list of lanes of shard s's record count, `fill`
    where a record did not travel."""
    n = mesh.size
    recv_sizes = [[routing.sizes[s][d] for s in range(n)] for d in range(n)]
    n_lanes = len(answers[0])
    out = [[] for _ in range(n)]
    for j in range(n_lanes):
        parts = [list(torch.split(answers[d][j], recv_sizes[d])) for d in range(n)]
        got = mesh.all_to_all(parts)
        for s in range(n):
            a = torch.cat(got[s])
            full = torch.full((routing.lengths[s],), fill, dtype=a.dtype,
                              device=a.device)
            full[routing.order[s]] = a
            out[s].append(full)
    return out


# -- counting (reference mesh.py:71-135) -----------------------------------


def sharded_count(mesh: Mesh, staged, k: int, canonical: bool,
                  need_counts: bool = True):
    """Each shard's window keys (staged[d]: backend.Staged on shard d's
    device, or None for a shard without windows) packed by kernel B1 or
    B2 and sorted, split at the owner edges and sent to their owners;
    each owner sorts what it received, takes the run heads, compacts them
    with kernel B3 and counts.  Returns per owner (keys, counts): its key
    range's sorted distinct keys (int32 for k <= 15, int64 above) and
    int32 counts (None without need_counts)."""
    n = mesh.size
    edges = owner_edges(k, n)
    sent = key_sentinel(k)
    parts = []
    for d, st in enumerate(staged):
        dev = mesh.devices[d]
        if st is None:
            parts.append([torch.empty(0, dtype=key_dtype(k), device=dev)] * n)
            continue
        s = count_ops.sorted_window_keys(*st, k, canonical)
        live = s[: int((s != sent).sum())]
        inner = torch.from_numpy(edges[1:-1]).to(device=dev, dtype=s.dtype)
        cuts = [0, *torch.searchsorted(live, inner).tolist(), live.shape[0]]
        parts.append([live[a:b] for a, b in zip(cuts, cuts[1:])])
    recv = mesh.all_to_all(parts)
    out = []
    for d in range(n):
        mine = torch.sort(torch.cat(recv[d])).values
        boundary = mine != torch.cat([mine.new_full((1,), -1), mine[:-1]])
        if need_counts:
            keys, counts, _ = count_ops.count_runs(
                mine, torch.ones_like(boundary), boundary)
            out.append((keys, counts))
        else:
            (keys,), n_sel = compact_select([mine], boundary)
            out.append((keys[: int(n_sel)], None))
    return out


# -- side tables and the unitig front-end (reference mesh.py:261-516) -------


def _side_table_round(mesh: Mesh, edges: np.ndarray, queries, blocks,
                      offs: Sequence[int], k: int, canonical: bool):
    """The side-table rows of queries[d] (k-mers of shard d's block) in
    the whole set: every candidate routed to the owner of its key, which
    answers its membership and position; the answers return to the
    candidate's slot."""
    n = mesh.size
    cands, owners, lanes = [], [], []
    for d in range(n):
        ncan, same = candidates(queries[d], k, canonical)
        cands.append((ncan, same))
        flat = ncan.reshape(-1)
        owners.append(_key_owner(edges, flat))
        lanes.append([flat])
    recv, routing = to_owners(mesh, owners, lanes)
    answers = []
    for d in range(n):
        found, idx = lookup_join(blocks[d], recv[d][0])
        answers.append([torch.where(found, idx + offs[d], -1)])
    back = from_owners(mesh, routing, answers, fill=-1)
    out = []
    for d in range(n):
        ans = back[d][0].view(8, -1)
        ncan, same = cands[d]
        out.append(tables(queries[d], ncan, same, ans >= 0, ans.clamp(min=0)))
    return out


def sharded_side_tables(mesh: Mesh, blocks, offs: Sequence[int], k: int,
                        canonical: bool, query_chunk: Optional[int] = None):
    """Side tables of the sorted set held as key-range blocks (blocks[d]:
    int64 on shard d, offs[d] its position in the whole set), as
    ops/neighbors.side_tables builds them, with nbr a position in the
    whole set (the reference's dense global ids).  Each shard's k-mers are
    queried in rounds of at most `query_chunk` (all of its block in one
    round by default), which bound the candidates in flight; the rows are
    the same at every chunk size."""
    edges = owner_edges(k, mesh.size)
    longest = max(b.shape[0] for b in blocks)
    q = longest if query_chunk is None else query_chunk
    if q < 1 and longest:
        raise ValueError(f"query_chunk must be >= 1, got {query_chunk}")
    if q >= longest:
        return _side_table_round(mesh, edges, blocks, blocks, offs, k, canonical)
    out = []
    for b in blocks:
        m, dev = b.shape[0], b.device
        out.append(tuple((torch.empty(m, dtype=torch.int32, device=dev),
                          torch.empty(m, dtype=torch.int64, device=dev),
                          torch.empty(m, dtype=torch.bool, device=dev))
                         for _ in range(2)))
    for lo in range(0, longest, q):
        rows = _side_table_round(mesh, edges, [b[lo:lo + q] for b in blocks],
                                 blocks, offs, k, canonical)
        for whole, part in zip(out, rows):
            for w_side, p_side in zip(whole, part):
                for w, p in zip(w_side, p_side):
                    w[lo:lo + p.shape[0]] = p
    return out


def sharded_unitig_succ(mesh: Mesh, blocks, offs: Sequence[int], k: int,
                        query_chunk: Optional[int] = None):
    """The canonical unitig front-end on the mesh (reference
    sharded_unitig_succ_fn, mesh.py:396-464): the side tables, then each
    side's unique neighbour's degree pair fetched from the owner of its
    position, then the terminal tests and the oriented successor.
    Returns per shard (succ_r, succ_l, term_l, term_r): succ int64, -1 at
    a terminal exit, else 2 * nbr + flip with nbr a position in the whole
    set.  query_chunk: sharded_side_tables'."""
    n = mesh.size
    rows = sharded_side_tables(mesh, blocks, offs, k, True, query_chunk)
    bounds = np.asarray(offs[1:], dtype=np.int64)
    owners, lanes, valid = [], [], []
    for d in range(n):
        (rdeg, rnbr, _), (ldeg, lnbr, _) = rows[d]
        q = torch.cat([rnbr, lnbr])
        inner = torch.from_numpy(bounds).to(q.device)
        owners.append(torch.searchsorted(inner, q, right=True))
        lanes.append([q])
        valid.append(torch.cat([rdeg > 0, ldeg > 0]))
    recv, routing = to_owners(mesh, owners, lanes, valid)
    answers = []
    for d in range(n):
        (rdeg, _, _), (ldeg, _, _) = rows[d]
        loc = recv[d][0] - offs[d]
        answers.append([rdeg[loc] | (ldeg[loc] << 3)])
    back = from_owners(mesh, routing, answers)
    out = []
    for d in range(n):
        (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = rows[d]
        m = rdeg.shape[0]
        mr, ml = back[d][0][:m], back[d][0][m:]
        mate_r = torch.where(rsame, mr & 7, (mr >> 3) & 7)
        mate_l = torch.where(lsame, (ml >> 3) & 7, ml & 7)
        # Terminal tests and oriented successor (reference: lib/core/
        # spss.h:276-313,394-423).
        term_r = (rdeg != 1) | (mate_r != 1)
        term_l = (ldeg != 1) | (mate_l != 1)
        succ_r = torch.where(term_r, -1, 2 * rnbr + rsame)
        succ_l = torch.where(term_l, -1, 2 * lnbr + (~lsame).to(torch.int64))
        out.append((succ_r, succ_l, term_l, term_r))
    return out


# -- pointer doubling (reference mesh.py:518-601) ---------------------------


def sharded_pointer_double(mesh: Mesh, succ, labels, cap: int, rounds: int):
    """Pointer doubling over a stride-sharded successor array (succ[d]:
    int64 (cap,) on shard d for nodes [d * cap, (d + 1) * cap), -1 at a
    chain end) with optional running min-labels (labels[d] or None).
    Each round routes every unresolved node's pointer to its owner, which
    answers (done, dist & DIST_MASK, ptr, label) as they stood at the
    round's start, and applies the reference's update (mesh.py:561-589).
    A round in which every node is resolved changes nothing, so the loop
    stops there.  Returns per shard (end, dist int32, is_chain, min_label
    or None)."""
    n = mesh.size
    st = []
    for d in range(n):
        s = succ[d]
        ids = torch.arange(cap, dtype=torch.int64, device=s.device) + d * cap
        done0 = s < 0
        st.append({
            "done0": done0, "reached": done0.clone(),
            "ptr": torch.where(done0, ids, s),
            "dist": (~done0).to(torch.int32),
            "lab": labels[d] if labels is not None else None,
        })
    for _ in range(rounds):
        if mesh.psum([int((~x["reached"]).sum()) for x in st]) == 0:
            break
        recv, routing = to_owners(
            mesh, [x["ptr"] // cap for x in st], [[x["ptr"]] for x in st],
            [~x["reached"] for x in st])
        answers = []
        for d, x in enumerate(st):
            loc = recv[d][0] - d * cap
            lanes = [x["done0"][loc], x["dist"][loc] & DIST_MASK, x["ptr"][loc]]
            if labels is not None:
                lanes.append(x["lab"][loc])
            answers.append(lanes)
        back = from_owners(mesh, routing, answers)
        for x, ans in zip(st, back):
            frozen = x["reached"]
            t_done, t_dist, t_ptr = ans[:3]
            if labels is not None:
                x["lab"] = torch.where(frozen, x["lab"],
                                       torch.minimum(x["lab"], ans[3]))
            x["dist"] = torch.where(
                frozen, x["dist"], x["dist"] + torch.where(t_done, 0, t_dist))
            x["ptr"] = torch.where(frozen | t_done, x["ptr"], t_ptr)
            x["reached"] = frozen | t_done
    return [(x["ptr"], x["dist"], x["reached"], x["lab"]) for x in st]


# -- chain grouping and emission (reference mesh.py:699-864) ----------------


def sharded_group_by_end(mesh: Mesh, end, dist, sel, cap: int, lanes=None):
    """Routes each selected node record (end, dist, node id, *lanes) to
    the owner of its end id (stride layout) and sorts it there by (end
    ascending, dist descending), so that every chain lies start to end,
    contiguously, and the owners' blocks concatenate in end order
    (reference _group_records_by_end, mesh.py:699-741).  End ids and
    dists are below 2^30 (the driver keeps node ids there), so one int64
    sort key orders both.  Returns per owner the sorted (end, ids,
    *lanes)."""
    n = mesh.size
    recs = []
    for d in range(n):
        ids = torch.arange(cap, dtype=torch.int64, device=end[d].device) + d * cap
        recs.append([end[d], dist[d], ids, *(lanes[d] if lanes else [])])
    recv, _ = to_owners(mesh, [e // cap for e in end], recs, sel)
    out = []
    for r in recv:
        e, dd = r[0], r[1].to(torch.int64)
        order = torch.argsort((e << 30) | (0x3FFFFFFF - dd))
        out.append([e[order], *(x[order] for x in r[2:])])
    return out


def render_chains(ends: torch.Tensor, ov: torch.Tensor, k: int) -> torch.Tensor:
    """The 2-bit base codes (uint8) of grouped chain records: the first
    record of each end's group contributes its k-mer's k codes, every
    following record its last code (reference sharded_emit_fn,
    mesh.py:819-845, and ConcatenateKmers, lib/core/spss.h:25-41); ov
    holds each record's oriented k-mer value."""
    m = ends.shape[0]
    if m == 0:
        return torch.empty(0, dtype=torch.uint8, device=ends.device)
    head = torch.ones_like(ends, dtype=torch.bool)
    head[1:] = ends[1:] != ends[:-1]
    L = torch.where(head, k, 1)
    off = torch.cumsum(L, 0) - L
    codes = torch.empty(int(L.sum()), dtype=torch.uint8, device=ends.device)
    rest = ~head
    codes[off[rest]] = (ov[rest] & 3).to(torch.uint8)
    j = torch.arange(k, dtype=torch.int64, device=ends.device)
    h = torch.nonzero(head).squeeze(1)
    codes[off[h][:, None] + j] = ((ov[h][:, None] >> (2 * (k - 1 - j))) & 3).to(torch.uint8)
    return codes


def oriented_values(A_part: torch.Tensor, first_entity: int, ids: torch.Tensor,
                    k: int, oriented: bool) -> torch.Tensor:
    """Each node's k-mer as its walk reads it: A[entity], reverse
    complemented where an oriented node's flip bit is set.  A_part holds
    the entities from first_entity that the node ids of one shard reach;
    ids past them (padding) read entity 0 of the part."""
    ent = (ids >> 1) if oriented else ids
    if A_part.shape[0] == 0:
        return torch.zeros_like(ids)
    ent = (ent - first_entity).clamp_(0, A_part.shape[0] - 1)
    vals = A_part[ent]
    if not oriented:
        return vals
    return torch.where((ids & 1) == 1, reverse_complement(vals, k), vals)


# -- greedy matching (reference mesh.py:866-1037) ---------------------------


def sharded_matching(mesh: Mesh, pa, pb, ecap: int, pcap: int):
    """Priority-ordered greedy matching over stride-sharded ports (port p
    on shard p // pcap) and edges (pa[d], pb[d]: int64 (ecap,) on shard d,
    edge priority d * ecap + i, padding -1).  Each round: (A) live edges
    ask both ports' owners whether the port is free; (B) live edges send
    (port, priority) to the ports' owners, which answer each port's least
    priority; (C) edges least at both ports win and claim both ports.  The
    greedy matching is unique, so this equals core/graph.
    handshake_matching.  Returns per shard its (pcap,) match (-1 free)."""
    n = mesh.size
    st = []
    for d in range(n):
        dev = pa[d].device
        st.append({
            "free": torch.ones(pcap, dtype=torch.bool, device=dev),
            "match": torch.full((pcap,), -1, dtype=torch.int64, device=dev),
            "alive": pa[d] >= 0,
            "prio": torch.arange(ecap, dtype=torch.int64, device=dev) + d * ecap,
            "ports": torch.cat([pa[d], pb[d]]),
        })
    owners = [x["ports"] // pcap for x in st]
    big = torch.iinfo(torch.int64).max
    while mesh.psum([int(x["alive"].sum()) for x in st]) > 0:
        # (A) both ports still free?
        recv, routing = to_owners(mesh, owners, [[x["ports"]] for x in st],
                                  [x["alive"].repeat(2) for x in st])
        answers = [[st[d]["free"][recv[d][0] - d * pcap]] for d in range(n)]
        for x, (free,) in zip(st, from_owners(mesh, routing, answers)):
            x["alive"] = x["alive"] & free[:ecap] & free[ecap:]
        # (B) each port's least live priority, answered at every record.
        recv, routing = to_owners(
            mesh, owners, [[x["ports"], x["prio"].repeat(2)] for x in st],
            [x["alive"].repeat(2) for x in st])
        answers = []
        for d in range(n):
            loc = recv[d][0] - d * pcap
            best = torch.full((pcap,), big, dtype=torch.int64, device=loc.device)
            best.scatter_reduce_(0, loc, recv[d][1], "amin")
            answers.append([best[loc]])
        back = from_owners(mesh, routing, answers, fill=-1)
        wins = [x["alive"] & (b[:ecap] == x["prio"]) & (b[ecap:] == x["prio"])
                for x, (b,) in zip(st, back)]
        # (C) winners claim both ports: (port, partner) to each owner.
        partner = [torch.cat([pb[d], pa[d]]) for d in range(n)]
        recv, _ = to_owners(mesh, owners,
                            [[x["ports"], p] for x, p in zip(st, partner)],
                            [w.repeat(2) for w in wins])
        for d, x in enumerate(st):
            loc = recv[d][0] - d * pcap
            x["match"][loc] = recv[d][1]
            x["free"][loc] = False
            x["alive"] = x["alive"] & ~wins[d]
    return [x["match"] for x in st]


# -- overlap edges (reference mesh.py:1039-1164) ----------------------------


def sharded_overlap_edges(mesh: Mesh, P, S, k: int, ucap: int):
    """Overlap-edge discovery over stride-sharded unitigs (P[d], S[d]:
    int64 first and last k-mers of unitigs [d * ucap, ...) on shard d).
    Each shard sends (value << 1 | table bit, unitig id) of its P and S
    to the key's owner, which sorts them into its part of the table; then
    the 16 gluing candidates of every unitig, in the host join's
    discovery order, are routed to their owners and answered with the
    partner's id (-1 where absent).  Keys are unique across an SPSS's
    unitigs; a duplicate raises.  Returns per shard (16, m_d) int64."""
    n = mesh.size
    edges2 = owner_edges(k, n) * 2
    kmask = (1 << (2 * k)) - 1
    owners, recs = [], []
    for d in range(n):
        p, s = P[d], S[d]
        ids = torch.arange(p.shape[0], dtype=torch.int64, device=p.device) + d * ucap
        key = torch.cat([p << 1, (s << 1) | 1])
        owners.append(_key_owner(edges2, key))
        recs.append([key, torch.cat([ids, ids])])
    recv, _ = to_owners(mesh, owners, recs)
    table = []
    for tk, tv in recv:
        tk, order = torch.sort(tk)
        if bool((tk[1:] == tk[:-1]).any()):
            raise ValueError(
                "overlap edges: duplicate first or last k-mers across the "
                "unitigs (every k-mer of an SPSS appears once)")
        table.append((tk, tv[order]))
    owners, probes = [], []
    for d in range(n):
        p, s = P[d], S[d]
        qs = []
        for c in range(4):
            nx = ((s << 2) | c) & kmask
            qs.append(nx << 1)  # right(i)-left(j): against P
            qs.append((reverse_complement(nx, k) << 1) | 1)  # right-right: S
        for c in range(4):
            pv = (p >> 2) | (c << (2 * (k - 1)))
            qs.append((pv << 1) | 1)  # left(i)-right(j): against S
            qs.append(reverse_complement(pv, k) << 1)  # left-left: P
        q = torch.stack(qs).reshape(-1)
        owners.append(_key_owner(edges2, q))
        probes.append([q])
    recv, routing = to_owners(mesh, owners, probes)
    answers = []
    for d in range(n):
        tk, tv = table[d]
        found, idx = lookup_join(tk, recv[d][0])
        answers.append([torch.where(found, tv[idx], -1) if tk.numel()
                        else torch.full_like(recv[d][0], -1)])
    back = from_owners(mesh, routing, answers, fill=-1)
    return [b[0].view(16, -1) for b in back]


# -- the multi-set programs (reference mesh.py:602-697) ----------------------


def _live(block: torch.Tensor) -> torch.Tensor:
    """The keys of a sorted block before its sentinel padding (S_SENT for
    int32 keys, SENTINEL for int64: ops/pack.key_sentinel)."""
    sent = S_SENT if block.dtype == torch.int32 else SENTINEL
    return block[: int((block != sent).sum())]


def _xor_all(x: torch.Tensor) -> torch.Tensor:
    """The XOR of every element of a 1-D integer tensor, as a 0-dim tensor
    (0 for none): halves folded onto each other, log2(n) steps."""
    if x.numel() == 0:
        return torch.zeros((), dtype=x.dtype, device=x.device)
    while x.numel() > 1:
        if x.numel() % 2:
            x = torch.cat([x, x.new_zeros(1)])
        h = x.numel() // 2
        x = x[:h] ^ x[h:]
    return x[0]


def sharded_hash(mesh: Mesh, blocks) -> int:
    """The order-independent XOR hash of a key-range-sharded sorted set
    (blocks[d]: shard d's sorted keys on its device, sentinel padding
    allowed), as KmerSet.hash returns it (reference sharded_hash_fn,
    mesh.py:602-618): each shard XORs its live keys, the mesh's XOR
    reduction joins them.  The empty set hashes to 0."""
    parts = [_xor_all(_live(b)).to(torch.int64) for b in blocks]
    return int(mesh.xor_to(parts)) & ((1 << 64) - 1)


def _members(x: torch.Tensor, sorted_y: torch.Tensor) -> torch.Tensor:
    """Whether each element of x is in the sorted tensor sorted_y."""
    if sorted_y.numel() == 0:
        return torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    pos = torch.searchsorted(sorted_y, x).clamp_(max=sorted_y.numel() - 1)
    return sorted_y[pos] == x


def _select(x: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """x[keep] in order, through kernel B3 (ops/compact.compact_select)."""
    (out,), n_sel = compact_select([x], keep)
    return out[: int(n_sel)]


def sharded_set_algebra(mesh: Mesh, a_blocks, b_blocks):
    """Intersection and both differences of two sets held as key-range
    blocks split at the same owner edges (a_blocks[d], b_blocks[d]: shard
    d's sorted unique keys, sentinel padding allowed), each shard alone
    (reference sharded_set_algebra_fn, mesh.py:620-665).  Where the
    reference classifies a (key, tag) sort and compacts with a second
    sort, each shard here tests membership with a torch.searchsorted of
    one block into the other and keeps each class in order with kernel B3
    (ops/compact.compact_select): the blocks are sorted already.  Returns
    (inter, a_only, b_only, sizes): per shard its sorted blocks of A ∩ B,
    A - B and B - A, and the global sizes (3,) int64 on shard 0, summed by
    the mesh's reduction."""
    inter, a_only, b_only, sizes = [], [], [], []
    for a, b in zip(a_blocks, b_blocks):
        a, b = _live(a), _live(b)
        in_b = _members(a, b)
        inter.append(_select(a, in_b))
        a_only.append(_select(a, ~in_b))
        b_only.append(_select(b, ~_members(b, a)))
        sizes.append(torch.tensor([inter[-1].numel(), a_only[-1].numel(),
                                   b_only[-1].numel()], dtype=torch.int64,
                                  device=a.device))
    return inter, a_only, b_only, mesh.sum_to(sizes)


def sharded_sketch_weights(mesh: Mesh, blocks, pairs: torch.Tensor) -> torch.Tensor:
    """Pairwise sketch-intersection sizes over key-range-sharded sketches
    (reference sharded_sketch_weights_fn, mesh.py:667-697): blocks[d] is
    shard d's (rows, S_d) int64 matrix, its key range of every sketch
    (each row sorted, duplicate-free, SENTINEL-padded, S_d >= 1), and
    pairs a (P, 2) int64 tensor of row pairs.  Each shard answers every
    pair on its own range with ops/sketch._row_intersections (a batched
    searchsorted, no sort); the mesh's reduction sums the partial counts.
    Sketches never move.  Returns (P,) int64 on shard 0."""
    parts = []
    for blk in blocks:
        ia, ib = pairs.to(blk.device).unbind(1)
        parts.append(_row_intersections(blk[ia], blk[ib]))
    return mesh.sum_to(parts)
