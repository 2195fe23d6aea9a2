"""The mesh's host-layout entry points, its routing gates and the
multi-process bring-up.

Counterpart of kmerset_tpu/parallel/driver.py's build half: _pad_stride
and the shard layout (:51-60, :140-146), _led_chain_selection (:62-71),
the gates (_mesh_available, should_use_mesh, should_use_mesh_graph,
:73-137) and the drivers mesh_count (:160-254), mesh_unitig_succ
(:257-345), mesh_pointer_double (:398-446), mesh_chain_group and
mesh_emit_chains (:479-667), mesh_matching (:670-710) and
mesh_overlap_edges (:713-792); and the multi-process staging
_stride_global and _gather_global (:348-395) and maybe_init_distributed
(:449-477).  Each driver takes and returns the host arrays of the
single-device path it stands in for, and runs the shard programs of
parallel/mesh.py under Mesh.lock.

Over a process group every rank holds the same host input (the
reference's convention: every process reads the same file), stages only
its own shards' blocks from it (_stride, _key_blocks), and ends each
driver call holding the whole host result (Mesh.gather: the lengths,
then the parts), so the host walk, the path cover and the dump run alike
on every rank.  A plan that reads local state and fixes how many
collectives follow (the count's rounds, the side tables' query rounds,
the sketch table's pair batches) is agreed across the ranks (the least
of theirs, Mesh.agree_min), and each step checks that every rank is at
the same step (Mesh.check_step): a mismatch would deadlock.

Not carried over, and why:
- the capacity retries (driver.py:213-236, :299-322, :610-638, :744-767)
  and KMERSET_TPU_MESH_CAPACITY: the reference's programs have static
  shapes, so each exchange lane has a capacity and a skewed input is
  re-run at a doubled one; here every exchange sends exact split sizes;
- the blanket fallbacks (each driver's `except Exception: return None`,
  :250-254 and its siblings): an error raises to the caller.  Where the
  reference's None is a routing decision the caller keeps it: k = 31
  overlap edges and node counts from 2^30 on go to the host path
  (core/spss.py), as does a grouping whose groups are not led by the
  requested starts;
- the slow-link gate (driver.py:107-113, :135-137): it belongs with the
  link formats (ROADMAP A.9).

maybe_init_distributed reads the reference's KMERSET_TPU_DISTRIBUTED,
the one variable of the reference's that the port reads: it is the CLI's
contract for joining a group of processes (addr:port,N,i, or auto for
PyTorch's env:// variables as torchrun sets them), not a backend switch.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import logging
import math
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.graph import led_group_selection, permute_groups
from ..ops import backend
from ..utils import trace
from .mesh import (
    Mesh,
    device_identity,
    owner_edges,
    oriented_values,
    render_chains,
    sharded_count,
    sharded_group_by_end,
    sharded_matching,
    sharded_overlap_edges,
    sharded_pointer_double,
    sharded_side_tables,
    sharded_unitig_succ,
    transport_of,
)

# The reference's size gates of an automatic mesh: counting from
# DEFAULT_MIN_DEVICE_WINDOWS windows (kmerset_tpu/ops/backend.py:31,
# driver.py:116), or above MAX_DEVICE_WINDOWS (backend.py:308,
# driver.py:114-115); the graph phases from DEFAULT_MIN_DEVICE_GRAPH
# nodes (backend.py:40, driver.py:133-134).
MIN_MESH_WINDOWS = 1 << 21
MAX_ONE_DEVICE_WINDOWS = 1 << 29
MIN_MESH_GRAPH = 1 << 23
# Node ids of the mesh's graph phases stay below this (reference
# driver.py:272, :411, :503, :579; core/spss.py:674-678): the grouping
# sort key packs an end id and a dist of 30 bits each.
MAX_MESH_NODES = 1 << 30
# The overlap edges' exchange key is (value << 1) | table bit; the
# reference keeps k = 31 on the host join (mesh.py:1047-1050,
# driver.py:732-737), and so does the port.
MAX_MESH_OVERLAP_K = 30
# Peak device bytes of the mesh front-end per k-mer of its whole-set
# arrays (the blocks, both sides' rows, the mate-degree exchange, the
# successor rows) and per k-mer queried in one side-table round (the
# candidates, their copies routed by owner, the answers and their way
# back), where the single device takes backend.FRONT_END_BYTES_PER_KMER
# and FRONT_END_BYTES_PER_QUERY: measured on one H100 at 1 and 4 shards
# by chip_smoke.py phase 14 (PERF.md), which holds them to these values,
# each at least a tenth above its measurement.
MESH_FRONT_END_BYTES_PER_KMER = 144
MESH_BYTES_PER_QUERY = 520

# The variable of the CLI contract for a group of processes (reference
# driver.py:449-477), and how long a rank waits for the others at the
# rendezvous and in a collective before it fails.
DISTRIBUTED_ENV = "KMERSET_TPU_DISTRIBUTED"
GROUP_TIMEOUT_S = 600
# A plan's value on a rank without shards: no constraint.
_UNBOUNDED = 1 << 62

logger = logging.getLogger("kmerset")


@contextlib.contextmanager
def _step(name: str, mesh: Mesh):
    """One mesh step under Mesh.lock, timed from when it holds the lock: a
    debug line "mesh: NAME on N shards: S s" (its results are on the host
    when it ends).  Over a group it first checks that every rank starts
    the same step (Mesh.check_step)."""
    with mesh.lock():
        mesh.check_step(name)
        with trace.timed("mesh." + name.replace(" ", "_")) as sp:
            yield
    logger.debug("mesh: %s on %d shards: %.4f s", name, mesh.size,
                 sp.seconds)


def auto_mesh(device: torch.device) -> Optional[Mesh]:
    """The mesh a plain `cuda` device stands for where 2 or more GPUs
    are visible: one shard per GPU, taken above the size gates
    (the reference's automatic route, driver.py:73-137, where JAX sees
    every device); None otherwise."""
    if device.type != "cuda" or device.index is not None:
        return None
    n = torch.cuda.device_count()
    if n < 2:
        return None
    return Mesh([f"cuda:{i}" for i in range(n)], forced=False)


def should_use_mesh(mesh: Optional[Mesh], n_windows: int) -> bool:
    """Whether a count or decode of n_windows windows runs on `mesh`."""
    if mesh is None:
        return False
    if mesh.forced or n_windows > MAX_ONE_DEVICE_WINDOWS:
        return True
    return n_windows >= MIN_MESH_WINDOWS


def should_use_mesh_graph(mesh: Optional[Mesh], n_nodes: int) -> bool:
    """Whether a graph phase over n_nodes entities runs on `mesh`; node
    counts from MAX_MESH_NODES on stay on the host path."""
    if mesh is None or n_nodes >= MAX_MESH_NODES:
        return False
    return mesh.forced or n_nodes >= MIN_MESH_GRAPH


def _stride(mesh: Mesh, arr: np.ndarray, fill, dtype=torch.int64):
    """The local shards' blocks of arr split into mesh.size stride blocks
    of cap = ceil(n / size) entries, the tail padded with `fill`, each on
    its shard (reference _pad_stride, driver.py:51-59, and, over a group,
    _stride_global, :348-378: each rank takes its shards' blocks from
    the host copy every rank holds).  Returns (blocks, cap)."""
    n = arr.shape[0]
    cap = max(1, math.ceil(n / mesh.size))
    out = []
    for d, dev in zip(mesh.local, mesh.devices):
        part = torch.full((cap,), fill, dtype=dtype)
        lo, hi = min(d * cap, n), min((d + 1) * cap, n)
        part[: hi - lo] = torch.from_numpy(np.ascontiguousarray(arr[lo:hi])).to(dtype)
        out.append(backend.upload("stride block", part, dev))
    return out, cap


def _gather(mesh: Mesh, parts, n: int, dtype, wire=torch.int64) -> np.ndarray:
    """The first n entries of every shard's concatenated blocks (parts:
    the local shards'), on the host of every rank (reference
    _gather_global, driver.py:381-395), through Mesh.gather as `wire`."""
    return mesh.gather([p.to(wire) for p in parts], wire)[:n].astype(dtype)


def shard_window_ceiling(mesh: Mesh, k: int) -> int:
    """The most windows one shard packs in one mesh count: each physical
    device's one-shot ceiling (backend.window_ceiling of this rank's
    share of its memory_budget, Mesh.budget), shared by the shards it
    holds; the least over the ranks, since it fixes the count's rounds;
    at least 1."""
    return max(1, mesh.agree_min(min(
        (backend.window_ceiling(k, mesh.budget(dev)) // n
         for dev, n in mesh.physical().items()), default=_UNBOUNDED)))


def mesh_count(codes: np.ndarray, offsets: np.ndarray, k: int,
               canonical: bool, mesh: Mesh, need_counts: bool = True):
    """(keys int64, raw counts int64) of the fragment stream, counted on
    the mesh (need_counts=False: (keys, None), the decode): shard d packs
    windows [d * W, (d + 1) * W) with their k - 1 code halo (W = the
    windows over the shards, rounded up), and each owner counts its key
    range (mesh.sharded_count).  The owners' ranges ascend, so their keys
    concatenate sorted.  Where W exceeds shard_window_ceiling, the input
    is counted in rounds of that many windows per shard, whose sorted runs
    are merged on the host as the single device's chunks are."""
    n_windows = int(codes.shape[0]) - (k - 1)
    if n_windows <= 0:
        return np.empty(0, np.int64), (np.empty(0, np.int64) if need_counts else None)
    W = min(-(-n_windows // mesh.size), shard_window_ceiling(mesh, k))
    rounds = [
        _mesh_count_round(c, o, k, canonical, mesh, need_counts)
        for c, o in backend.chunk_slices(codes, offsets, k, W * mesh.size)
    ]
    if need_counts:
        return backend._merge_cascade(rounds, backend._merge_count_pair)
    return backend._merge_cascade([r[0] for r in rounds], backend._merge_key_pair), None


def _mesh_count_round(codes, offsets, k: int, canonical: bool, mesh: Mesh,
                      need_counts: bool):
    """One mesh count of at most shard_window_ceiling windows per shard."""
    n_windows = int(codes.shape[0]) - (k - 1)
    W = -(-n_windows // mesh.size)
    chunks = list(backend.chunk_slices(codes, offsets, k, W))
    with _step("count" if need_counts else "decode", mesh):
        staged = [backend.stage(*chunks[d], k, dev) if d < len(chunks) else None
                  for d, dev in zip(mesh.local, mesh.devices)]
        out = sharded_count(mesh, staged, k, canonical, need_counts)
        keys = _gather(mesh, [kk for kk, _ in out], None, np.int64)
        if not need_counts:
            return keys, None
        counts = _gather(mesh, [c for _, c in out], None, np.int64, torch.int32)
    return keys, counts


def shard_query_chunk(mesh: Mesh, sizes) -> int:
    """The most k-mers each shard queries in one side-table round, planned
    per physical device as backend.front_end_plan plans one device: the
    whole-set arrays of the k-mers its shards hold (sizes[i]: local shard
    i's, at MESH_FRONT_END_BYTES_PER_KMER) take at most half its share of
    memory (Mesh.budget), and what they leave, at MESH_BYTES_PER_QUERY
    per queried k-mer, is shared by its shards; the least over the ranks,
    since it fixes the rounds.  Raises, on every rank, where they would
    take more on any rank: the mesh has no bounded mode, so such a set
    takes more devices."""
    held: dict = {}
    for d, size in zip(mesh.local, sizes):
        dev = mesh.physical_of(d)
        held[dev] = held.get(dev, 0) + int(size)
    chunk, over = _UNBOUNDED, None
    for dev, n_dev in held.items():
        budget = mesh.budget(dev)
        whole = MESH_FRONT_END_BYTES_PER_KMER * n_dev
        if 2 * whole > budget:
            over = (f"the mesh front-end's {n_dev} k-mers on {dev} exceed its "
                    f"one-shot ceiling ({budget // (2 * MESH_FRONT_END_BYTES_PER_KMER)}"
                    "); spread the set over more devices")
            chunk = 0
            continue
        q = max(1, (budget - whole) // MESH_BYTES_PER_QUERY // mesh.physical()[dev])
        chunk = min(chunk, q)
    agreed = mesh.agree_min(chunk)
    if agreed == 0:
        raise ValueError(over or "the mesh front-end's k-mers exceed its "
                         "one-shot ceiling on another rank's device")
    return agreed


def _key_blocks(mesh: Mesh, A: np.ndarray, k: int):
    """The local shards' key-range blocks of the sorted set A, on their
    devices, and each block's position in A."""
    idx = np.searchsorted(A, owner_edges(k, mesh.size))
    blocks = [backend.upload("set block", np.ascontiguousarray(A[idx[d]:idx[d + 1]],
                                                               dtype=np.int64), dev)
              for d, dev in zip(mesh.local, mesh.devices)]
    return blocks, [int(idx[d]) for d in mesh.local]


def mesh_side_tables(A: np.ndarray, k: int, canonical: bool, mesh: Mesh):
    """((rdeg, rnbr, rsame), (ldeg, lnbr, lsame)) of the sorted unique
    k-mers A on the mesh (mesh.sharded_side_tables), as host arrays
    (deg, nbr int64, same bool), nbr a position in A: the tables of the
    host's _side_table_canonical / _side_table_plain."""
    with _step("side tables", mesh):
        blocks, offs = _key_blocks(mesh, A, k)
        q = shard_query_chunk(mesh, [b.shape[0] for b in blocks])
        rows = sharded_side_tables(mesh, blocks, offs, k, canonical, q)
        out = []
        for side in range(2):
            out.append(tuple(
                _gather(mesh, [r[side][j] for r in rows], None, dt, wire)
                for j, (dt, wire) in enumerate((
                    (np.int64, torch.int32), (np.int64, torch.int64),
                    (bool, torch.bool)))))
    return out[0], out[1]


def mesh_unitig_succ(A: np.ndarray, k: int, mesh: Mesh):
    """(succ (2n,) int64, term_l, term_r, both) of the sorted unique
    canonical k-mers A, the front-end on the mesh
    (mesh.sharded_unitig_succ), in device_unitig_succ's host layout."""
    n = A.shape[0]
    with _step("front-end", mesh):
        blocks, offs = _key_blocks(mesh, A, k)
        q = shard_query_chunk(mesh, [b.shape[0] for b in blocks])
        rows = sharded_unitig_succ(mesh, blocks, offs, k, q)
        cat = [_gather(mesh, [r[j] for r in rows], None, dt, wire)
               for j, (dt, wire) in enumerate((
                   (np.int64, torch.int64), (np.int64, torch.int64),
                   (bool, torch.bool), (bool, torch.bool)))]
    succ = np.empty(2 * n, dtype=np.int64)
    succ[0::2], succ[1::2] = cat[0], cat[1]
    term_l, term_r = cat[2].astype(bool), cat[3].astype(bool)
    return succ, term_l, term_r, term_l & term_r


def mesh_pointer_double(succ: np.ndarray, labels: Optional[np.ndarray] = None,
                        *, mesh: Mesh):
    """(end, dist, is_chain, min_label) of core/graph.pointer_double, on
    the mesh (mesh.sharded_pointer_double): succ padded to the stride
    layout with self-terminating nodes, for the reference's number of
    rounds (driver.py:431, from the padded count)."""
    n = succ.shape[0]
    if n == 0:
        e = np.empty(0, np.int64)
        return e, e.copy(), np.empty(0, bool), (labels.copy() if labels is not None else None)
    if n >= MAX_MESH_NODES:
        raise ValueError(f"{n} nodes: the mesh's node ids stay below 2^30")
    with _step("pointer doubling", mesh):
        sp, cap = _stride(mesh, succ, -1)
        lp = _stride(mesh, labels, 0)[0] if labels is not None else None
        N = cap * mesh.size
        rounds = max(1, int(np.ceil(np.log2(max(N, 2)))) + 1)
        res = sharded_pointer_double(mesh, sp, lp, cap, rounds)
        end = _gather(mesh, [r[0] for r in res], n, np.int64)
        dist = _gather(mesh, [r[1] for r in res], n, np.int64, torch.int32)
        is_chain = _gather(mesh, [r[2] for r in res], n, bool, torch.bool)
        mins = (_gather(mesh, [r[3] for r in res], n, np.int64)
                if labels is not None else None)
    return end, dist, is_chain, mins


def _led_chain_selection(end, is_chain, starts, n: int) -> np.ndarray:
    """Node mask of the chains led by `starts` (reference driver.py:62-71)."""
    keep_end = np.zeros(n, dtype=bool)
    keep_end[end[starts]] = True
    return is_chain & keep_end[end]


def _grouped(mesh: Mesh, succ, starts, pd, lanes_of=None):
    """Groups the chains led by `starts` by end on the mesh; returns
    (per owner: [ends, ids, *lanes]) for the nodes of those chains."""
    n = succ.shape[0]
    end, dist, is_chain, _ = pd
    sel = _led_chain_selection(end, is_chain, starts, n)
    ep, cap = _stride(mesh, end, 0)
    dp, _ = _stride(mesh, dist, 0)
    sp, _ = _stride(mesh, sel, False, torch.bool)
    lanes = lanes_of(ep, cap) if lanes_of else None
    return sharded_group_by_end(mesh, ep, dp, sp, cap, lanes)


def _groups_of(ends: np.ndarray) -> np.ndarray:
    """Group starts of the end-sorted records `ends` (one group per end;
    no group when there is no record)."""
    if ends.size == 0:
        return np.zeros(1, np.int64)
    bnd = np.flatnonzero(np.diff(ends)) + 1
    return np.concatenate(([0], bnd, [ends.shape[0]])).astype(np.int64)


def mesh_chain_group(succ: np.ndarray, starts: np.ndarray, *, mesh: Mesh,
                     pd=None, by_starts: bool = True):
    """(nodes, group_starts) of the chains led by `starts`, grouped on the
    mesh (pointer doubling, then mesh.sharded_group_by_end), each chain
    start to end: in `starts` order (by_starts, the native walk's order,
    native.chain_walk), or in the order of their ends (the numpy walk's,
    core/spss._chains_grouped).  pd: a precomputed mesh_pointer_double of
    succ.  Returns None, a routing decision, where by_starts and the
    groups are not led by exactly the starts (led_group_selection)."""
    n = succ.shape[0]
    if n >= MAX_MESH_NODES:
        raise ValueError(f"{n} nodes: the mesh's node ids stay below 2^30")
    if pd is None:
        pd = mesh_pointer_double(succ, mesh=mesh)
    with _step("chain grouping", mesh):
        grouped = _grouped(mesh, succ, starts, pd)
        ends = _gather(mesh, [g[0] for g in grouped], None, np.int64)
        nodes = _gather(mesh, [g[1] for g in grouped], None, np.int64)
    groups = _groups_of(ends)
    if not by_starts or nodes.size == 0:
        return nodes, groups
    sel = led_group_selection(nodes, groups, starts, n)
    if sel is None:
        return None
    _, nodes_k, groups_k, order = sel
    return permute_groups(nodes_k, groups_k, order)


def mesh_emit_chains(A: np.ndarray, k: int, succ: np.ndarray,
                     starts: np.ndarray, oriented: bool, *, mesh: Mesh,
                     pd=None):
    """(nodes, groups, codes, str_offsets) of the chains led by `starts`,
    grouped on the mesh in the order of their ends, and each rendered to
    2-bit codes on its end's owner (mesh.render_chains): every record
    carries its oriented k-mer, read on its own shard from that shard's
    part of A.  codes[str_offsets[i]:str_offsets[i + 1]] is group i's
    string.  Callers select and order the groups (reference
    driver.py:549-667)."""
    n = succ.shape[0]
    if n >= MAX_MESH_NODES:
        raise ValueError(f"{n} nodes: the mesh's node ids stay below 2^30")
    if pd is None:
        pd = mesh_pointer_double(succ, mesh=mesh)

    def values(ep, cap):
        lanes = []
        for d, dev in zip(mesh.local, mesh.devices):
            lo, hi = min(d * cap, n), min((d + 1) * cap, n)
            first = lo >> 1 if oriented else lo
            last = ((hi - 1) >> 1) + 1 if oriented and hi > lo else hi
            part = backend.upload("set block", np.ascontiguousarray(
                A[first:last], dtype=np.int64), dev)
            ids = torch.arange(cap, dtype=torch.int64, device=dev) + d * cap
            lanes.append([oriented_values(part, first, ids, k, oriented)])
        return lanes

    with _step("chain grouping and emission", mesh):
        grouped = _grouped(mesh, succ, starts, pd, values)
        ends = _gather(mesh, [g[0] for g in grouped], None, np.int64)
        nodes = _gather(mesh, [g[1] for g in grouped], None, np.int64)
        codes = _gather(mesh, [render_chains(g[0], g[2], k) for g in grouped],
                        None, np.uint8, torch.uint8)
    groups = _groups_of(ends)
    str_offsets = np.zeros(groups.shape[0], dtype=np.int64)
    np.cumsum(np.diff(groups) + k - 1, out=str_offsets[1:])
    if nodes.size == 0:
        str_offsets[:] = 0
    if int(str_offsets[-1]) != codes.shape[0]:
        raise RuntimeError(
            f"mesh emission rendered {codes.shape[0]} codes for groups that "
            f"hold {int(str_offsets[-1])}")
    return nodes, groups, codes, str_offsets


def mesh_matching(pa: np.ndarray, pb: np.ndarray, n_ports: int, *, mesh: Mesh):
    """match[port] (partner or -1) of the priority-ordered greedy matching
    of the self-loop-free edge list (pa, pb), on the mesh
    (mesh.sharded_matching): core/graph.handshake_matching's result."""
    n_e = int(pa.shape[0])
    if n_e == 0 or n_ports == 0:
        return np.full(n_ports, -1, dtype=np.int64)
    with _step("matching", mesh):
        pap, ecap = _stride(mesh, pa, -1)
        pbp, _ = _stride(mesh, pb, -1)
        pcap = max(1, math.ceil(n_ports / mesh.size))
        match = sharded_matching(mesh, pap, pbp, ecap, pcap)
        return _gather(mesh, match, n_ports, np.int64)


def mesh_overlap_edges(P: np.ndarray, S: np.ndarray, k: int, *, mesh: Mesh):
    """The pre-dedup (a_ports, b_ports) of the bidirected unitig graph's
    overlap edges, in the host join's discovery order (native.
    overlap_edges), from the unitigs' first and last k-mers P and S, on
    the mesh (mesh.sharded_overlap_edges).  k <= 30: the reference keeps
    k = 31 on the host join (its 2^62 sentinel, mesh.py:1047-1050)."""
    if k > 30:
        raise ValueError("mesh overlap edges take k <= 30; k = 31 is the host join's")
    n = int(P.shape[0])
    if n == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    with _step("overlap edges", mesh):
        ucap = max(1, math.ceil(n / mesh.size))
        Ps, Ss = [], []
        for d, dev in zip(mesh.local, mesh.devices):
            lo, hi = min(d * ucap, n), min((d + 1) * ucap, n)
            Ps.append(backend.upload("prefix block", np.ascontiguousarray(
                P[lo:hi], dtype=np.int64), dev))
            Ss.append(backend.upload("suffix block", np.ascontiguousarray(
                S[lo:hi], dtype=np.int64), dev))
        ans = sharded_overlap_edges(mesh, Ps, Ss, k, ucap)
        # Each shard's (16, m_d) answers travel unitig-major.
        ans16 = _gather(mesh, [a.t().reshape(-1) for a in ans], None,
                        np.int64).reshape(n, 16).T
    found = ans16 >= 0
    ar = np.arange(n, dtype=np.int64)
    a_out, b_out = [], []
    for jt in range(16):
        grp = jt // 8  # 0: probes from S (right port); 1: from P (left)
        src = 2 * ar + grp
        side = (1 - (jt % 2)) if grp == 0 else (jt % 2)
        dst = 2 * ans16[jt] + side
        ok = found[jt] & (ar != ans16[jt])
        a_out.append(src[ok])
        b_out.append(dst[ok])
    return np.concatenate(a_out), np.concatenate(b_out)


def _spec_error(spec: str) -> ValueError:
    return ValueError(
        "malformed KMERSET_TPU_DISTRIBUTED=%r: expected "
        "'auto' or 'addr:port,num_processes,process_id'" % spec)


def maybe_init_distributed(devices: Sequence[torch.device]) -> bool:
    """Joins this process into a torch.distributed group as
    KMERSET_TPU_DISTRIBUTED says (reference driver.py:449-477), for a
    mesh whose shards on this rank are `devices`; returns whether a group
    is up (False where the variable is unset or empty: one process).

    KMERSET_TPU_DISTRIBUTED=addr:port,N,i  -> rank i of N; rank 0 serves
                                             the rendezvous at addr:port
    KMERSET_TPU_DISTRIBUTED=auto           -> MASTER_ADDR, MASTER_PORT,
                                             WORLD_SIZE and RANK (env://,
                                             as torchrun sets them); where
                                             TORCHELASTIC_USE_AGENT_STORE
                                             is True, the launcher serves
                                             the store and rank 0 joins it

    The ranks first exchange their shards' device identities through the
    rendezvous store, so that the default group gets a cpu:gloo backend,
    plus cuda:nccl where the mesh's transport rule (mesh.transport_of)
    allows NCCL.  The group waits GROUP_TIMEOUT_S for a missing rank or a
    stalled collective, then fails: nothing continues on fewer ranks."""
    spec = os.environ.get(DISTRIBUTED_ENV, "")
    if not spec:
        return False
    import torch.distributed as dist

    if spec in ("1", "auto"):
        try:
            addr, port = os.environ["MASTER_ADDR"], int(os.environ["MASTER_PORT"])
            world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        except (KeyError, ValueError) as e:
            raise ValueError(
                f"KMERSET_TPU_DISTRIBUTED={spec!r} reads MASTER_ADDR, "
                f"MASTER_PORT, WORLD_SIZE and RANK: {e!r}") from e
        serve = rank == 0 and os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
    else:
        try:
            where, n, pid = spec.split(",")
            addr, port = where.rsplit(":", 1)
            port, world, rank = int(port), int(n), int(pid)
        except ValueError as e:
            raise _spec_error(spec) from e
        if not 0 <= rank < world:
            raise _spec_error(spec)
        serve = rank == 0
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    store = dist.TCPStore(addr, port, world, serve, timeout=timeout)
    store.set(f"kmerset/devices/{rank}",
              json.dumps([device_identity(torch.device(d)) for d in devices]))
    every = [json.loads(store.get(f"kmerset/devices/{r}")) for r in range(world)]
    backend_name = "cpu:gloo,cuda:nccl" if transport_of(every) == "nccl" else "gloo"
    dist.init_process_group(backend_name, store=store, rank=rank,
                            world_size=world, timeout=timeout)
    logger.info("torch.distributed: process %d / %d (%s)", rank, world,
                backend_name)
    return True


def end_distributed() -> None:
    """The last step of a CLI run over a group: every rank agrees that it
    finished (a rank that failed never gets here, so the others fail in
    this collective instead of exiting 0), then the group closes.  A
    no-op in one process."""
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return
    dist.all_reduce(torch.ones(1, dtype=torch.int64))
    dist.destroy_process_group()
