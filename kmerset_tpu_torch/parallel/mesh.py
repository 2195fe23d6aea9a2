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
in the reference.  A mesh is one process, or spans the ranks of a
torch.distributed process group (`group=`, the reference's make_mesh
over global devices): its shards are then every rank's own shards, in
rank order, and each rank runs only its own shards' part of every
program (Mesh.local).  Program inputs and outputs are lists indexed by
local shard; every exchange between shards goes through the Mesh's
collectives (all_to_all, all_gather, psum, sum_to, xor_to, gather), and
every exchange sends exact split sizes, exchanged first.

The transport of a group mesh follows from its shards' devices, which
the ranks exchange when the mesh forms (transport_of): NCCL where every
rank's shards are on CUDA and no card is held by two ranks, else gloo,
with CUDA tensors moved to the host and back around each collective
(NCCL takes no two ranks on one device).  Host integers (split sizes,
sums, agreed plans, the step check) and the results gathered to the
host (Mesh.gather) always travel through the group's gloo backend.

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
import logging
import socket
import zlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

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

logger = logging.getLogger("kmerset")


def device_identity(dev: torch.device) -> Tuple[str, str, str, str]:
    """(host, kind, card, name) of one shard's device: a CUDA device's
    card is its torch.cuda.get_device_properties(i).uuid, so that two
    ranks naming one card under different indices still share it."""
    host = socket.gethostname()
    if dev.type != "cuda":
        return host, dev.type, dev.type, str(dev)
    i = dev.index if dev.index is not None else torch.cuda.current_device()
    return host, "cuda", str(torch.cuda.get_device_properties(i).uuid), f"cuda:{i}"


def card_holders(every) -> Dict[tuple, Tuple[str, List[int]]]:
    """Each CUDA card ((host, card) of device_identity) that the ranks'
    shards are on, with its name and the ranks that hold it; every[r] is
    rank r's list of device_identity tuples."""
    out: Dict[tuple, Tuple[str, List[int]]] = {}
    for r, ids in enumerate(every):
        for host, kind, card, name in ids:
            if kind == "cuda":
                ranks = out.setdefault((host, card), (name, []))[1]
                if r not in ranks:
                    ranks.append(r)
    return out


def transport_of(every) -> str:
    """The transport of a group mesh whose rank r holds shards on the
    devices every[r] (device_identity tuples): "nccl" where every rank
    holds at least one shard, all on CUDA, and no card is held by two
    ranks; else "gloo"."""
    all_cuda = all(ids and all(i[1] == "cuda" for i in ids) for ids in every)
    shared = any(len(r) > 1 for _, r in card_holders(every).values())
    return "nccl" if all_cuda and not shared else "gloo"


class Mesh:
    """Shards of a 1-D mesh, each on a torch.device (reference make_mesh,
    mesh.py:44-59).  `forced`: routed to the mesh whatever the input's
    size, as an explicit mesh is (the reference's forced mesh backend,
    driver.py:79-81); an automatic mesh (driver.auto_mesh) is taken only
    above the reference's size gates.

    Without a group the mesh is one process and `devices` are all of its
    shards.  With a torch.distributed process group, `devices` are this
    rank's shards (none is allowed, while the mesh has one); the mesh's
    shards are every rank's, in rank order, exchanged once here, and
    `local` names this rank's.  Forming a group mesh is a collective:
    every rank of the group constructs it at the same point."""

    def __init__(self, devices: Sequence, *, group=None, forced: bool = True):
        devs = tuple(resolve_device(d) for d in devices)
        self.devices = devs
        self.forced = forced
        self.group = group
        self._steps = 0
        if group is None:
            if not devs:
                raise ValueError("a mesh needs at least one shard")
            self.rank, self.n_ranks = 0, 1
            self._counts = [len(devs)]
            self.transport = None
            self._sharing: Dict[tuple, int] = {}
        else:
            import torch.distributed as dist

            backend_name = str(dist.get_backend(group))
            self.rank = dist.get_rank(group)
            self.n_ranks = dist.get_world_size(group)
            every = [None] * self.n_ranks
            dist.all_gather_object(every, [device_identity(d) for d in devs],
                                   group=group)
            self._counts = [len(ids) for ids in every]
            if not sum(self._counts):
                raise ValueError("a mesh needs at least one shard")
            self.transport = transport_of(every)
            if "gloo" not in backend_name or (
                    self.transport == "nccl" and "nccl" not in backend_name):
                need = "cpu:gloo,cuda:nccl" if self.transport == "nccl" else "gloo"
                raise ValueError(f"a mesh whose transport is {self.transport} "
                                 f"needs a group with {need}, not {backend_name!r}")
            holders = card_holders(every)
            self._sharing = {key: len(r) for key, (_, r) in holders.items()}
            shared = [f"{name} shared by {len(r)} ranks"
                      for name, r in holders.values() if len(r) > 1]
            kinds = ",".join(sorted({i[1] for ids in every for i in ids}))
            logger.info(
                "mesh: %d shards over %d processes, %s: %s", sum(self._counts),
                self.n_ranks, "; ".join(shared) or (
                    "each card held by one rank" if self.transport == "nccl"
                    else f"{kinds} shards"),
                "exchanges on the cards (NCCL)" if self.transport == "nccl"
                else "exchanges through the host (gloo)")
        first = sum(self._counts[: self.rank])
        self.local = tuple(range(first, first + len(devs)))
        self._first = [sum(self._counts[:r]) for r in range(self.n_ranks + 1)]
        self._has_empty = 0 in self._counts

    @property
    def size(self) -> int:
        """The number of shards of the whole mesh, over every rank."""
        return self._first[-1]

    @property
    def home(self) -> torch.device:
        """This rank's first shard's device (the CPU for a rank without
        shards): where the tensor reductions leave their result."""
        return self.devices[0] if self.devices else torch.device("cpu")

    def rank_of(self, shard: int) -> int:
        """The rank that holds shard `shard`."""
        if not 0 <= shard < self.size:
            raise IndexError(f"shard {shard} of a mesh of {self.size}")
        return next(r for r in range(self.n_ranks) if shard < self._first[r + 1])

    def shards_of(self, rank: int) -> range:
        """The shards rank `rank` holds."""
        return range(self._first[rank], self._first[rank + 1])

    def device_of(self, shard: int) -> torch.device:
        """The device of one of this rank's shards (a global index)."""
        return self.devices[shard - self._first[self.rank]]

    def physical_of(self, shard: int) -> torch.device:
        """The physical device of one of this rank's shards (a bare `cuda`
        is the current one)."""
        d = self.device_of(shard)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return d

    def physical(self) -> Dict[torch.device, int]:
        """Each physical device of this rank's shards with the number of
        them it holds, in device order."""
        counts: Dict[torch.device, int] = {}
        for d in self.local:
            dev = self.physical_of(d)
            counts[dev] = counts.get(dev, 0) + 1
        return dict(sorted(counts.items(), key=lambda kv: (kv[0].type, kv[0].index or 0)))

    def budget(self, dev: torch.device) -> int:
        """The bytes one step of this rank may plan to use on its physical
        device `dev`: backend.memory_budget, shared by the ranks that
        hold shards on the same card (each plans with its share, not with
        the whole card's free memory)."""
        total = backend.memory_budget(dev)
        if self.group is None or dev.type != "cuda":
            return total
        host, _, card, _ = device_identity(dev)
        return total // self._sharing.get((host, card), 1)

    @contextlib.contextmanager
    def lock(self):
        """Holds backend.device_lock of every physical device of this
        rank's shards, each once and in device order (the lock is not
        reentrant, and shards share devices), for one mesh step."""
        with contextlib.ExitStack() as stack:
            for d in self.physical():
                stack.enter_context(backend.device_lock(d))
            yield

    # -- host integers: always the group's gloo backend ---------------------

    def _host_sum(self, t: torch.Tensor, op=None) -> torch.Tensor:
        """An all_reduce of a CPU int64 tensor over the group (SUM, or
        `op`)."""
        import torch.distributed as dist

        dist.all_reduce(t, op=op or dist.ReduceOp.SUM, group=self.group)
        return t

    def exchange_sizes(self, rows) -> List[List[int]]:
        """The n x n split sizes of an exchange, sizes[src][dst], on every
        rank, from this rank's rows (rows[i]: local shard i's n sizes)."""
        n = self.size
        if len(rows) != len(self.local) or any(len(r) != n for r in rows):
            raise ValueError(f"exchange_sizes takes {len(self.local)} rows of {n}")
        if self.group is None:
            return [[int(v) for v in r] for r in rows]
        m = torch.zeros((n, n), dtype=torch.int64)
        if rows:
            m[self.local[0]: self.local[-1] + 1] = torch.tensor(rows, dtype=torch.int64)
        return self._host_sum(m).tolist()

    def all_gather(self, values: Sequence[int]) -> List[int]:
        """Every shard's value (a host int; values[i]: local shard i's), on
        every shard."""
        if len(values) != len(self.local):
            raise ValueError(f"all_gather takes {len(self.local)} values")
        if self.group is None:
            return [int(v) for v in values]
        t = torch.zeros(self.size, dtype=torch.int64)
        if values:
            t[self.local[0]: self.local[-1] + 1] = torch.tensor(
                [int(v) for v in values], dtype=torch.int64)
        return self._host_sum(t).tolist()

    def psum(self, values: Sequence[int]) -> int:
        """The sum of every shard's value (a host int)."""
        return sum(self.all_gather(values))

    def agree_min(self, value: int) -> int:
        """The least of every rank's `value` (a host int): a plan that
        fixes how many collectives follow is agreed this way, or the ranks
        would fall out of step."""
        if self.group is None:
            return int(value)
        import torch.distributed as dist

        t = torch.tensor([int(value)], dtype=torch.int64)
        return int(self._host_sum(t, dist.ReduceOp.MIN)[0])

    def agree_count(self, value: Optional[int]) -> int:
        """A count that a rank without shards cannot know from its own
        inputs (how many lanes travel): the ranks with shards' value, on
        every rank.  Exchanged only where some rank has no shard, so that
        every rank makes the same calls."""
        if not self._has_empty:
            return int(value)
        import torch.distributed as dist

        t = torch.tensor([int(value) if self.devices else -1], dtype=torch.int64)
        return int(self._host_sum(t, dist.ReduceOp.MAX)[0])

    def check_step(self, name: str) -> None:
        """Every rank names the mesh step it starts and counts it; raises on
        every rank where they differ, which would otherwise deadlock (or
        mismatch) the collectives that follow.  No-op in one process."""
        if self.group is None:
            return
        import torch.distributed as dist

        self._steps += 1
        t = torch.zeros((self.n_ranks, 2), dtype=torch.int64)
        t[self.rank] = torch.tensor([self._steps, zlib.crc32(name.encode())])
        got = self._host_sum(t).tolist()
        if any(row != got[0] for row in got):
            # Every rank sees the same mismatch, so all take this exchange.
            steps = [None] * self.n_ranks
            dist.all_gather_object(steps, (self._steps, name), group=self.group)
            raise RuntimeError("mesh steps out of step across ranks: " + ", ".join(
                f"rank {r} at step {n} ({what})" for r, (n, what) in enumerate(steps)))

    # -- tensors -------------------------------------------------------------

    def _wire(self) -> torch.device:
        """Where a tensor exchange runs: this rank's first card (NCCL) or
        the host (gloo)."""
        return self.home if self.transport == "nccl" else torch.device("cpu")

    def all_to_all(self, parts: List[List[torch.Tensor]],
                   sizes: Optional[List[List[int]]] = None) -> List[List[torch.Tensor]]:
        """parts[i][dst] (local shard i's part for shard dst, a 1-D tensor
        on its device) arrives as recv[j][src] on local shard j's device.
        The split sizes, sizes[src][dst] over the whole mesh, are
        exchanged first where the caller does not hold them; then one
        all_to_all_single between the ranks carries each rank's parts,
        packed by destination rank, its own included.  Bool parts travel
        as uint8."""
        n = self.size
        if len(parts) != len(self.local) or any(len(row) != n for row in parts):
            raise ValueError(f"all_to_all takes {len(self.local)} x {n} parts")
        if self.group is None:
            return [[parts[s][d].to(self.devices[d]) for s in range(n)]
                    for d in range(n)]
        import torch.distributed as dist

        if sizes is None:
            sizes = self.exchange_sizes([[int(p.shape[0]) for p in row] for row in parts])
        dtype = parts[0][0].dtype if parts else torch.int64
        wire_dtype = torch.uint8 if dtype == torch.bool else dtype
        wire = self._wire()
        send, in_splits = [], []
        for r in range(self.n_ranks):
            mine = [parts[i][d] for i in range(len(self.local)) for d in self.shards_of(r)]
            send += mine
            in_splits.append(sum(int(p.shape[0]) for p in mine))
        out_splits = [sum(sizes[s][d] for s in self.shards_of(q) for d in self.local)
                      for q in range(self.n_ranks)]
        buf_in = (torch.cat([p.to(wire, wire_dtype) for p in send]) if send
                  else torch.empty(0, dtype=wire_dtype, device=wire))
        buf_out = torch.empty(sum(out_splits), dtype=wire_dtype, device=wire)
        dist.all_to_all_single(buf_out, buf_in, out_splits, in_splits, group=self.group)
        order = [(s, j) for s in range(n) for j in range(len(self.local))]
        chunks = torch.split(buf_out, [sizes[s][self.local[j]] for s, j in order])
        recv = [[None] * n for _ in self.local]
        for (s, j), c in zip(order, chunks):
            recv[j][s] = c.to(self.devices[j], dtype)
        return recv

    def gather(self, parts: Sequence[torch.Tensor], dtype: torch.dtype) -> np.ndarray:
        """Every shard's 1-D part (parts[i]: local shard i's), concatenated
        in shard order, as a host array on every rank: the lengths first,
        then the parts (the reference's _gather_global).  Over a group it
        always goes through the host (gloo), whatever the transport: the
        result is a host array anyway, and no card holds more than its own
        parts.  Each rank's parts reach the others by one broadcast into
        their place in the result."""
        if len(parts) != len(self.local):
            raise ValueError(f"gather takes {len(self.local)} parts")
        wire_dtype = torch.uint8 if dtype == torch.bool else dtype
        if self.group is None:
            if not parts:
                return torch.empty(0, dtype=dtype).numpy()
            return torch.cat([torch.from_numpy(backend.download("gather", p.to(wire_dtype)))
                              for p in parts]).to(dtype).numpy()
        import torch.distributed as dist

        lengths = self.all_gather([int(p.shape[0]) for p in parts])
        out = torch.empty(sum(lengths), dtype=wire_dtype)
        ends = [sum(lengths[: self._first[q]]) for q in range(self.n_ranks + 1)]
        if parts:
            torch.cat([torch.from_numpy(backend.download("gather", p.to(wire_dtype)))
                       for p in parts],
                      out=out[ends[self.rank]: ends[self.rank + 1]])
        for q in range(self.n_ranks):
            if ends[q + 1] > ends[q]:
                dist.broadcast(out[ends[q]: ends[q + 1]],
                               src=dist.get_global_rank(self.group, q),
                               group=self.group)
        return out.to(dtype).numpy()

    def _reduce(self, values: Sequence[torch.Tensor], shard: int, op, name: str):
        if len(values) != len(self.local):
            raise ValueError(f"a reduction takes {len(self.local)} tensors")
        if any(v.shape != values[0].shape for v in values):
            raise ValueError("a reduction takes one same-shaped tensor per shard")
        dev = self.devices[shard] if self.group is None else self.home
        out = values[0].to(dev) if values else None
        for v in values[1:]:
            out = op(out, v.to(dev))
        if self.group is None:
            return out
        import torch.distributed as dist

        if self._has_empty:
            every = [None] * self.n_ranks
            dist.all_gather_object(
                every, (tuple(out.shape), str(out.dtype)) if values else None,
                group=self.group)
            shape, dt = next(x for x in every if x is not None)
            if out is None:
                out = torch.zeros(shape, dtype=getattr(torch, dt.split(".")[-1]),
                                  device=dev)
        # XOR has no NCCL reduction: it goes through the host (gloo).
        wire = self._wire() if name == "sum" else torch.device("cpu")
        t = out.to(wire).contiguous()
        dist.all_reduce(t, op=dist.ReduceOp.SUM if name == "sum" else dist.ReduceOp.BXOR,
                        group=self.group)
        return t.to(dev)

    def sum_to(self, values: Sequence[torch.Tensor], shard: int = 0) -> torch.Tensor:
        """The element-wise sum of one same-shaped tensor per shard
        (values[i]: local shard i's), on shard `shard`'s device (the
        reference's psum of a vector); over a group, on every rank, on its
        first shard's device."""
        return self._reduce(values, shard, torch.add, "sum")

    def xor_to(self, values: Sequence[torch.Tensor], shard: int = 0) -> torch.Tensor:
        """The element-wise XOR of one same-shaped integer tensor per shard,
        placed as sum_to places its result (the reference's all_gather +
        XOR)."""
        return self._reduce(values, shard, torch.bitwise_xor, "xor")

    def __str__(self) -> str:
        cards = ",".join(str(d) for d in self.physical())
        if self.group is None:
            return f"mesh of {self.size} shards ({cards})"
        return (f"mesh of {self.size} shards over {self.n_ranks} processes "
                f"({len(self.local)} here: {cards or 'none'})")


def owner_edges(k: int, n_shards: int) -> np.ndarray:
    """Key-range boundaries: shard d owns [edges[d], edges[d + 1])
    (reference _owner_edges, mesh.py:62-67)."""
    space = 1 << (2 * k)
    i = np.arange(n_shards + 1, dtype=np.int64)
    return i * (space // n_shards) + np.minimum(i, space % n_shards)


def _key_owner(edges: np.ndarray, keys: torch.Tensor) -> torch.Tensor:
    """The shard owning each key under owner_edges `edges`."""
    inner = backend.upload("owner edges", edges[1:-1], keys.device, keys.dtype)
    return torch.searchsorted(inner, keys, right=True)


class Routing(NamedTuple):
    """How to_owners sent each local source shard's records: their
    positions, grouped by owner, the split sizes sizes[src][dst] of the
    whole mesh, and each local source's record count."""
    order: List[torch.Tensor]
    sizes: List[List[int]]
    lengths: List[int]


def to_owners(mesh: Mesh, owners, lanes, valid=None):
    """Sends records to their owner shards.  owners[i] (int64) names the
    owner of each record of local shard i, lanes[i] is a list of 1-D
    tensors aligned with it, and valid[i] (optional, bool) selects the
    records that travel.  The split sizes are exchanged once, then each
    lane travels with them.  Returns (recv, routing): recv[j] is local
    shard j's list of lanes, every source's records concatenated in
    source order (each in its own order), and routing serves
    from_owners."""
    n = mesh.size
    order, rows, lengths, parts = [], [], [], []
    for i, own in enumerate(owners):
        lengths.append(int(own.shape[0]))
        if valid is None:
            idx = torch.arange(own.shape[0], device=own.device)
        else:
            idx = torch.nonzero(valid[i]).squeeze(1)
        own = own[idx]
        srt = torch.argsort(own, stable=True)
        idx = idx[srt]
        cnt = backend.download("owner counts", torch.bincount(own, minlength=n)).tolist()
        order.append(idx)
        rows.append(cnt)
        parts.append([list(torch.split(lane[idx], cnt)) for lane in lanes[i]])
    sizes = mesh.exchange_sizes(rows)
    n_lanes = mesh.agree_count(len(lanes[0]) if lanes else None)
    recv = [[] for _ in mesh.local]
    for j in range(n_lanes):
        got = mesh.all_to_all([p[j] for p in parts], sizes)
        for d in range(len(mesh.local)):
            recv[d].append(torch.cat(got[d]))
    return recv, Routing(order, sizes, lengths)


def from_owners(mesh: Mesh, routing: Routing, answers, fill: int = 0):
    """Returns each owner's answers to the records to_owners brought it
    (answers[j]: a list of lanes aligned with recv[j]) to their source
    slots: out[i] is a list of lanes of local shard i's record count,
    `fill` where a record did not travel.  The split sizes are the
    routing's, so nothing is exchanged but the answers."""
    n = mesh.size
    back = [[routing.sizes[s][d] for s in range(n)] for d in range(n)]
    n_lanes = mesh.agree_count(len(answers[0]) if answers else None)
    out = [[] for _ in mesh.local]
    for j in range(n_lanes):
        parts = [list(torch.split(answers[i][j], back[d]))
                 for i, d in enumerate(mesh.local)]
        got = mesh.all_to_all(parts, back)
        for i in range(len(mesh.local)):
            a = torch.cat(got[i])
            full = torch.full((routing.lengths[i],), fill, dtype=a.dtype,
                              device=a.device)
            full[routing.order[i]] = a
            out[i].append(full)
    return out


# -- counting (reference mesh.py:71-135) -----------------------------------


def sharded_count(mesh: Mesh, staged, k: int, canonical: bool,
                  need_counts: bool = True):
    """Each local shard's window keys (staged[i]: backend.Staged on local
    shard i's device, or None for a shard without windows) packed by
    kernel B1 or B2 and sorted, split at the owner edges and sent to
    their owners; each owner sorts what it received, takes the run heads,
    compacts them with kernel B3 and counts.  Returns per local owner
    (keys, counts): its key range's sorted distinct keys (int32 for
    k <= 15, int64 above) and int32 counts (None without need_counts)."""
    n = mesh.size
    edges = owner_edges(k, n)
    sent = key_sentinel(k)
    parts = []
    for dev, st in zip(mesh.devices, staged):
        if st is None:
            parts.append([torch.empty(0, dtype=key_dtype(k), device=dev)] * n)
            continue
        s = count_ops.sorted_window_keys(*st, k, canonical)
        live = s[: int(backend.download("live", (s != sent).sum()))]
        inner = backend.upload("owner edges", edges[1:-1], dev, s.dtype)
        cuts = [0, *backend.download("cuts", torch.searchsorted(live, inner)).tolist(),
                live.shape[0]]
        parts.append([live[a:b] for a, b in zip(cuts, cuts[1:])])
    recv = mesh.all_to_all(parts)
    out = []
    for got in recv:
        mine = torch.sort(torch.cat(got)).values
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
    """The side-table rows of queries[i] (k-mers of local shard i's block)
    in the whole set: every candidate routed to the owner of its key,
    which answers its membership and position; the answers return to the
    candidate's slot."""
    cands, owners, lanes = [], [], []
    for q in queries:
        ncan, same = candidates(q, k, canonical)
        cands.append((ncan, same))
        flat = ncan.reshape(-1)
        owners.append(_key_owner(edges, flat))
        lanes.append([flat])
    recv, routing = to_owners(mesh, owners, lanes)
    answers = []
    for block, off, (cand,) in zip(blocks, offs, recv):
        found, idx = lookup_join(block, cand)
        answers.append([torch.where(found, idx + off, -1)])
    back = from_owners(mesh, routing, answers, fill=-1)
    out = []
    for q, (ncan, same), (ans,) in zip(queries, cands, back):
        ans = ans.view(8, -1)
        out.append(tables(q, ncan, same, ans >= 0, ans.clamp(min=0)))
    return out


def sharded_side_tables(mesh: Mesh, blocks, offs: Sequence[int], k: int,
                        canonical: bool, query_chunk: Optional[int] = None):
    """Side tables of the sorted set held as key-range blocks (blocks[i]:
    int64 on local shard i, offs[i] its position in the whole set), as
    ops/neighbors.side_tables builds them, with nbr a position in the
    whole set (the reference's dense global ids).  Each shard's k-mers are
    queried in rounds of at most `query_chunk` (all of the longest block
    in one round by default), which bound the candidates in flight; the
    rows are the same at every chunk size.  query_chunk is the same on
    every rank."""
    edges = owner_edges(k, mesh.size)
    longest = max(mesh.all_gather([b.shape[0] for b in blocks]))
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
    set.  query_chunk: sharded_side_tables'.  The owner of a neighbour's
    position is found from every shard's block start (offs, exchanged)."""
    rows = sharded_side_tables(mesh, blocks, offs, k, True, query_chunk)
    bounds = np.asarray(mesh.all_gather(offs)[1:], dtype=np.int64)
    owners, lanes, valid = [], [], []
    for (rdeg, rnbr, _), (ldeg, lnbr, _) in rows:
        q = torch.cat([rnbr, lnbr])
        inner = backend.upload("bounds", bounds, q.device)
        owners.append(torch.searchsorted(inner, q, right=True))
        lanes.append([q])
        valid.append(torch.cat([rdeg > 0, ldeg > 0]))
    recv, routing = to_owners(mesh, owners, lanes, valid)
    answers = []
    for ((rdeg, _, _), (ldeg, _, _)), off, (q,) in zip(rows, offs, recv):
        loc = q - off
        answers.append([rdeg[loc] | (ldeg[loc] << 3)])
    back = from_owners(mesh, routing, answers)
    out = []
    for ((rdeg, rnbr, rsame), (ldeg, lnbr, lsame)), (mates,) in zip(rows, back):
        m = rdeg.shape[0]
        mr, ml = mates[:m], mates[m:]
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
    """Pointer doubling over a stride-sharded successor array (succ[i]:
    int64 (cap,) on local shard i = d for nodes [d * cap, (d + 1) * cap),
    -1 at a chain end) with optional running min-labels (labels[i] or
    None).
    Each round routes every unresolved node's pointer to its owner, which
    answers (done, dist & DIST_MASK, ptr, label) as they stood at the
    round's start, and applies the reference's update (mesh.py:561-589).
    A round in which every node is resolved changes nothing, so the loop
    stops there.  Returns per shard (end, dist int32, is_chain, min_label
    or None)."""
    st = []
    for i, (d, s) in enumerate(zip(mesh.local, succ)):
        ids = torch.arange(cap, dtype=torch.int64, device=s.device) + d * cap
        done0 = s < 0
        st.append({
            "done0": done0, "reached": done0.clone(),
            "ptr": torch.where(done0, ids, s),
            "dist": (~done0).to(torch.int32),
            "lab": labels[i] if labels is not None else None,
        })
    for _ in range(rounds):
        if mesh.psum([int(backend.download("unreached", (~x["reached"]).sum()))
                      for x in st]) == 0:
            break
        recv, routing = to_owners(
            mesh, [x["ptr"] // cap for x in st], [[x["ptr"]] for x in st],
            [~x["reached"] for x in st])
        answers = []
        for d, x, (q,) in zip(mesh.local, st, recv):
            loc = q - d * cap
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
    *lanes).  Inputs and outputs are per local shard."""
    recs = []
    for i, d in enumerate(mesh.local):
        ids = torch.arange(cap, dtype=torch.int64, device=end[i].device) + d * cap
        recs.append([end[i], dist[i], ids, *(lanes[i] if lanes else [])])
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
    codes = torch.empty(int(backend.download("codes", L.sum())), dtype=torch.uint8,
                        device=ends.device)
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
    on shard p // pcap) and edges (pa[i], pb[i]: int64 (ecap,) on local
    shard i = d, edge priority d * ecap + j, padding -1).  Each round: (A) live edges
    ask both ports' owners whether the port is free; (B) live edges send
    (port, priority) to the ports' owners, which answer each port's least
    priority; (C) edges least at both ports win and claim both ports.  The
    greedy matching is unique, so this equals core/graph.
    handshake_matching.  Returns per local shard its (pcap,) match (-1
    free)."""
    st = []
    for d, a, b in zip(mesh.local, pa, pb):
        dev = a.device
        st.append({
            "free": torch.ones(pcap, dtype=torch.bool, device=dev),
            "match": torch.full((pcap,), -1, dtype=torch.int64, device=dev),
            "alive": a >= 0,
            "prio": torch.arange(ecap, dtype=torch.int64, device=dev) + d * ecap,
            "ports": torch.cat([a, b]),
        })
    owners = [x["ports"] // pcap for x in st]
    big = torch.iinfo(torch.int64).max
    while mesh.psum([int(backend.download("alive", x["alive"].sum())) for x in st]) > 0:
        # (A) both ports still free?
        recv, routing = to_owners(mesh, owners, [[x["ports"]] for x in st],
                                  [x["alive"].repeat(2) for x in st])
        answers = [[x["free"][q - d * pcap]]
                   for d, x, (q,) in zip(mesh.local, st, recv)]
        for x, (free,) in zip(st, from_owners(mesh, routing, answers)):
            x["alive"] = x["alive"] & free[:ecap] & free[ecap:]
        # (B) each port's least live priority, answered at every record.
        recv, routing = to_owners(
            mesh, owners, [[x["ports"], x["prio"].repeat(2)] for x in st],
            [x["alive"].repeat(2) for x in st])
        answers = []
        for d, (q, prio) in zip(mesh.local, recv):
            loc = q - d * pcap
            best = torch.full((pcap,), big, dtype=torch.int64, device=loc.device)
            best.scatter_reduce_(0, loc, prio, "amin")
            answers.append([best[loc]])
        back = from_owners(mesh, routing, answers, fill=-1)
        wins = [x["alive"] & (b[:ecap] == x["prio"]) & (b[ecap:] == x["prio"])
                for x, (b,) in zip(st, back)]
        # (C) winners claim both ports: (port, partner) to each owner.
        partner = [torch.cat([b, a]) for a, b in zip(pa, pb)]
        recv, _ = to_owners(mesh, owners,
                            [[x["ports"], p] for x, p in zip(st, partner)],
                            [w.repeat(2) for w in wins])
        for d, x, (q, mate), won in zip(mesh.local, st, recv, wins):
            loc = q - d * pcap
            x["match"][loc] = mate
            x["free"][loc] = False
            x["alive"] = x["alive"] & ~won
    return [x["match"] for x in st]


# -- overlap edges (reference mesh.py:1039-1164) ----------------------------


def sharded_overlap_edges(mesh: Mesh, P, S, k: int, ucap: int):
    """Overlap-edge discovery over stride-sharded unitigs (P[i], S[i]:
    int64 first and last k-mers of unitigs [d * ucap, ...) on local shard
    i = d).
    Each shard sends (value << 1 | table bit, unitig id) of its P and S
    to the key's owner, which sorts them into its part of the table; then
    the 16 gluing candidates of every unitig, in the host join's
    discovery order, are routed to their owners and answered with the
    partner's id (-1 where absent).  Keys are unique across an SPSS's
    unitigs; a duplicate raises (on every rank: the check is agreed).
    Returns per local shard (16, m_d) int64."""
    edges2 = owner_edges(k, mesh.size) * 2
    kmask = (1 << (2 * k)) - 1
    owners, recs = [], []
    for d, p, s in zip(mesh.local, P, S):
        ids = torch.arange(p.shape[0], dtype=torch.int64, device=p.device) + d * ucap
        key = torch.cat([p << 1, (s << 1) | 1])
        owners.append(_key_owner(edges2, key))
        recs.append([key, torch.cat([ids, ids])])
    recv, _ = to_owners(mesh, owners, recs)
    table, dups = [], []
    for tk, tv in recv:
        tk, order = torch.sort(tk)
        dups.append(int(backend.download("duplicates", (tk[1:] == tk[:-1]).any())))
        table.append((tk, tv[order]))
    if mesh.psum(dups):
        raise ValueError(
            "overlap edges: duplicate first or last k-mers across the "
            "unitigs (every k-mer of an SPSS appears once)")
    owners, probes = [], []
    for p, s in zip(P, S):
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
    for (tk, tv), (q,) in zip(table, recv):
        found, idx = lookup_join(tk, q)
        answers.append([torch.where(found, tv[idx], -1) if tk.numel()
                        else torch.full_like(q, -1)])
    back = from_owners(mesh, routing, answers, fill=-1)
    return [b[0].view(16, -1) for b in back]


# -- the multi-set programs (reference mesh.py:602-697) ----------------------


def _live(block: torch.Tensor) -> torch.Tensor:
    """The keys of a sorted block before its sentinel padding (S_SENT for
    int32 keys, SENTINEL for int64: ops/pack.key_sentinel)."""
    sent = S_SENT if block.dtype == torch.int32 else SENTINEL
    return block[: int(backend.download("live", (block != sent).sum()))]


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
    (blocks[i]: local shard i's sorted keys on its device, sentinel
    padding allowed), as KmerSet.hash returns it (reference
    sharded_hash_fn, mesh.py:602-618): each shard XORs its live keys, the
    mesh's XOR reduction joins them.  The empty set hashes to 0."""
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
    blocks split at the same owner edges (a_blocks[i], b_blocks[i]: local
    shard i's sorted unique keys, sentinel padding allowed), each shard alone
    (reference sharded_set_algebra_fn, mesh.py:620-665).  Where the
    reference classifies a (key, tag) sort and compacts with a second
    sort, each shard here tests membership with a torch.searchsorted of
    one block into the other and keeps each class in order with kernel B3
    (ops/compact.compact_select): the blocks are sorted already.  Returns
    (inter, a_only, b_only, sizes): per local shard its sorted blocks of
    A ∩ B, A - B and B - A, and the global sizes (3,) int64 where
    Mesh.sum_to leaves them, summed by the mesh's reduction."""
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
    (reference sharded_sketch_weights_fn, mesh.py:667-697): blocks[i] is
    local shard i's (rows, S_d) int64 matrix, its key range of every sketch
    (each row sorted, duplicate-free, SENTINEL-padded, S_d >= 1), and
    pairs a (P, 2) int64 tensor of row pairs.  Each shard answers every
    pair on its own range with ops/sketch._row_intersections (a batched
    searchsorted, no sort); the mesh's reduction sums the partial counts.
    Sketches never move.  Returns (P,) int64 where Mesh.sum_to leaves
    it."""
    parts = []
    for blk in blocks:
        ia, ib = pairs.to(blk.device).unbind(1)
        parts.append(_row_intersections(blk[ia], blk[ib]))
    return mesh.sum_to(parts)
