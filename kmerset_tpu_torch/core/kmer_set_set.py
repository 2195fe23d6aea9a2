"""KmerSetSet and KmerSetSetReader on an explicit torch device: joint
compression of many related k-mer sets.

The port's own classes, with the reference's
(kmerset_tpu/core/kmer_set_set.py:219-565) folded in, and its copies of
the helpers they use: reachable_ids, AdjacencyList, _pop_best_pair,
_parallel_map and the adjacency-list (de)serializers (:39-77, 180-216).
The greedy loop repeatedly factors the intersection of the most similar
pair of sets into a new shared child set, recording the parent->child
DAG, so each original set is the union of its residual and every
reachable descendant (reference: lib/core/kmer_set_set.h:89-775).

Every set they hold or load is the port's KmerSetCompact on their
device, or on their mesh of shards (parallel/mesh.Mesh), so each decode
runs the device count pipeline (kernels B1/B2 and B3), on the mesh's
shards where there is one, and each deferred SPSS build runs the device
graph front-end or the mesh's graph phases.  The pair weights of the
greedy loop come from the reference's oracle choice (_make_weight_oracle,
:142-165) without its host oracle and its fallbacks: the port's
MeshSketchTable on the mesh where parallel/driver.should_use_mesh takes
the reference's work estimate, else its DeviceSketchTable on the device;
an error in either raises.  The set algebra (native sorted merges, or numpy), the
heap, the stopping rule, the seeded bucket sample, the adjacency-list
format and the DOT and directory dumps are the reference's, so the
directories are byte-identical to its.
"""

from __future__ import annotations

import heapq
import logging
import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np

from .. import resolve_device
from ..ops.sketch import DeviceSketchTable, MeshSketchTable
from ..parallel import driver as mesh_driver
from ..utils import trace
from ..utils.random import get_random_ints
from . import io as core_io
from . import native
from .arrays import sorted_unique
from .config import KConfig
from .kmer_set import KmerSet
from .kmer_set_compact import KmerSetCompact

logger = logging.getLogger("kmerset")

AdjacencyList = Dict[int, List[int]]


def reachable_ids(children: AdjacencyList, i: int) -> List[int]:
    """BFS over the children DAG from i, in first-seen order — the
    reconstruction set walk shared by KmerSetSet.get and the Reader
    (reference: lib/core/kmer_set_set.h:433-454, 672-694)."""
    ids: List[int] = []
    seen = set()
    queue = deque([i])
    while queue:
        cur = queue.popleft()
        if cur in seen:
            continue
        seen.add(cur)
        ids.append(cur)
        queue.extend(children.get(cur, []))
    return ids


def _pop_best_pair(heap, weights):
    """Max-weight pair via the lazy-deletion heap: pops entries until one
    matches the live `weights` value (stale entries — superseded updates —
    are discarded), returning None when the max weight is 0 (the greedy
    loop's termination, reference: lib/core/kmer_set_set.h:318-322).  The
    (-w, pair) order makes ties break on the smallest pair, exactly the
    full-scan argmax the reference computes each round
    (lib/core/kmer_set_set.h:308-316)."""
    while heap:
        negw, pair = heapq.heappop(heap)
        if weights.get(pair) == -negw:
            if negw < 0:  # all-zero weights end the loop
                return pair
            break
    return None


_serial_noted = False


def _parallel_map(fn, items, workers: int, mesh=None) -> list:
    """ex.map-or-sequential over independent items — the one-task-per-
    item pool shape the reference uses for its file/build fan-outs
    (kmer_set_set.h:494-528,583-607,704-745).  Results in item order;
    the first exception propagates either way.

    Items that may take steps on a `mesh` spanning processes run serially,
    in item order: in a pool their steps would queue on the mesh's lock
    in thread order, which differs between ranks, and the ranks'
    collectives would fall out of step.  Such items are a deferred SPSS
    build, the dump of a set whose build is still deferred (the last
    merges before the heap runs out), and a Reader's load, which decodes
    on the mesh."""
    global _serial_noted
    items = list(items)
    if mesh is not None and mesh.group is not None:
        if workers > 1 and len(items) > 1 and not _serial_noted:
            _serial_noted = True
            logger.info("kmer_set_set: the mesh spans %d processes: items "
                        "that take mesh steps run in item order, not in "
                        "%d workers", mesh.n_ranks, workers)
        return [fn(it) for it in items]
    if workers > 1 and len(items) > 1:
        with ThreadPoolExecutor(max_workers=workers) as ex:
            return list(ex.map(fn, items))
    return [fn(it) for it in items]


def serialize_adjacency_list(adj: AdjacencyList) -> str:
    """Exact reference format: "size key count children ..."
    (reference: kmer_set_set.h:45-56), keys in sorted order."""
    parts = [str(len(adj))]
    for key in sorted(adj):
        parts.append(str(key))
        parts.append(str(len(adj[key])))
        parts.extend(str(v) for v in adj[key])
    return " ".join(parts)


def deserialize_adjacency_list(s: str) -> AdjacencyList:
    """Inverse (reference: kmer_set_set.h:58-85)."""
    tokens = s.split()
    it = iter(tokens)
    size = int(next(it))
    adj: AdjacencyList = {}
    for _ in range(size):
        key = int(next(it))
        count = int(next(it))
        adj[key] = [int(next(it)) for _ in range(count)]
    return adj


def _check_compacts(sets: List[KmerSetCompact]) -> None:
    for s in sets:
        if not isinstance(s, KmerSetCompact):
            raise TypeError(
                "KmerSetSet takes the port's KmerSetCompact (a reference "
                f"compact would decode and build on the host): {type(s)}"
            )


class KmerSetSet:
    def __init__(
        self,
        kmer_sets_compact: List[KmerSetCompact],
        canonical: bool,
        config: KConfig,
        seed: int = 0,
        workers: int = 1,
        _children: AdjacencyList | None = None,
        *,
        device,
        mesh=None,
    ):
        """As the reference's (workers > 1 runs the stopping rule's
        deferred SPSS builds in a thread pool, kmer_set_set.py:220-243);
        the greedy loop's pair weights and the new sets' builds and
        decodes run on `device`, or on `mesh` where its gates take them."""
        self.device = resolve_device(device)
        self.mesh = mesh
        _check_compacts(kmer_sets_compact)
        self.config = config
        self.canonical = canonical
        if _children is not None:
            self.children_: AdjacencyList = _children
            self.kmer_sets_compact_ = kmer_sets_compact
            return
        self.children_ = {}
        self.kmer_sets_compact_ = list(kmer_sets_compact)
        with trace.span("kss.construct", sets=len(kmer_sets_compact)):
            self._compress(canonical, seed, workers)

    def _compress(self, canonical: bool, seed: int, workers: int = 1) -> None:
        cfg = self.config
        sets = self.kmer_sets_compact_
        n_inputs = len(sets)
        if n_inputs == 0:
            return

        # ~2% of buckets sampled (reference: kmer_set_set.h:120-128).
        n_sample = max(1, cfg.n_buckets // 50)
        rng = np.random.default_rng(seed)
        bucket_ids = get_random_ints(
            n_sample, True, True, 0, cfg.n_buckets - 1, rng
        )

        with trace.span("kss.sample", sets=n_inputs):
            sampled: List[np.ndarray] = [
                s.sampled_kmers(cfg, bucket_ids, canonical) for s in sets
            ]
        with trace.span("kss.pack_in_memory"):
            for s in sets:
                s.pack_in_memory()
        # The reference's work estimate of the all-pairs phase
        # (kmer_set_set.py:149-150).
        work = n_inputs * max(1, sum(s.shape[0] for s in sampled)) // 2
        with trace.timed("kss.sketch_build", rows=n_inputs) as sp:
            if mesh_driver.should_use_mesh(self.mesh, work):
                oracle = MeshSketchTable(sampled, cfg.k, self.mesh)
                where = str(self.mesh)
            else:
                oracle = DeviceSketchTable(sampled, device=self.device)
                where = str(self.device)
        oracle_s = sp.seconds
        n_weighed = 0

        def weigh(pairs: List[Tuple[int, int]]) -> list:
            nonlocal oracle_s, n_weighed
            with trace.timed("kss.weigh", pairs=len(pairs)) as sp:
                w = oracle.pair_weights(pairs).tolist()
            oracle_s += sp.seconds
            n_weighed += len(pairs)
            return w

        all_pairs = [
            (i, j) for i in range(n_inputs) for j in range(i + 1, n_inputs)
        ]
        weights: Dict[Tuple[int, int], int] = dict(
            zip(all_pairs, weigh(all_pairs))
        )
        heap = [(-w, p) for p, w in weights.items()]
        heapq.heapify(heap)

        # Stopping rule (reference: kmer_set_set.h:240-302).
        def total_spss_weight() -> int:
            with trace.span("kss.total_weight"):
                _parallel_map(
                    lambda s: s.spss,
                    [s for s in sets if s._pending is not None],
                    workers, self.mesh,
                )
                w = sum(s.weight() for s in sets)
                with trace.span("kss.pack_in_memory"):
                    for s in sets:
                        s.pack_in_memory()
                return w

        total_weight = total_spss_weight()
        interval = n_inputs // 8 + 1
        improvement_threshold = 0.1 * interval / n_inputs

        it = 0
        while True:
            if it > 0 and it % interval == 0:
                updated = total_spss_weight()
                improvement = (total_weight - updated) / total_weight
                if improvement <= improvement_threshold:
                    break
                total_weight = updated
            it += 1

            best_pair = _pop_best_pair(heap, weights)
            if best_pair is None:
                break
            j, k = best_pair

            n = len(sets)
            kj = sets[j].kmers(canonical)
            kk = sets[k].kmers(canonical)
            with trace.span("kss.algebra", kmers=int(kj.shape[0] + kk.shape[0])):
                res = native.sorted_algebra(kj, kk)
                if res is not None:
                    inter, kj2, kk2 = res
                else:
                    inter = np.intersect1d(kj, kk, assume_unique=True)
                    kj2 = np.setdiff1d(kj, inter, assume_unique=True)
                    kk2 = np.setdiff1d(kk, inter, assume_unique=True)

            with trace.span("kss.split"):
                # Lazy: the SPSS build waits until the strings are used.
                sets.append(
                    KmerSetCompact.from_kmer_set(
                        KmerSet(cfg.k, inter, _sorted=True), canonical,
                        lazy=True, device=self.device, mesh=self.mesh,
                    )
                )
                sets[j] = KmerSetCompact.from_kmer_set(
                    KmerSet(cfg.k, kj2, _sorted=True), canonical, lazy=True,
                    device=self.device, mesh=self.mesh,
                )
                sets[k] = KmerSetCompact.from_kmer_set(
                    KmerSet(cfg.k, kk2, _sorted=True), canonical, lazy=True,
                    device=self.device, mesh=self.mesh,
                )
                oracle.append_row(sets[n].sampled_kmers(cfg, bucket_ids,
                                                        canonical))
                oracle.set_row(j, sets[j].sampled_kmers(cfg, bucket_ids,
                                                        canonical))
                oracle.set_row(k, sets[k].sampled_kmers(cfg, bucket_ids,
                                                        canonical))
            self.children_.setdefault(j, []).append(n)
            self.children_.setdefault(k, []).append(n)

            # Update weights of pairs touching j, k, n
            # (reference: kmer_set_set.h:382-425).
            touched: List[Tuple[int, int]] = []
            for l in range(n):
                if l != j:
                    touched.append((min(j, l), max(j, l)))
                if l != k:
                    touched.append((min(k, l), max(k, l)))
                touched.append((l, n))
            upd = dict(zip(touched, weigh(touched)))
            weights.update(upd)
            for p, w in upd.items():
                heapq.heappush(heap, (-w, p))

        logger.debug(
            "kmer_set_set: sketch table on %s %.4f s (%d pair weights, "
            "%d rows)", where, oracle_s, n_weighed, oracle.n,
        )

    def size(self) -> int:
        """The number of compact sets: the originals' residuals and the
        shared children (reference: kmer_set_set.py:384-385)."""
        return len(self.kmer_sets_compact_)

    # -- queries (reference: kmer_set_set.py:390-397) ---------------------

    def get(self, i: int, canonical: bool) -> KmerSet:
        """Original set = residual union all reachable shared children."""
        parts = [
            self.kmer_sets_compact_[j].kmers(canonical)
            for j in reachable_ids(self.children_, i)
        ]
        return KmerSet(self.config.k, sorted_unique(np.concatenate(parts)), _sorted=True)

    # -- persistence (reference: kmer_set_set.py:401-460) ------------------

    def dump(
        self, directory: str, compressor: str, extension: str,
        workers: int = 1,
    ) -> None:
        """Writes meta + one file per compact set; with workers > 1 the
        per-set dumps run as parallel tasks like the reference's
        one-task-per-file pool (reference: kmer_set_set.h:494-528)."""
        os.makedirs(directory, exist_ok=True)
        meta = [
            serialize_adjacency_list(self.children_),
            str(len(self.kmer_sets_compact_)),
        ]
        path = os.path.join(directory, f"meta.{extension}")
        with trace.span("io.dump", file=path):
            core_io.write_lines(path, compressor, meta)

        def _dump_one(i: int) -> None:
            self.kmer_sets_compact_[i].dump(
                os.path.join(directory, f"{i}.{extension}"), compressor
            )

        _parallel_map(_dump_one, range(len(self.kmer_sets_compact_)), workers,
                      self.mesh)

    def dump_graph(self, file_name: str) -> None:
        """DOT format (reference: kmer_set_set.h:532-547): the span
        "io.dump_graph"."""
        with trace.span("io.dump_graph", file=file_name):
            lines = ["digraph G {"]
            for key in sorted(self.children_):
                for child in self.children_[key]:
                    lines.append(f"v{key} -> v{child}")
            lines.append("}")
            core_io.write_lines(file_name, "", lines)

    @classmethod
    def load(
        cls,
        config: KConfig,
        directory: str,
        decompressor: str,
        extension: str,
        canonical: bool,
        workers: int = 1,
        *,
        device,
        mesh=None,
    ) -> "KmerSetSet":
        """The reference's load (:435-460) of port compacts on `device`, or
        on `mesh`; workers > 1 loads the per-set files as parallel tasks."""
        meta = core_io.read_lines(
            os.path.join(directory, f"meta.{extension}"), decompressor
        )
        children = deserialize_adjacency_list(meta[0])
        n = int(meta[1])

        def _load_one(i: int) -> KmerSetCompact:
            return KmerSetCompact.load(
                config.k, os.path.join(directory, f"{i}.{extension}"),
                decompressor, device=device, mesh=mesh,
            )

        sets = _parallel_map(_load_one, range(n), workers)
        return cls(sets, canonical, config, _children=children, device=device,
                   mesh=mesh)


class KmerSetSetReader:
    """The reference's Reader (:463-565): reads meta only and loads the
    files reachable from a requested set, as port compacts decoded on
    `device`, or on `mesh`."""

    def __init__(
        self,
        config: KConfig,
        directory: str,
        extension: str,
        decompressor: str,
        canonical: bool,
        children: AdjacencyList,
        size: int,
        *,
        device,
        mesh=None,
    ):
        self.config = config
        self.directory = directory
        self.extension = extension
        self.decompressor = decompressor
        self.canonical = canonical
        self.children_ = children
        self._size = size
        self.device = resolve_device(device)
        self.mesh = mesh

    @classmethod
    def from_directory(
        cls,
        config: KConfig,
        directory: str,
        extension: str,
        decompressor: str,
        canonical: bool,
        *,
        device,
        mesh=None,
    ) -> "KmerSetSetReader":
        meta = core_io.read_lines(
            os.path.join(directory, f"meta.{extension}"), decompressor
        )
        return cls(
            config, directory, extension, decompressor, canonical,
            deserialize_adjacency_list(meta[0]), int(meta[1]), device=device,
            mesh=mesh,
        )

    def size(self) -> int:
        return self._size

    def _load(self, idx: int) -> np.ndarray:
        s = KmerSetCompact.load(
            self.config.k,
            os.path.join(self.directory, f"{idx}.{self.extension}"),
            self.decompressor,
            device=self.device,
            mesh=self.mesh,
        )
        return s.kmers(self.canonical)

    def get(self, i: int, workers: int = 1) -> KmerSet:
        parts = _parallel_map(
            self._load, reachable_ids(self.children_, i), workers, self.mesh
        )
        return KmerSet(
            self.config.k, sorted_unique(np.concatenate(parts)), _sorted=True
        )

    def get_all(self, workers: int = 1):
        """Yields (i, KmerSet) for every original set, loading and decoding
        each reachable child file once across the sweep, as the
        reference's get_all (:524-565) does.  A cached child array is
        released once no later set needs it, and the whole cache when the
        generator is closed early (the reference keeps it until the
        generator is collected)."""
        n = self._size
        reach = [reachable_ids(self.children_, i) for i in range(n)]
        uses: Dict[int, int] = {}
        for ids in reach:
            for j in ids:
                uses[j] = uses.get(j, 0) + 1

        cache: Dict[int, np.ndarray] = {}
        try:
            for i in range(n):
                ids = reach[i]
                missing = [j for j in ids if j not in cache]
                loaded = _parallel_map(self._load, missing, workers, self.mesh)
                cache.update(zip(missing, loaded))
                parts = [cache[j] for j in ids]
                for j in ids:
                    uses[j] -= 1
                    if uses[j] == 0:
                        del cache[j]
                yield i, KmerSet(
                    self.config.k,
                    sorted_unique(np.concatenate(parts)),
                    _sorted=True,
                )
        finally:
            cache.clear()
