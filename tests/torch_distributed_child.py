"""One rank of tests/test_torch_distributed.py's process groups.

    python tests/torch_distributed_child.py lib RANK WORLD INIT_FILE OUT_DIR N_LOCAL
    python tests/torch_distributed_child.py fault RANK WORLD INIT_FILE
    python tests/torch_distributed_child.py steps RANK WORLD INIT_FILE

`lib` joins a gloo group (a file:// rendezvous at INIT_FILE, so parallel
test runs share no port) with N_LOCAL CPU shards of one mesh over the
group, and runs every mesh program of kmerset_tpu_torch/parallel/ on it:
each result is held against the port's single-process mesh of the same
global shard count and against the port's single-device or host path,
and saved under OUT_DIR as rank{RANK}_{name}.npy for the parent to hold
against the reference's host functions.  It writes rank{RANK}.json with
each case's outcome ("ok" or the failed check) and prints "rank R: ok".
The inputs are made from fixed seeds, the same on every rank.

`fault` raises on rank 1 just before a mesh step; `steps` has the ranks
start differently named steps.  Both must end every rank non-zero.

The process imports neither jax nor the JAX package.
"""

import sys

# Any import of jax or of the JAX package now raises ImportError.
sys.modules["jax"] = None
sys.modules["kmerset_tpu"] = None

import datetime  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from kmerset_tpu_torch.core import graph, native, spss  # noqa: E402
from kmerset_tpu_torch.core.kmer_set import KmerSet  # noqa: E402
from kmerset_tpu_torch.ops import backend, sketch  # noqa: E402
from kmerset_tpu_torch.ops.unitigs import device_unitig_succ  # noqa: E402
from kmerset_tpu_torch.parallel import driver, mesh as mesh_mod  # noqa: E402
from kmerset_tpu_torch.parallel.mesh import Mesh  # noqa: E402

TIMEOUT_S = 60


def join(rank: int, world: int, init_file: str) -> None:
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))


def _stream(total: int, seed: int, n_frag: int = 4):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, total).astype(np.uint8)
    codes[total // 3: total // 3 + 200] = codes[:200]  # repeated k-mers
    cuts = np.sort(rng.choice(np.arange(1, total), n_frag - 1, replace=False))
    return codes, np.concatenate([[0], cuts, [total]]).astype(np.int64)


def _genome_set(k: int, n_bases: int, seed: int) -> np.ndarray:
    """The sorted canonical k-mers of a random genome: a set whose unitig
    graph has branches."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n_bases).astype(np.uint8)
    codes[n_bases // 2: n_bases // 2 + 60] = codes[100:160]
    offsets = np.array([0, n_bases], dtype=np.int64)
    keys, _ = backend.device_count(codes, offsets, k, True, device="cpu")
    return keys


def _chains(n: int, seed: int):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int64)
    succ = np.full(n, -1, dtype=np.int64)
    succ[perm[:-1]] = perm[1:]
    cuts = list(range(12, n - 1, 13))
    for c in cuts:
        succ[perm[c]] = -1
    starts = perm[[0] + [c + 1 for c in cuts]]
    return succ, starts


def _same(what: str, got, want) -> None:
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(f"{what}[{i}]", g, w)
        return
    if got is None or want is None:
        assert got is None and want is None, what
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape and np.array_equal(g, w), what


class Cases:
    """The mesh programs, each against the single-process mesh of the
    same global shard count and the single-device or host path."""

    def __init__(self, mesh: Mesh, single: Mesh, rank: int):
        self.mesh, self.single, self.rank = mesh, single, rank
        self.saved = {}

    def save(self, name: str, arr) -> None:
        self.saved[name] = np.asarray(arr)

    def case_hash(self):
        rng = np.random.default_rng(1)
        A = np.unique(rng.integers(0, 1 << 22, 5000)).astype(np.int64)
        blocks, _ = driver._key_blocks(self.mesh, A, 11)
        got = mesh_mod.sharded_hash(self.mesh, blocks)
        want = int(np.bitwise_xor.reduce(A)) & ((1 << 64) - 1)
        s_blocks, _ = driver._key_blocks(self.single, A, 11)
        assert got == want == mesh_mod.sharded_hash(self.single, s_blocks)
        # The empty set hashes to 0.
        empty, _ = driver._key_blocks(self.mesh, A[:0], 11)
        assert mesh_mod.sharded_hash(self.mesh, empty) == 0
        self.save("hash", np.array([got], dtype=np.uint64))

    def case_set_algebra(self):
        rng = np.random.default_rng(2)
        A = np.unique(rng.integers(0, 1 << 22, 4000)).astype(np.int64)
        B = np.unique(np.concatenate([A[::3], rng.integers(0, 1 << 22, 2000)]))
        a, _ = driver._key_blocks(self.mesh, A, 11)
        b, _ = driver._key_blocks(self.mesh, B, 11)
        inter, a_only, b_only, sizes = mesh_mod.sharded_set_algebra(self.mesh, a, b)
        got = [self.mesh.gather(x, torch.int64) for x in (inter, a_only, b_only)]
        want = [np.intersect1d(A, B), np.setdiff1d(A, B), np.setdiff1d(B, A)]
        _same("algebra", got, want)
        assert sizes.tolist() == [w.size for w in want], sizes
        for name, arr in zip(("inter", "a_only", "b_only"), got):
            self.save(f"algebra_{name}", arr)
        self.save("algebra_A", A)
        self.save("algebra_B", B)

    def _count(self, k: int, seed: int, canonical: bool = True):
        codes, offsets = _stream(6000, seed)
        got = driver.mesh_count(codes, offsets, k, canonical, self.mesh)
        _same("count vs single mesh", got,
              driver.mesh_count(codes, offsets, k, canonical, self.single))
        _same("count vs one device", got,
              backend.device_count(codes, offsets, k, canonical, device="cpu"))
        decode = driver.mesh_count(codes, offsets, k, canonical, self.mesh,
                                   need_counts=False)
        _same("decode", decode[0], got[0])
        return codes, offsets, got

    def case_count(self):
        codes, offsets, (keys, counts) = self._count(11, 3)
        self.save("count_codes", codes)
        self.save("count_offsets", offsets)
        self.save("count_keys", keys)
        self.save("count_counts", counts)

    def case_count_k19(self):
        _, _, (keys, _) = self._count(19, 4, canonical=False)
        self.save("count19_keys", keys)

    def case_count_rounds(self):
        """The count in rounds, forced by a small shard window ceiling."""
        saved = driver.shard_window_ceiling
        driver.shard_window_ceiling = lambda mesh, k: 700
        try:
            self._count(11, 5)
        finally:
            driver.shard_window_ceiling = saved

    def case_count_agreed(self):
        """Each rank sees another memory budget: the ranks agree on the
        least window ceiling, so every rank counts in the same rounds."""
        saved = backend.memory_budget
        backend.memory_budget = lambda dev: 48 * 900 * (self.rank + 1)
        try:
            ceiling = driver.shard_window_ceiling(self.mesh, 11)
            want = max(1, 900 // max(len(self.mesh.local), 1))
            if self.rank == 0 and self.mesh.local:
                assert ceiling == want, (ceiling, want)
            self._count(11, 6)
        finally:
            backend.memory_budget = saved

    def case_unitig_succ(self):
        A = _genome_set(11, 3000, 7)
        got = driver.mesh_unitig_succ(A, 11, self.mesh)
        _same("front-end vs single mesh", got,
              driver.mesh_unitig_succ(A, 11, self.single))
        _same("front-end vs one device", got,
              device_unitig_succ(A, 11, device="cpu"))
        self.save("succ_A", A)
        self.save("succ", got[0])
        self.save("succ_term_l", got[1])
        self.save("succ_term_r", got[2])

    def case_unitig_succ_chunked(self):
        """Side tables in query rounds: a budget that differs by rank, so
        the ranks agree on the least query chunk."""
        A = _genome_set(11, 3000, 8)
        saved = backend.memory_budget
        backend.memory_budget = lambda dev: (
            2 * driver.MESH_FRONT_END_BYTES_PER_KMER * A.shape[0]
            + driver.MESH_BYTES_PER_QUERY * 97 * (self.rank + 1))
        try:
            got = driver.mesh_unitig_succ(A, 11, self.mesh)
        finally:
            backend.memory_budget = saved
        _same("chunked front-end", got, device_unitig_succ(A, 11, device="cpu"))

    def case_side_tables_directed(self):
        rng = np.random.default_rng(9)
        A = np.unique(rng.integers(0, 1 << 18, 3000)).astype(np.int64)
        got = driver.mesh_side_tables(A, 9, False, self.mesh)
        _same("directed side tables", got,
              driver.mesh_side_tables(A, 9, False, self.single))
        _same("directed side tables vs host", [got[0][:2], got[1][:2]],
              list(spss._side_tables_directed(A, 9)))

    def case_pointer_double(self):
        succ, _ = _chains(500, 10)
        # Two cycles beside the chains.
        succ = np.concatenate([succ, [501, 502, 500], [504, 503]]).astype(np.int64)
        labels = np.random.default_rng(11).integers(0, 1000, succ.size).astype(np.int64)
        got = driver.mesh_pointer_double(succ, labels, mesh=self.mesh)
        _same("pointer doubling vs single mesh", got,
              driver.mesh_pointer_double(succ, labels, mesh=self.single))
        want = graph.pointer_double(succ, labels)
        _same("pointer doubling vs host", got, want)
        self.save("pd_end", got[0])

    def case_chain_group(self):
        succ, starts = _chains(400, 12)
        got = driver.mesh_chain_group(succ, starts, mesh=self.mesh)
        exp_nodes, exp_groups = [], [0]
        for s0 in starts:
            u = int(s0)
            while u >= 0:
                exp_nodes.append(u)
                u = int(succ[u])
            exp_groups.append(len(exp_nodes))
        _same("chain grouping", got, (np.array(exp_nodes), np.array(exp_groups)))
        _same("chain grouping vs single mesh", got,
              driver.mesh_chain_group(succ, starts, mesh=self.single))

    def case_emission(self):
        succ, starts = _chains(400, 13)
        A = np.sort(np.random.default_rng(14).choice(1 << 18, size=400, replace=False)).astype(np.int64)
        em = spss._mesh_emit_ordered(A, 9, succ, starts, False, self.mesh)
        nodes, groups = driver.mesh_chain_group(succ, starts, mesh=self.single)
        want = spss._emit_kmer_chains(A, 9, nodes, groups, oriented=False)
        assert em[0].to_lines_bytes() == want.to_lines_bytes(), "emission"
        raw = driver.mesh_emit_chains(A, 9, succ, starts, False, mesh=self.mesh)
        _same("emission vs single mesh", raw,
              driver.mesh_emit_chains(A, 9, succ, starts, False, mesh=self.single))
        self.save("emit_codes", raw[2])

    def case_matching(self):
        rng = np.random.default_rng(15)
        pa = rng.integers(0, 400, 1500).astype(np.int64)
        pb = rng.integers(0, 400, 1500).astype(np.int64)
        keep = pa != pb
        pa, pb = pa[keep], pb[keep]
        got = driver.mesh_matching(pa, pb, 400, mesh=self.mesh)
        _same("matching vs host", got, graph.handshake_matching(pa, pb, 400))
        _same("matching vs single mesh", got,
              driver.mesh_matching(pa, pb, 400, mesh=self.single))
        self.save("match_pa", pa)
        self.save("match_pb", pb)
        self.save("match", got)

    def case_overlap_edges(self):
        A = _genome_set(11, 3000, 16)
        unitigs = spss.get_unitigs_canonical(KmerSet(11, A, _sorted=True), device="cpu")
        P, S = unitigs.first_kmers(11), unitigs.last_kmers(11)
        got = driver.mesh_overlap_edges(P, S, 11, mesh=self.mesh)
        _same("overlap edges vs single mesh", got,
              driver.mesh_overlap_edges(P, S, 11, mesh=self.single))
        want = native.overlap_edges(P, S, 11)
        if want is not None:
            _same("overlap edges vs host join", got, want)
        self.save("ov_P", P)
        self.save("ov_S", S)
        self.save("ov_a", got[0])
        self.save("ov_b", got[1])

    def case_sketch(self):
        rng = np.random.default_rng(17)
        sk = [np.unique(rng.integers(0, 1 << 22, 300)).astype(np.int64) for _ in range(6)]
        table = sketch.MeshSketchTable(sk, 11, self.mesh)
        ref = sketch.DeviceSketchTable(sk, device="cpu")
        table.set_row(2, sk[2][::2])
        ref.set_row(2, sk[2][::2])
        for tb in (table, ref):
            tb.append_row(sk[0][1::2])
            tb.append_row(sk[1][::3])
        pairs = [(i, j) for i in range(8) for j in range(i + 1, 8)]
        got = table.pair_weights(pairs)
        _same("pair weights", got, ref.pair_weights(pairs))
        single = sketch.MeshSketchTable(sk, 11, self.single)
        _same("pair weights vs single mesh", table.pair_weights(pairs[:5]),
              single.pair_weights(pairs[:5]))
        self.save("weights", got)

    def case_exchange_hazards(self):
        """Bool lanes (uint8 on the wire), zero-length parts, and owners
        that receive nothing, through to_owners and from_owners."""
        m = self.mesh
        owners, lanes, valid = [], [], []
        for i, d in enumerate(m.local):
            n_rec = 0 if d % 2 else 37 + d
            own = torch.full((n_rec,), m.size - 1, dtype=torch.int64)
            owners.append(own)
            lanes.append([torch.arange(n_rec, dtype=torch.int64) + 1000 * d,
                          torch.arange(n_rec) % 3 == 0])
            valid.append(torch.arange(n_rec) % 2 == 0)
        recv, routing = mesh_mod.to_owners(m, owners, lanes, valid)
        for j, d in enumerate(m.local):
            ids, flags = recv[j]
            if d != m.size - 1:
                assert ids.numel() == 0 and flags.numel() == 0
                continue
            want = np.concatenate([np.arange(0, 37 + s, 2) + 1000 * s
                                   for s in range(0, m.size, 2)])
            _same("records at the last shard", ids.numpy(), want)
            assert flags.dtype == torch.bool
            _same("bool lane", flags.numpy(), (want % 1000) % 3 == 0)
        back = mesh_mod.from_owners(m, routing, [[r[0] * 2, r[1]] for r in recv],
                                    fill=-1)
        for i, d in enumerate(m.local):
            n_rec = 0 if d % 2 else 37 + d
            want = np.where(np.arange(n_rec) % 2 == 0,
                            2 * (np.arange(n_rec) + 1000 * d), -1)
            _same("answers back", back[i][0].numpy(), want)
            assert back[i][1].dtype == torch.bool

    def case_local_only(self):
        """A rank's program takes only its local shards' inputs and gives
        the single-process mesh's results for them; the whole n x n table
        of parts is refused."""
        m, one = self.mesh, self.single
        codes, offsets = _stream(5000, 18)
        n_windows = codes.shape[0] - 10
        W = -(-n_windows // m.size)
        chunks = list(backend.chunk_slices(codes, offsets, 11, W))
        stage = lambda d: backend.stage(*chunks[d], 11, "cpu") if d < len(chunks) else None  # noqa: E731
        got = mesh_mod.sharded_count(m, [stage(d) for d in m.local], 11, True)
        whole = mesh_mod.sharded_count(one, [stage(d) for d in range(one.size)], 11, True)
        for (keys, counts), d in zip(got, m.local):
            _same(f"owner {d}", (keys, counts), whole[d])
        if m.size > len(m.local):
            parts = [[torch.empty(0, dtype=torch.int64)] * m.size] * m.size
            try:
                m.all_to_all(parts)
            except ValueError:
                pass
            else:
                raise AssertionError("all_to_all took every shard's parts")

    def run(self, out_dir: str) -> dict:
        outcome = {}
        for name in sorted(n for n in dir(self) if n.startswith("case_")):
            try:
                getattr(self, name)()
                outcome[name[5:]] = "ok"
            except Exception as e:  # noqa: BLE001 - reported to the parent
                outcome[name[5:]] = f"failed: {e!r} {traceback.format_exc()}"
        for name, arr in self.saved.items():
            np.save(os.path.join(out_dir, f"rank{self.rank}_{name}.npy"), arr)
        return outcome


def lib(rank: int, world: int, init_file: str, out_dir: str, n_local: int) -> None:
    join(rank, world, init_file)
    mesh = Mesh(["cpu"] * n_local, group=dist.group.WORLD)
    assert mesh.transport == "gloo" and mesh.size == sum(
        mesh.all_gather([1] * n_local)), mesh
    assert all(mesh.rank_of(d) == rank for d in mesh.local)
    single = Mesh(["cpu"] * mesh.size)
    outcome = Cases(mesh, single, rank).run(out_dir)
    outcome["layout"] = {"size": mesh.size, "local": list(mesh.local)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(outcome, f)
    dist.destroy_process_group()
    print(f"rank {rank}: ok", flush=True)


def fault(rank: int, world: int, init_file: str) -> None:
    """Rank 1 fails just before the step that rank 0 enters."""
    join(rank, world, init_file)
    mesh = Mesh(["cpu", "cpu"], group=dist.group.WORLD)
    codes, offsets = _stream(4000, 19)
    driver.mesh_count(codes, offsets, 11, True, mesh)
    if rank == 1:
        raise RuntimeError("injected fault on rank 1")
    driver.mesh_count(codes, offsets, 11, True, mesh)
    print(f"rank {rank}: finished", flush=True)


def steps(rank: int, world: int, init_file: str) -> None:
    """The ranks start differently named steps: each raises."""
    join(rank, world, init_file)
    mesh = Mesh(["cpu"], group=dist.group.WORLD)
    with driver._step("count" if rank == 0 else "decode", mesh):
        pass
    print(f"rank {rank}: finished", flush=True)


if __name__ == "__main__":
    mode, rank, world, init_file = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    if mode == "lib":
        lib(rank, world, init_file, sys.argv[5], int(sys.argv[6]))
    elif mode == "fault":
        fault(rank, world, init_file)
    else:
        steps(rank, world, init_file)
