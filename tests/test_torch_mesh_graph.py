"""The mesh's graph programs (kmerset_tpu_torch/parallel/driver.py,
mesh.py: the front-end, pointer doubling, chain grouping and emission,
matching, overlap edges) on CPU shards, against the reference's driver
functions on its virtual CPU mesh of 1 and 4 XLA devices, and against the
port's single-device or host result, also on a mesh of 3 shards; exact.

Counterparts of tests/test_parallel.py:529-1066, without the
capacity-retry cases (the port's exchanges send exact split sizes).
"""

import numpy as np
import pytest

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core import native as ref_native
from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.parallel import driver as ref_driver
from kmerset_tpu.parallel.mesh import make_mesh
from kmerset_tpu_torch.core import native, spss
from kmerset_tpu_torch.core.graph import handshake_matching, pointer_double
from kmerset_tpu_torch.ops import unitigs
from kmerset_tpu_torch.parallel import driver
from kmerset_tpu_torch.parallel import mesh as mesh_mod
from kmerset_tpu_torch.parallel.mesh import Mesh

# The reference's mesh sizes here; the port's also runs 3 shards (not a
# power of two).
REF_SIZES = (1, 4)


@pytest.fixture(autouse=True)
def _host_reference(monkeypatch):
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


def _cpu_mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n)


def _canonical_set(k: int, n: int, seed: int) -> np.ndarray:
    codes = np.random.default_rng(seed).integers(0, 4, n).astype(np.int64)
    return np.unique(kc.canonical(kc.kmers_from_codes(codes, k), k))


def _unitig_graph(A: np.ndarray, k: int):
    """(succ, starts) of the canonical unitig graph of A, from the host
    formulas (tests/test_parallel.py:806-823)."""
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = ref_spss._side_tables(A, k, True)
    term_r = (rdeg != 1) | (np.where(rsame, rdeg[rnbr], ldeg[rnbr]) != 1)
    term_l = (ldeg != 1) | (np.where(lsame, ldeg[lnbr], rdeg[lnbr]) != 1)
    succ = np.empty(2 * A.size, dtype=np.int64)
    succ[0::2] = np.where(term_r, -1, 2 * rnbr + rsame)
    succ[1::2] = np.where(term_l, -1, 2 * lnbr + (~lsame).astype(np.int64))
    starts = np.concatenate([np.flatnonzero(term_l & ~term_r) * 2,
                             np.flatnonzero(term_r & ~term_l) * 2 + 1])
    return succ, starts


def _chains_and_cycles(n: int, seed: int):
    """(succ, starts) of a random functional graph of chains and pure
    cycles, with some chains left out of `starts`, shuffled."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n).astype(np.int64)
    succ = np.full(n, -1, dtype=np.int64)
    cuts = np.sort(rng.choice(np.arange(1, n), n // 25, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    starts = []
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg = perm[lo:hi]
        succ[seg[:-1]] = seg[1:]
        if i < 10:
            succ[seg[-1]] = seg[0]  # a pure cycle
        else:
            starts.append(seg[0])
    starts = np.array(starts[:-3], dtype=np.int64)
    rng.shuffle(starts)
    return succ, starts


# -- d. side tables and the unitig front-end ---------------------------------


@pytest.mark.parametrize("n_shards", [1, 3, 4])
@pytest.mark.parametrize("k,canonical", [(11, True), (15, True), (23, True),
                                         (15, False), (31, False)])
def test_mesh_side_tables_match_host(k, canonical, n_shards):
    A = _canonical_set(k, 5000, k) if canonical else np.unique(
        kc.kmers_from_codes(np.random.default_rng(k).integers(0, 4, 5000), k))
    right, left = driver.mesh_side_tables(A, k, canonical, _cpu_mesh(n_shards))
    for got, is_right in ((right, True), (left, False)):
        if canonical:
            want = ref_spss._side_table_canonical(A, k, right=is_right)
        else:
            want = (*ref_spss._side_table_plain(A, k, right=is_right),
                    np.zeros(A.size, bool))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n_shards", REF_SIZES)
def test_mesh_unitig_succ_matches_reference(n_shards):
    k = 11
    A = _canonical_set(k, 4000, 61)
    got = driver.mesh_unitig_succ(A, k, _cpu_mesh(n_shards))
    want = ref_driver.mesh_unitig_succ(A, k, mesh=make_mesh(n_shards))
    assert want is not None
    single = unitigs.device_unitig_succ(A, k, device="cpu")
    for g, w, s in zip(got, want, single):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


@pytest.mark.parametrize("k", [15, 19, 31])
def test_mesh_unitig_succ_wide_keys_on_3_shards(k):
    A = _canonical_set(k, 4000, 100 + k)
    got = driver.mesh_unitig_succ(A, k, _cpu_mesh(3))
    for g, s in zip(got, unitigs.device_unitig_succ(A, k, device="cpu")):
        np.testing.assert_array_equal(g, s)


def test_mesh_front_end_in_query_rounds(monkeypatch):
    """Shards on one device share its memory budget: at a budget that just
    holds the set's whole-set arrays at twice their size, the 3 shards of
    one CPU query their blocks in rounds (what the arrays leave, over 3
    shards), with the rows of one round; below it the mesh, which has no
    bounded mode, raises."""
    from kmerset_tpu_torch.ops import backend

    k = 15
    A = _canonical_set(k, 5000, 5)
    mesh = _cpu_mesh(3)
    want = driver.mesh_unitig_succ(A, k, mesh)
    want_dir = driver.mesh_side_tables(A, k, False, mesh)
    budget = 2 * driver.MESH_FRONT_END_BYTES_PER_KMER * A.size
    monkeypatch.setattr(backend, "memory_budget", lambda device: budget)
    q = driver.shard_query_chunk(mesh, [A.size // 3] * 3)
    assert q == budget // 2 // driver.MESH_BYTES_PER_QUERY // 3
    rounds = []
    real = mesh_mod._side_table_round
    monkeypatch.setattr(mesh_mod, "_side_table_round",
                        lambda *a: rounds.append(1) or real(*a))
    for g, w in zip(driver.mesh_unitig_succ(A, k, mesh), want):
        np.testing.assert_array_equal(g, w)
    assert len(rounds) >= 2
    for g, w in zip(driver.mesh_side_tables(A, k, False, mesh), want_dir):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(backend, "memory_budget", lambda device: budget - 200)
    with pytest.raises(ValueError, match="one-shot ceiling"):
        driver.mesh_unitig_succ(A, k, mesh)


# -- e. pointer doubling ------------------------------------------------------


@pytest.mark.parametrize("n_shards", REF_SIZES)
def test_mesh_pointer_double_matches_reference(n_shards):
    """A functional graph of chains and cycles whose size is a multiple of
    the shard count: (end, dist, is_chain, min_label) equal the
    reference's mesh and the host pointer_double, bit for bit."""
    rng = np.random.default_rng(91)
    n = 4 * 64
    succ = rng.permutation(n).astype(np.int64)
    succ[rng.random(n) < 0.3] = -1
    labels = rng.integers(0, 1 << 20, n).astype(np.int64)
    got = driver.mesh_pointer_double(succ, labels, mesh=_cpu_mesh(n_shards))
    want = ref_driver.mesh_pointer_double(succ, labels, mesh=make_mesh(n_shards))
    host = pointer_double(succ, labels.copy())
    for g, w, h in zip(got, want, host):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, h)
    assert not got[2].all() and got[2].any()


@pytest.mark.parametrize("n_shards", [3, 4])
def test_mesh_pointer_double_padded_sizes(n_shards):
    """1,001 nodes (not a multiple of the shards, so the stride layout
    pads): the chain nodes' ends and dists, every is_chain and the
    cycles' min labels equal the host's; without labels as well."""
    succ, _ = _chains_and_cycles(1001, 7)
    labels = np.arange(succ.size, dtype=np.int64)
    end, dist, is_chain, mins = driver.mesh_pointer_double(
        succ, labels, mesh=_cpu_mesh(n_shards))
    h_end, h_dist, h_chain, h_mins = pointer_double(succ, labels.copy())
    np.testing.assert_array_equal(is_chain, h_chain)
    np.testing.assert_array_equal(end[is_chain], h_end[h_chain])
    np.testing.assert_array_equal(dist[is_chain], h_dist[h_chain])
    np.testing.assert_array_equal(mins[~is_chain], h_mins[~h_chain])
    end2, dist2, chain2, none = driver.mesh_pointer_double(
        succ, mesh=_cpu_mesh(n_shards))
    assert none is None
    np.testing.assert_array_equal(chain2, is_chain)
    np.testing.assert_array_equal(end2[chain2], end[is_chain])


def test_mesh_pointer_double_cycle_high_rounds():
    """A cycle node's dist doubles to 2^30 by round 30; it travels masked
    to 30 bits beside the done flag, so cycles stay cycles at 33 rounds
    (tests/test_parallel.py:426-455)."""
    import torch

    n = 16
    succ = np.full(n, -1, dtype=np.int64)
    succ[:8] = (np.arange(8) + 1) % 8  # one 8-node cycle
    succ[8], succ[9] = 9, 10  # one 3-node chain
    mesh = _cpu_mesh(4)
    cap = n // 4
    parts = [torch.from_numpy(succ[d * cap:(d + 1) * cap]) for d in range(4)]
    res = mesh_mod.sharded_pointer_double(mesh, parts, None, cap, 33)
    is_chain = np.concatenate([r[2].numpy() for r in res])
    assert not is_chain[:8].any()
    assert is_chain[8:11].all()


# -- f. chain grouping and emission ------------------------------------------


@pytest.mark.parametrize("n_shards", REF_SIZES)
def test_mesh_chain_group_matches_reference_and_native_walk(n_shards):
    succ, starts = _chains_and_cycles(3000, 101)
    got = driver.mesh_chain_group(succ, starts, mesh=_cpu_mesh(n_shards))
    want = ref_driver.mesh_chain_group(succ, starts, mesh=make_mesh(n_shards))
    assert want is not None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    walk = native.chain_walk(succ, starts)
    if walk is not None:
        np.testing.assert_array_equal(got[0], walk[0])
        np.testing.assert_array_equal(got[1], walk[1])


@pytest.mark.parametrize("n_shards", [1, 3])
def test_mesh_chain_group_by_ends_matches_numpy_walk(n_shards, monkeypatch):
    """by_starts=False: the groups in the order of their ends, as the
    numpy walk (the host walk without the library) lays them out."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    succ, starts = _chains_and_cycles(2000, 5)
    got = driver.mesh_chain_group(succ, starts, mesh=_cpu_mesh(n_shards),
                                  by_starts=False)
    want = spss._chains_grouped(succ, starts)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    empty = driver.mesh_chain_group(succ, starts[:0], mesh=_cpu_mesh(n_shards),
                                    by_starts=False)
    np.testing.assert_array_equal(empty[1], [0])


@pytest.mark.parametrize("n_shards", REF_SIZES)
@pytest.mark.parametrize("k,oriented", [(9, False), (11, True), (19, True)])
def test_mesh_emit_chains_matches_reference(k, oriented, n_shards):
    """Grouping with each record's oriented k-mer and the codes rendered on
    the end's owner: nodes, groups, codes and string offsets equal the
    reference's mesh (its 64-bit reverse complement at k = 19)."""
    if oriented:
        A = _canonical_set(k, 5000, 223 + k)
        succ, starts = _unitig_graph(A, k)
    else:
        rng = np.random.default_rng(211)
        A = np.sort(rng.choice(1 << (2 * k), size=2500, replace=False)).astype(np.int64)
        succ, starts = _chains_and_cycles(2500, 211)
    got = driver.mesh_emit_chains(A, k, succ, starts, oriented, mesh=_cpu_mesh(n_shards))
    want = ref_driver.mesh_emit_chains(A, k, succ, starts, oriented,
                                       mesh=make_mesh(n_shards))
    assert want is not None
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_mesh_emit_matches_host_emission_on_3_shards():
    """The rendered codes of the led groups, in start order, equal the
    native walk's groups emitted on the host (tests/test_parallel.py:
    968-1003)."""
    k = 9
    rng = np.random.default_rng(211)
    A = np.sort(rng.choice(1 << (2 * k), size=2500, replace=False)).astype(np.int64)
    succ, starts = _chains_and_cycles(2500, 211)
    ps, nodes = spss._mesh_emit_ordered(A, k, succ, starts, False, _cpu_mesh(3))
    nodes_h, groups_h = spss._chains_grouped(succ, starts)
    if native.get_lib() is not None:
        host = spss._emit_kmer_chains(A, k, nodes_h, groups_h, oriented=False)
        np.testing.assert_array_equal(ps.codes, host.codes)
        np.testing.assert_array_equal(ps.offsets, host.offsets)
    np.testing.assert_array_equal(np.sort(nodes), np.sort(nodes_h))


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_mesh_kept_walk_matches_native_order(n_shards):
    """The kept canonical walk on the mesh, with and without on-mesh
    emission, equals native.chain_walk_kept and its host emission in
    the native mirror-dedup order (tests/test_parallel.py:794-833,
    1006-1048)."""
    if native.get_lib() is None:
        pytest.skip("the native walk order needs libkmerio")
    k = 11
    A = _canonical_set(k, 6000, 103)
    succ, starts = _unitig_graph(A, k)
    mesh = _cpu_mesh(n_shards)
    want = native.chain_walk_kept(succ, starts, lambda s, e: A[s >> 1] >= A[e >> 1])
    kept = spss._mesh_chain_walk_kept(A, succ, starts, mesh)
    np.testing.assert_array_equal(kept[0], want[0])
    np.testing.assert_array_equal(kept[1], want[1])
    ps, nodes = spss._mesh_chain_walk_kept_emit(A, k, succ, starts, mesh)
    host = spss._emit_kmer_chains(A, k, want[0], want[1], oriented=True)
    np.testing.assert_array_equal(ps.codes, host.codes)
    np.testing.assert_array_equal(ps.offsets, host.offsets)
    np.testing.assert_array_equal(np.sort(nodes), np.sort(want[0]))
    ref = ref_spss._mesh_chain_walk_kept(A, succ, starts)
    np.testing.assert_array_equal(kept[0], ref[0])


def test_mesh_kept_emit_rejects_foreign_start():
    """The led-by-starts guard: a start inside a chain, not its origin,
    routes to the host walk (None); the true origin goes through
    (tests/test_parallel.py:458-486)."""
    if native.get_lib() is None:
        pytest.skip("the guard belongs to the native walk order")
    k = 11
    A = np.array([5, 9, 17, 33], dtype=np.int64)
    succ = np.full(8, -1, dtype=np.int64)
    succ[0], succ[2] = 2, 4
    mesh = _cpu_mesh(2)
    assert spss._mesh_chain_walk_kept_emit(A, k, succ, np.array([2]), mesh) is None
    A2 = np.array([33, 9, 17, 5], dtype=np.int64)
    strings, nodes = spss._mesh_chain_walk_kept_emit(A2, k, succ, np.array([0]), mesh)
    np.testing.assert_array_equal(nodes, [0, 2, 4])
    assert strings.offsets.tolist() == [0, k + 2]


# -- g. matching --------------------------------------------------------------


@pytest.mark.parametrize("n_shards", REF_SIZES)
def test_mesh_matching_matches_reference(n_shards):
    rng = np.random.default_rng(113)
    n_ports = 500
    pa = rng.integers(0, n_ports, 2000).astype(np.int64)
    pb = rng.integers(0, n_ports, 2000).astype(np.int64)
    keep = pa != pb
    pa, pb = pa[keep], pb[keep]
    got = driver.mesh_matching(pa, pb, n_ports, mesh=_cpu_mesh(n_shards))
    want = ref_driver.mesh_matching(pa, pb, n_ports, mesh=make_mesh(n_shards))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, handshake_matching(pa, pb, n_ports))


@pytest.mark.parametrize("n_shards", [3, 5])
def test_handshake_matching_routes_to_the_mesh(n_shards, monkeypatch):
    """core/graph.handshake_matching with a mesh: the mesh's rounds
    (self-loops stripped first), equal to the host's."""
    rng = np.random.default_rng(17)
    n_ports = 301
    pa = rng.integers(0, n_ports, 1200).astype(np.int64)
    pb = rng.integers(0, n_ports, 1200).astype(np.int64)
    calls = []
    real = driver.mesh_matching
    monkeypatch.setattr(driver, "mesh_matching",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = handshake_matching(pa, pb, n_ports, mesh=_cpu_mesh(n_shards))
    assert calls
    np.testing.assert_array_equal(got, handshake_matching(pa, pb, n_ports))


# -- h. overlap edges -----------------------------------------------------------


@pytest.mark.parametrize("n_shards", REF_SIZES)
def test_mesh_overlap_edges_match_reference(n_shards):
    k = 11
    A = _canonical_set(k, 6000, 131)
    unitigs_ = ref_spss.get_unitigs_canonical(ref_spss.KmerSet(k, A, _sorted=True))
    P, S = unitigs_.first_kmers(k), unitigs_.last_kmers(k)
    got = driver.mesh_overlap_edges(P, S, k, mesh=_cpu_mesh(n_shards))
    want = ref_driver.mesh_overlap_edges(P, S, k, mesh=make_mesh(n_shards))
    assert want is not None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    host = ref_native.overlap_edges(P, S, k)
    if host is not None:
        np.testing.assert_array_equal(got[0], host[0])
        np.testing.assert_array_equal(got[1], host[1])


def test_mesh_overlap_edges_k31_and_duplicates_raise():
    """k = 31 is the host join's (the reference's sentinel guard), and
    duplicated first/last k-mers, which no SPSS holds, raise."""
    P = np.array([1, 2, 3], dtype=np.int64)
    with pytest.raises(ValueError, match="k = 31"):
        driver.mesh_overlap_edges(P, P + 7, 31, mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="duplicate"):
        driver.mesh_overlap_edges(np.array([1, 1, 3]), P + 7, 15, mesh=_cpu_mesh(2))
