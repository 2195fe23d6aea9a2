"""The mesh's count (kmerset_tpu_torch/parallel/driver.mesh_count and
mesh.sharded_count) on CPU shards, against the reference's
parallel/driver.mesh_count on its virtual CPU mesh and against the port's
single-device count; exact.

Counterparts of tests/test_parallel.py:44-80 (meshes of 1, 3, 4, 5 and 8
shards), :289-357 (the driver and KmerCounter) and :489-503 (the decode
through the mesh), without the capacity-retry cases: the port's
exchanges send exact split sizes, so a skewed input is exact at once.
"""

import numpy as np
import pytest

from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_counter import KmerCounter as RefCounter
from kmerset_tpu.core.strings import PackedStrings as RefStrings
from kmerset_tpu.parallel import driver as ref_driver
from kmerset_tpu.parallel.mesh import make_mesh
from kmerset_tpu_torch.core import spss
from kmerset_tpu_torch.core.kmer_counter import KmerCounter
from kmerset_tpu_torch.core.strings import PackedStrings
from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.parallel import driver, mesh as mesh_mod
from kmerset_tpu_torch.parallel.mesh import Mesh


def _stream(total: int, seed: int, n_frag: int = 5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, total).astype(np.uint8)
    codes[total // 3 : total // 3 + 300] = codes[:300]  # repeated k-mers
    cuts = np.sort(rng.choice(np.arange(1, total), n_frag - 1, replace=False))
    return codes, np.concatenate([[0], cuts, [total]]).astype(np.int64)


def _cpu_mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n)


@pytest.mark.parametrize("k", [15, 23])
@pytest.mark.parametrize("n_shards", [1, 3, 4, 5, 8])
def test_mesh_count_matches_single_device(n_shards, k):
    codes, offsets = _stream(9000, 10 + k)
    for canonical in (True, False):
        want = backend.device_count(codes, offsets, k, canonical, device="cpu")
        got = driver.mesh_count(codes, offsets, k, canonical, _cpu_mesh(n_shards))
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [15, 23])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_mesh_count_matches_reference_mesh(n_shards, k):
    """The same stream on the reference's virtual mesh of as many XLA CPU
    devices: the same keys and raw counts."""
    codes, offsets = _stream(7000, 30 + k)
    want = ref_driver.mesh_count(codes, offsets, k, True, mesh=make_mesh(n_shards))
    assert want is not None
    got = driver.mesh_count(codes, offsets, k, True, _cpu_mesh(n_shards))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n_shards", [2, 8])
def test_skewed_keys_stay_exact(n_shards):
    """A stream of A and C only: every canonical key is its forward key,
    below half the key space, so on 2 shards every k-mer belongs to shard
    0 (on 8, to shards 0 and 2), and every other shard sends and owns
    nothing."""
    k = 15
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 2, 6000).astype(np.uint8)
    offsets = np.array([0, 2500, 6000], dtype=np.int64)
    edges = mesh_mod.owner_edges(k, n_shards)
    keys, counts = driver.mesh_count(codes, offsets, k, True, _cpu_mesh(n_shards))
    owners = np.searchsorted(edges[1:-1], keys, side="right")
    assert set(owners.tolist()) == ({0} if n_shards == 2 else {0, 2})
    want = backend.device_count(codes, offsets, k, True, device="cpu")
    np.testing.assert_array_equal(keys, want[0])
    np.testing.assert_array_equal(counts, want[1])


def test_input_shorter_than_one_shard():
    """6 windows over 8 shards: shards 6 and 7 pack nothing; a stream
    without a window counts nothing."""
    k = 15
    codes = np.random.default_rng(1).integers(0, 4, k + 5).astype(np.uint8)
    offsets = np.array([0, codes.size], dtype=np.int64)
    got = driver.mesh_count(codes, offsets, k, True, _cpu_mesh(8))
    want = backend.device_count(codes, offsets, k, True, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].size == 6
    keys, counts = driver.mesh_count(codes[:k - 1], np.array([0, k - 1]), k,
                                     True, _cpu_mesh(8))
    assert keys.size == 0 and counts.size == 0


@pytest.mark.parametrize("n_shards", [1, 4])
def test_k31_mesh_count(n_shards):
    """k = 31 keys (B2's widest) on the mesh, all-T windows included (the
    key below the int64 sentinel)."""
    k = 31
    codes, offsets = _stream(6000, 31)
    codes[4000:4100] = 3
    want = backend.device_count(codes, offsets, k, False, device="cpu")
    got = driver.mesh_count(codes, offsets, k, False, _cpu_mesh(n_shards))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][-1] == (1 << 62) - 1


def test_rounds_within_the_shared_ceiling(monkeypatch):
    """Shards on one device share its one-shot ceiling: with a budget of
    900 windows' bytes the 3 shards of one CPU take 300 windows each a
    round, so 9,000 windows take 10 rounds, merged to the one-shot
    result; the decode's keys-only rounds too."""
    k = 15
    codes, offsets = _stream(9000, 77)
    want = driver.mesh_count(codes, offsets, k, True, _cpu_mesh(3))
    budget = 900 * backend.count_bytes_per_window(k)
    monkeypatch.setattr(backend, "memory_budget", lambda device: budget)
    mesh = _cpu_mesh(3)
    assert driver.shard_window_ceiling(mesh, k) == 300
    rounds = []
    real = driver._mesh_count_round
    monkeypatch.setattr(driver, "_mesh_count_round",
                        lambda *a: rounds.append(1) or real(*a))
    got = driver.mesh_count(codes, offsets, k, True, mesh)
    assert len(rounds) == 10
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    keys, none = driver.mesh_count(codes, offsets, k, True, mesh, need_counts=False)
    assert none is None
    np.testing.assert_array_equal(keys, want[0])


def test_kmer_counter_routes_through_the_mesh(monkeypatch):
    """KmerCounter.from_reads on a mesh: the reference's counter's keys
    and saturated counts (counts stay raw out of the mesh and saturate in
    the counter)."""
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    rng = np.random.default_rng(23)
    reads = ["".join("ACGT"[c] for c in rng.integers(0, 4, 500)) for _ in range(6)]
    reads += [reads[0][:100]] * 300
    calls = []
    real = driver.mesh_count
    monkeypatch.setattr(driver, "mesh_count", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = KmerCounter.from_reads(15, reads, True, device="cpu", mesh=_cpu_mesh(4))
    want = RefCounter.from_reads(15, reads, True)
    assert calls
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.counts.max() == 255


@pytest.mark.parametrize("k", [15, 23])
def test_decode_through_the_mesh(k, monkeypatch):
    """decode_unique_kmers on a mesh (keys only) equals the reference's
    host decode (tests/test_parallel.py:489-503)."""
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    rng = np.random.default_rng(29)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    offsets = np.array([0, 1200, 3000], dtype=np.int64)
    for n_shards in (1, 3):
        got = spss.decode_unique_kmers(PackedStrings(codes, offsets), k, True,
                                       device="cpu", mesh=_cpu_mesh(n_shards))
        want = ref_spss.decode_unique_kmers(RefStrings(codes, offsets), k, True)
        np.testing.assert_array_equal(got, want)


def test_error_in_the_mesh_count_raises(monkeypatch):
    """No fallback: an error inside a shard program reaches the caller,
    where the reference's router would return None and count on one
    device."""
    def boom(*a, **kw):
        raise RuntimeError("injected shard failure")

    monkeypatch.setattr(driver, "sharded_count", boom)
    codes, offsets = _stream(2000, 3)
    with pytest.raises(RuntimeError, match="injected shard failure"):
        KmerCounter._from_codes(15, codes, offsets, True, device="cpu",
                                mesh=_cpu_mesh(2))
    with pytest.raises(RuntimeError, match="injected shard failure"):
        spss.decode_unique_kmers(PackedStrings(codes, offsets), 15, True,
                                 device="cpu", mesh=_cpu_mesh(2))


def test_gates_of_an_automatic_mesh():
    """An explicit mesh is forced (every size); an automatic one (a plain
    `cuda` with several GPUs, driver.auto_mesh) takes the reference's size
    gates (ops/backend.py:31, :40, :308); node counts from 2^30 on stay on
    the host path either way; no mesh, no route."""
    forced, auto = _cpu_mesh(2), Mesh(["cpu", "cpu"], forced=False)
    assert driver.should_use_mesh(forced, 1)
    assert not driver.should_use_mesh(auto, driver.MIN_MESH_WINDOWS - 1)
    assert driver.should_use_mesh(auto, driver.MIN_MESH_WINDOWS)
    assert driver.MIN_MESH_WINDOWS == 1 << 21
    assert driver.MAX_ONE_DEVICE_WINDOWS == 1 << 29
    assert driver.should_use_mesh_graph(forced, 1)
    assert not driver.should_use_mesh_graph(auto, driver.MIN_MESH_GRAPH - 1)
    assert driver.should_use_mesh_graph(auto, driver.MIN_MESH_GRAPH)
    assert driver.MIN_MESH_GRAPH == 1 << 23
    for mesh in (forced, auto):
        assert not driver.should_use_mesh_graph(mesh, 1 << 30)
    assert not driver.should_use_mesh(None, 1 << 40)
    assert not driver.should_use_mesh_graph(None, 1)
    import torch

    assert driver.auto_mesh(torch.device("cpu")) is None
