"""The multi-set half of the mesh on CPU shards: the XOR hash, the set
algebra and the sketch weights (kmerset_tpu_torch/parallel/mesh.py), the
sharded sketch table (ops/sketch.MeshSketchTable) and the multi-set
compressor and Reader on a mesh (core/kmer_set_set.py); exact.

Each program runs at 1, 3, 4 and 8 shards against numpy, and at 1 and 4
against the reference's program on its virtual XLA CPU mesh of as many
devices (tests/test_parallel.py:134-217), on a random set, a skewed one
(every key in shard 0's range), empty sets and a k = 31 set holding the
top key of the 62-bit range.  The compressor on 4 shards is held against
the reference's under its mesh backend (tests/test_parallel.py:506-527,
tests/test_kmer_set_set.py:261-290) and against the port's single
device: the same child DAG, sets and directory bytes.
"""

import filecmp
import logging

import numpy as np
import pytest
import torch

from kmerset_tpu.core.config import get_config
from kmerset_tpu.core.kmer_set_set import KmerSetSet as RefSet
from kmerset_tpu.ops.sketch import MeshSketchTable as RefMeshTable
from kmerset_tpu.parallel.mesh import (
    make_mesh,
    sharded_hash_fn,
    sharded_set_algebra_fn,
    sharded_sketch_weights_fn,
)
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.core.kmer_set_set import KmerSetSet, KmerSetSetReader
from kmerset_tpu_torch.ops import backend, sketch
from kmerset_tpu_torch.ops.pack import S_SENT, SENTINEL
from kmerset_tpu_torch.ops.sketch import DeviceSketchTable, MeshSketchTable
from kmerset_tpu_torch.parallel import driver
from kmerset_tpu_torch.parallel import mesh as mesh_mod
from kmerset_tpu_torch.parallel.mesh import (
    Mesh,
    owner_edges,
    sharded_hash,
    sharded_set_algebra,
    sharded_sketch_weights,
)

from .test_torch_kmer_set_set import _port_compacts, _ref_compacts, _same_dirs, _strains
from .test_torch_sketch import _all_pairs, _host, _sketches

SHARDS = [1, 3, 4, 8]
CASES = ["random", "skewed", "empty", "k31_top"]


@pytest.fixture(autouse=True)
def _host_reference(monkeypatch):
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


def _cpu_mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n)


def _keys(case: str, seed: int, n: int = 700):
    """(k, sorted unique int64 keys) of a case: random k = 15 keys, keys
    all below 2^26 (in shard 0's range at up to 8 shards), none, or
    random k = 31 keys with the top key 2^62 - 1."""
    rng = np.random.default_rng(seed)
    if case == "random":
        return 15, np.unique(rng.integers(0, 1 << 30, n))
    if case == "skewed":
        return 15, np.unique(rng.integers(0, 1 << 26, n))
    if case == "empty":
        return 15, np.empty(0, np.int64)
    keys = rng.integers(0, 1 << 62, n)
    return 31, np.unique(np.append(keys, (1 << 62) - 1))


def _blocks(x: np.ndarray, k: int, n: int, pad: int = 0, dtype=torch.int64):
    """Sorted x as key-range blocks of n CPU shards, each followed by
    `pad` sentinels of its dtype."""
    cuts = np.searchsorted(x, owner_edges(k, n)[1:-1])
    sent = S_SENT if dtype == torch.int32 else SENTINEL
    return [torch.from_numpy(np.concatenate([p, np.full(pad, sent, np.int64)])).to(dtype)
            for p in np.split(x, cuts)]


def _ref_layout(x: np.ndarray, k: int, n: int, cap: int) -> np.ndarray:
    """The reference's sharded layout: device d's cap slots hold its key
    range, SENTINEL-padded."""
    out = np.full(n * cap, SENTINEL, dtype=np.int64)
    for d, p in enumerate(np.split(x, np.searchsorted(x, owner_edges(k, n)[1:-1]))):
        out[d * cap : d * cap + p.size] = p
    return out


def _cap(*arrays) -> int:
    return max(1, max(a.size for a in arrays)) + 1


# -- the collectives ---------------------------------------------------------


def test_tensor_reductions_land_on_the_named_shard():
    mesh = _cpu_mesh(3)
    vals = [torch.tensor([1, 6, 1 << 40]) * (d + 1) for d in range(3)]
    assert mesh.sum_to(vals, shard=2).tolist() == [6, 36, 6 << 40]
    assert mesh.xor_to(vals).tolist() == [1 ^ 2 ^ 3, 6 ^ 12 ^ 18, (1 << 40) ^ (2 << 40) ^ (3 << 40)]
    with pytest.raises(ValueError, match="3 tensors"):
        mesh.sum_to(vals[:2])
    with pytest.raises(ValueError, match="same-shaped"):
        mesh.xor_to([vals[0], vals[1], vals[2][:2]])
    assert mesh.psum([1, 2, 3]) == 6
    assert str(mesh) == "mesh of 3 shards (cpu)"


# -- the XOR hash (reference mesh.py:602-618) --------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_hash(n_shards, case):
    k, x = _keys(case, 40 + n_shards)
    want = KmerSet(k, x, _sorted=True).hash()
    assert want == (int(np.bitwise_xor.reduce(x)) if x.size else 0)
    mesh = _cpu_mesh(n_shards)
    assert sharded_hash(mesh, _blocks(x, k, n_shards)) == want
    assert sharded_hash(mesh, _blocks(x, k, n_shards, pad=5)) == want
    if k <= 15:  # int32 keys, S_SENT padding
        assert sharded_hash(mesh, _blocks(x, k, n_shards, 3, torch.int32)) == want
    if n_shards in (1, 4):
        fn = sharded_hash_fn(make_mesh(n_shards))
        ref = int(np.asarray(fn(_ref_layout(x, k, n_shards, _cap(x))))[0])
        assert ref == want


# -- the set algebra (reference mesh.py:620-665) -----------------------------


def _pair(case: str, seed: int):
    """(k, A, B): B is a random two thirds of A and as many new keys."""
    k, a = _keys(case, seed)
    rng = np.random.default_rng(seed + 1)
    if case == "empty":
        return k, a, _keys("random", seed)[1]
    top = (1 << 62) if k == 31 else (1 << 26 if case == "skewed" else 1 << 30)
    keep = a[rng.random(a.size) < 2 / 3]
    new = np.setdiff1d(rng.integers(0, top, keep.size), a)
    return k, a, np.union1d(keep, new)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_set_algebra(n_shards, case):
    k, a, b = _pair(case, 50 + n_shards)
    want = (np.intersect1d(a, b), np.setdiff1d(a, b), np.setdiff1d(b, a))
    mesh = _cpu_mesh(n_shards)
    for pad in (0, 4):
        *parts, sizes = sharded_set_algebra(mesh, _blocks(a, k, n_shards, pad),
                                            _blocks(b, k, n_shards, pad))
        for got, w in zip(parts, want):
            assert len(got) == n_shards
            np.testing.assert_array_equal(torch.cat(got).numpy(), w)
        assert sizes.tolist() == [w.size for w in want]
    # Each result block lies in its shard's key range.
    edges = owner_edges(k, n_shards)
    for d, blk in enumerate(parts[0]):
        assert ((blk >= int(edges[d])) & (blk < int(edges[d + 1]))).all()
    if n_shards in (1, 4):
        cap = _cap(a, b)
        fn = sharded_set_algebra_fn(make_mesh(n_shards))
        *ref, ref_sizes = fn(_ref_layout(a, k, n_shards, cap),
                             _ref_layout(b, k, n_shards, cap))
        for r, w in zip(ref, want):
            r = np.asarray(r)
            np.testing.assert_array_equal(np.sort(r[r != SENTINEL]), w)
        assert np.asarray(ref_sizes)[0].tolist() == sizes.tolist()


def test_set_algebra_of_two_empty_sets():
    mesh = _cpu_mesh(4)
    e = _blocks(np.empty(0, np.int64), 15, 4, pad=2)
    *parts, sizes = sharded_set_algebra(mesh, e, e)
    assert sizes.tolist() == [0, 0, 0]
    assert all(p.numel() == 0 for blocks in parts for p in blocks)


# -- the sketch weights (reference mesh.py:667-697) --------------------------


def _sketch_set(case: str, seed: int, n_sets: int = 6):
    """(k, sketches): related sorted sketches of a case (an empty one
    among them; every one empty in the empty case)."""
    rng = np.random.default_rng(seed)
    k, pool = _keys("k31_top" if case == "k31_top" else
                    ("random" if case == "empty" else case), seed, 900)
    out = []
    for i in range(n_sets):
        keep = pool[rng.random(pool.size) < rng.uniform(0.2, 0.8)]
        out.append(keep if case != "empty" else np.empty(0, np.int64))
    out[1] = np.empty(0, np.int64)
    return k, out


def _sketch_blocks(sketches, k: int, n: int):
    """Each shard's (rows, S_d) SENTINEL-padded matrix of its key range."""
    parts = [np.split(s, np.searchsorted(s, owner_edges(k, n)[1:-1])) for s in sketches]
    out = []
    for d in range(n):
        w = max(1, max(p[d].size for p in parts))
        mat = np.full((len(sketches), w), SENTINEL, dtype=np.int64)
        for i, p in enumerate(parts):
            mat[i, : p[d].size] = p[d]
        out.append(torch.from_numpy(mat))
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n_shards", SHARDS)
def test_sharded_sketch_weights(n_shards, case):
    k, sk = _sketch_set(case, 60 + n_shards)
    pairs = _all_pairs(len(sk)) + [(3, 3), (5, 0)]
    want = _host(sk, pairs)
    got = sharded_sketch_weights(_cpu_mesh(n_shards), _sketch_blocks(sk, k, n_shards),
                                 torch.tensor(pairs, dtype=torch.int64))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    if n_shards in (1, 4):
        per_dev = max(1, max(s.size for s in sk))
        mat = np.stack([_ref_layout(s, k, n_shards, per_dev) for s in sk])
        ia, ib = (np.array(c, dtype=np.int32) for c in zip(*pairs))
        ref = np.asarray(sharded_sketch_weights_fn(make_mesh(n_shards))(mat, ia, ib))
        np.testing.assert_array_equal(ref, want)


# -- the sharded sketch table (reference ops/sketch.py:132-225) --------------


@pytest.mark.parametrize("n_shards", [1, 4])
def test_mesh_table_matches_reference_table(n_shards):
    """tests/test_parallel.py:197-217's case on both tables."""
    k = 9
    rng = np.random.default_rng(12)
    sketches = [np.unique(rng.integers(0, 1 << (2 * k), 300)).astype(np.int64)
                for _ in range(4)]
    port = MeshSketchTable(sketches, k, _cpu_mesh(n_shards))
    ref = RefMeshTable(sketches, k, make_mesh(n_shards))
    pairs = _all_pairs(4)
    np.testing.assert_array_equal(port.pair_weights(pairs), ref.pair_weights(pairs))
    np.testing.assert_array_equal(port.pair_weights(pairs), _host(sketches, pairs))
    new = np.unique(rng.integers(0, 1 << (2 * k), 200)).astype(np.int64)
    port.set_row(1, new)
    ref.set_row(1, new)
    assert port.append_row(sketches[0]) == ref.append_row(sketches[0]) == 4
    cur = [sketches[0], new, sketches[2], sketches[3], sketches[0]]
    pairs = _all_pairs(5) + [(1, 4)]
    got = port.pair_weights(pairs)
    np.testing.assert_array_equal(got, ref.pair_weights(pairs))
    np.testing.assert_array_equal(got, _host(cur, pairs))
    # Each shard is as wide as the widest first sketch's part in its range,
    # where the reference gives every shard pow2(widest whole sketch).
    edges = owner_edges(k, n_shards)
    for d, w in enumerate(port.widths):
        assert w == max(((s >= edges[d]) & (s < edges[d + 1])).sum() for s in sketches)
    assert sum(port.widths) <= ref.per_dev * n_shards
    assert [r.shape for r in port.rows] == [(5, w) for w in port.widths]


@pytest.mark.parametrize("n_shards", [1, 3, 4])
def test_mesh_table_matches_single_table_through_growth(n_shards):
    """test_torch_sketch.py's rows (k = 23 keys: all but the top one in
    shard 0's range) on both tables, with appends past the row capacity
    and row rewrites, as the greedy loop makes them: subsets of rows."""
    sk = _sketches(2, 3, 200)
    mesh_t = MeshSketchTable(sk, 23, _cpu_mesh(n_shards))
    single = DeviceSketchTable(sk, device="cpu")
    cur = list(sk)
    rng = np.random.default_rng(3)
    for step in range(6):  # the row capacity doubles from 3 to 12
        parent = cur[int(rng.integers(0, len(cur)))]
        new = parent[rng.random(parent.size) < 0.6]
        assert mesh_t.append_row(new) == single.append_row(new) == len(cur)
        cur.append(new)
        j = int(rng.integers(0, len(cur)))
        cur[j] = cur[j][rng.random(cur[j].size) < 0.5] if step % 2 else np.empty(0, np.int64)
        mesh_t.set_row(j, cur[j])
        single.set_row(j, cur[j])
        pairs = _all_pairs(len(cur))
        want = _host(cur, pairs)
        np.testing.assert_array_equal(mesh_t.pair_weights(pairs), want)
        np.testing.assert_array_equal(single.pair_weights(pairs), want)
    assert mesh_t.n == single.n == len(cur) == 9
    assert all(sk_.shape[0] == 12 for sk_ in mesh_t._sk)
    assert mesh_t.pair_weights([]).shape == (0,)


def test_mesh_table_bad_rows_raise():
    k = 15
    sk = [np.arange(0, 1 << 30, 1 << 24, dtype=np.int64), np.arange(5, dtype=np.int64)]
    t = MeshSketchTable(sk, k, _cpu_mesh(4))
    assert t.widths == [16, 16, 16, 16]
    wide = np.arange(17, dtype=np.int64)  # 17 keys in shard 0's range
    with pytest.raises(ValueError, match="capacity"):
        t.set_row(0, wide)
    with pytest.raises(ValueError, match="capacity"):
        t.append_row(wide)
    assert t.n == 2
    with pytest.raises(IndexError):
        t.set_row(2, sk[1])
    with pytest.raises(IndexError):
        t.pair_weights([(0, 2)])
    empty = MeshSketchTable([], k, _cpu_mesh(3))
    assert empty.widths == [1, 1, 1]
    assert empty.append_row(np.array([7], np.int64)) == 0
    assert empty.pair_weights([(0, 0)]).tolist() == [1]


def test_mesh_table_batches_share_the_device_budget(monkeypatch, caplog):
    """Four shards on one device share its memory budget: a budget of 7
    pairs at the sum of their widths is 7 pairs a batch, not 7 per
    shard; every batch is one call of sharded_sketch_weights inside one
    mesh step."""
    sk = _sketches(5, 12, 400)
    pairs = _all_pairs(12)
    t = MeshSketchTable(sk, 23, _cpu_mesh(4))
    want = t.pair_weights(pairs)
    np.testing.assert_array_equal(want, _host(sk, pairs))
    per_pair = sketch._BYTES_PER_PAIR_SLOT * sum(t.widths)
    monkeypatch.setattr(backend, "memory_budget", lambda device: 7 * per_pair + 5)
    assert t.batch_pairs() == 7
    calls = []
    orig = mesh_mod.sharded_sketch_weights
    monkeypatch.setattr(mesh_mod, "sharded_sketch_weights",
                        lambda m, b, p: calls.append(p.shape[0]) or orig(m, b, p))
    caplog.set_level(logging.DEBUG, logger="kmerset")
    logging.getLogger("kmerset").propagate = True
    np.testing.assert_array_equal(t.pair_weights(pairs), want)
    assert calls == [7] * (len(pairs) // 7) + [len(pairs) % 7]
    steps = [r.getMessage() for r in caplog.records if "sketch weights" in r.getMessage()]
    assert len(steps) == 1 and steps[0].startswith("mesh: sketch weights on 4 shards")


# -- the compressor and the Reader on a mesh ---------------------------------


def _oracle_lines(caplog):
    return [r.getMessage() for r in caplog.records if "sketch table on" in r.getMessage()]


@pytest.mark.parametrize("k", [15, 23])
def test_compress_on_mesh_matches_reference_mesh_and_single_device(
        k, tmp_path, monkeypatch, caplog):
    """At k = 15 the reference runs on its mesh of 4 devices (a compile
    for each shape: half a minute); at k = 23 on its host path."""
    arrays = _strains(k, 4, 70 + k, 1500)
    cfg = get_config(k)
    caplog.set_level(logging.DEBUG, logger="kmerset")
    logging.getLogger("kmerset").propagate = True
    port = KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=1,
                      workers=3, device="cpu", mesh=_cpu_mesh(4))
    assert _oracle_lines(caplog)[-1].startswith(
        "kmer_set_set: sketch table on mesh of 4 shards (cpu) ")
    single = KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=1, device="cpu")
    assert _oracle_lines(caplog)[-1].startswith("kmer_set_set: sketch table on cpu ")
    ref_compacts = _ref_compacts(k, arrays)
    if k == 15:
        monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "mesh")
        monkeypatch.setenv("KMERSET_TPU_MESH_DEVICES", "4")
    ref = RefSet(ref_compacts, True, cfg, seed=1)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    assert port.children_ == single.children_ == ref.children_
    assert len(port.children_) > 0
    assert port.size() == single.size() == ref.size() > len(arrays)
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(port.get(i, True).kmers, a)
        np.testing.assert_array_equal(single.get(i, True).kmers, a)
    for i in range(port.size()):
        np.testing.assert_array_equal(port.get(i, True).kmers, ref.get(i, True).kmers)
    assert all(c.mesh is port.mesh for c in port.kmer_sets_compact_[len(arrays):])
    for tag, s in (("port", port), ("single", single), ("ref", ref)):
        s.dump(str(tmp_path / tag), "", "txt")
        s.dump_graph(str(tmp_path / f"{tag}.dot"))
    for tag in ("port", "single"):
        _same_dirs(str(tmp_path / tag), str(tmp_path / "ref"))
        assert filecmp.cmp(str(tmp_path / f"{tag}.dot"), str(tmp_path / "ref.dot"),
                           shallow=False)


def test_reader_and_load_decode_on_the_mesh(tmp_path, monkeypatch):
    k = 19
    arrays = _strains(k, 4, 81, 6000)
    cfg = get_config(k)
    d = str(tmp_path / "d")
    KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=2, device="cpu").dump(d, "", "txt")
    decodes = []
    orig = driver.mesh_count
    monkeypatch.setattr(driver, "mesh_count", lambda *a, **kw: decodes.append(
        a[4].size) or orig(*a, **kw))
    mesh = _cpu_mesh(3)
    reader = KmerSetSetReader.from_directory(cfg, d, "txt", "", True, device="cpu",
                                             mesh=mesh)
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(reader.get(i, workers=2).kmers, a)
    n_get = len(decodes)
    assert n_get > 0 and set(decodes) == {3}
    got = dict(reader.get_all(workers=2))
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(got[i].kmers, a)
    assert len(decodes) == n_get + reader.size()  # each file decoded once
    loaded = KmerSetSet.load(cfg, d, "", "txt", True, workers=2, device="cpu",
                             mesh=mesh)
    assert loaded.mesh is mesh
    assert all(c.mesh is mesh for c in loaded.kmer_sets_compact_)
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(loaded.get(i, True).kmers, a)
    assert len(decodes) == n_get + 2 * reader.size()


def test_sketch_weight_error_reaches_the_caller(monkeypatch):
    """An error in the mesh's sketch weights raises out of KmerSetSet: no
    single-device or host oracle stands in."""
    k = 15
    arrays = _strains(k, 3, 91, 3000)

    def boom(*args):
        raise RuntimeError("injected sketch-weight failure")

    monkeypatch.setattr(mesh_mod, "sharded_sketch_weights", boom)
    with pytest.raises(RuntimeError, match="injected"):
        KmerSetSet(_port_compacts(k, arrays), True, get_config(k), seed=1,
                   device="cpu", mesh=_cpu_mesh(4))


def test_automatic_mesh_takes_the_oracle_above_its_gate(monkeypatch, caplog):
    """An automatic mesh (forced=False) takes the sketch table only where
    should_use_mesh takes the reference's work estimate
    (n_inputs * total // 2); below it the single device's table runs."""
    k = 15
    arrays = _strains(k, 3, 95, 3000)
    cfg = get_config(k)
    caplog.set_level(logging.DEBUG, logger="kmerset")
    logging.getLogger("kmerset").propagate = True
    seen = []
    orig = driver.should_use_mesh
    auto = Mesh(["cpu"] * 2, forced=False)
    monkeypatch.setattr(driver, "should_use_mesh", lambda m, n: (
        seen.append(n) if m is auto else None) or orig(m, n))
    small = KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=1, device="cpu",
                       mesh=auto)
    assert _oracle_lines(caplog)[-1].startswith("kmer_set_set: sketch table on cpu ")
    assert 0 < seen[0] < driver.MIN_MESH_WINDOWS
    monkeypatch.setattr(driver, "MIN_MESH_WINDOWS", seen[0])
    big = KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=1, device="cpu",
                     mesh=auto)
    assert "on mesh of 2 shards (cpu)" in _oracle_lines(caplog)[-1]
    assert small.children_ == big.children_
