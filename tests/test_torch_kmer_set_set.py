"""The port's multi-set compressor (kmerset_tpu_torch/core/kmer_set_set.py,
core/kmer_set_compact.py) against the reference's, on the CPU.

The reference runs pinned to its host path (KMERSET_TPU_FORCE_BACKEND=
host); the port runs with device="cpu" (its kernels' plain versions and
the plain sketch table).  Same inputs and seed must give the same child
DAG, the same strings for every set and byte-identical directories, and
each side's Reader must read the other's directory.
"""

import filecmp
import os
import sys
import threading

import numpy as np
import pytest

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core.config import get_config
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu.core.kmer_set_compact import KmerSetCompact as RefCompact
from kmerset_tpu.core.kmer_set_set import KmerSetSet as RefSet
from kmerset_tpu.core.kmer_set_set import KmerSetSetReader as RefReader
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact
from kmerset_tpu_torch.core.kmer_set_set import KmerSetSet, KmerSetSetReader
from kmerset_tpu_torch.core.strings import PackedStrings
from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.ops import count as count_ops


@pytest.fixture(autouse=True)
def _host_reference(monkeypatch):
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


def _strains(k: int, n_sets: int, seed: int, n_bases: int = 12000):
    """Sorted canonical k-mer arrays of n_sets point-mutated strains of
    one random genome (bench.py's multi-set generator, smaller)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, n_bases).astype(np.int64)
    out = []
    for _ in range(n_sets):
        mut = base.copy()
        pos = rng.integers(0, n_bases, n_bases // 250)
        mut[pos] = rng.integers(0, 4, pos.shape[0])
        out.append(np.unique(kc.canonical(kc.kmers_from_codes(mut, k), k)))
    return out


def _port_compacts(k, arrays):
    return [KmerSetCompact.from_kmer_set(KmerSet(k, a, _sorted=True), True,
                                         device="cpu") for a in arrays]


def _ref_compacts(k, arrays):
    return [RefCompact.from_kmer_set(RefKmerSet(k, a, _sorted=True), True)
            for a in arrays]


def _same_dirs(a: str, b: str) -> None:
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == errors == [] and len(match) == len(names)


@pytest.mark.parametrize("k", [9, 15, 23])
def test_compress_matches_reference(k):
    arrays = _strains(k, 5, k)
    cfg = get_config(k)
    ref = RefSet(_ref_compacts(k, arrays), True, cfg, seed=1)
    port = KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=1, device="cpu")
    assert port.children_ == ref.children_
    assert len(port.children_) > 0
    assert len(port.kmer_sets_compact_) == len(ref.kmer_sets_compact_)
    for p, r in zip(port.kmer_sets_compact_, ref.kmer_sets_compact_):
        assert type(p) is KmerSetCompact and p.device.type == "cpu"
        np.testing.assert_array_equal(p.spss.codes, r.spss.codes)
        np.testing.assert_array_equal(p.spss.offsets, r.spss.offsets)
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(port.get(i, True).kmers, a)


def test_workers_and_dump_byte_identical_to_reference(tmp_path):
    k = 15
    arrays = _strains(k, 6, 7)
    cfg = get_config(k)
    ref = RefSet(_ref_compacts(k, arrays), True, cfg, seed=3)
    ref.dump(str(tmp_path / "ref"), "", "txt")
    ref.dump_graph(str(tmp_path / "ref.dot"))
    for workers in (1, 4):
        port = KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=3,
                          workers=workers, device="cpu")
        out = str(tmp_path / f"port{workers}")
        port.dump(out, "", "txt", workers=workers)
        port.dump_graph(out + ".dot")
        _same_dirs(out, str(tmp_path / "ref"))
        assert filecmp.cmp(out + ".dot", str(tmp_path / "ref.dot"), shallow=False)


def test_readers_cross_directories(tmp_path):
    k = 19
    arrays = _strains(k, 4, 11)
    cfg = get_config(k)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RefSet(_ref_compacts(k, arrays), True, cfg, seed=2).dump(ref_dir, "", "txt")
    KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=2,
               device="cpu").dump(port_dir, "", "txt")
    port_reader = KmerSetSetReader.from_directory(
        cfg, ref_dir, "txt", "", True, device="cpu"
    )
    ref_reader = RefReader.from_directory(cfg, port_dir, "txt", "", True)
    # Size() counts the shared children as well as the originals.
    assert port_reader.size() == ref_reader.size() > len(arrays)
    assert port_reader.children_ == ref_reader.children_
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(port_reader.get(i, workers=2).kmers, a)
        np.testing.assert_array_equal(ref_reader.get(i).kmers, a)
    loaded = KmerSetSet.load(cfg, ref_dir, "", "txt", True, workers=2, device="cpu")
    assert all(type(s) is KmerSetCompact for s in loaded.kmer_sets_compact_)
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(loaded.get(i, True).kmers, a)


def test_get_all_equals_get_and_close_empties_cache(tmp_path):
    k = 15
    arrays = _strains(k, 5, 13)
    cfg = get_config(k)
    d = str(tmp_path / "d")
    KmerSetSet(_port_compacts(k, arrays), True, cfg, seed=4,
               device="cpu").dump(d, "", "txt")
    reader = KmerSetSetReader.from_directory(cfg, d, "txt", "", True, device="cpu")
    got = list(reader.get_all(workers=3))
    assert [i for i, _ in got] == list(range(reader.size()))
    for i, s in got:
        assert s.equals(reader.get(i))
    for i, a in enumerate(arrays):
        np.testing.assert_array_equal(got[i][1].kmers, a)
    gen = reader.get_all()
    next(gen)
    cache = gen.gi_frame.f_locals["cache"]
    assert cache  # the shared children set 0 needs are still held
    gen.close()
    assert cache == {}


def test_subset_input_empty_residual_roundtrip(tmp_path):
    k = 15
    cfg = get_config(k)
    big = _strains(k, 1, 55)[0]
    sub = big[: big.size // 2]
    port = KmerSetSet(_port_compacts(k, [big, sub]), True, cfg, seed=9,
                      device="cpu")
    ref = RefSet(_ref_compacts(k, [big, sub]), True, cfg, seed=9)
    assert any(c.size() == 0 for c in port.kmer_sets_compact_)
    assert port.children_ == ref.children_
    d, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    port.dump(d, "", "txt")
    ref.dump(rd, "", "txt")
    _same_dirs(d, rd)
    reader = KmerSetSetReader.from_directory(cfg, d, "txt", "", True, device="cpu")
    for i, got in reader.get_all():
        assert got.equals(reader.get(i))
    np.testing.assert_array_equal(reader.get(0).kmers, big)
    np.testing.assert_array_equal(reader.get(1).kmers, sub)


def test_lazy_compact_builds_on_its_device_and_refuses_reference_sets():
    k = 15
    a = _strains(k, 1, 21)[0]
    lazy = KmerSetCompact.from_kmer_set(KmerSet(k, a, _sorted=True), True,
                                        lazy=True, device="cpu")
    assert lazy._pending is not None and lazy.size() == a.size
    eager = RefCompact.from_kmer_set(RefKmerSet(k, a, _sorted=True), True)
    np.testing.assert_array_equal(lazy.spss.codes, eager.spss.codes)
    assert lazy._pending is None and lazy.weight() == eager.weight()
    lazy.pack_in_memory()
    np.testing.assert_array_equal(lazy.spss.offsets, eager.spss.offsets)
    # The setter drops the decode cache.
    lazy.spss = PackedStrings(eager.spss.codes, eager.spss.offsets)
    assert lazy._kmers_cache is None
    np.testing.assert_array_equal(lazy.kmers(True), a)
    with pytest.raises(TypeError, match="port's KmerSetCompact"):
        KmerSetSet([eager], True, get_config(k), device="cpu")


def test_device_lock_serializes_concurrent_decodes(monkeypatch):
    """Eight threads decode at once (as the Reader's and the deferred
    builds' pools do): the device sections never overlap and every
    result is right."""
    k = 15
    arrays = _strains(k, 8, 31, 3000)
    compacts = [KmerSetCompact(k, c.spss, device="cpu")
                for c in _port_compacts(k, arrays)]
    active, peak = [0], [0]
    guard = threading.Lock()
    orig = count_ops.count_to_set_frag

    def spy(*args):
        with guard:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
        try:
            return orig(*args)
        finally:
            with guard:
                active[0] -= 1

    monkeypatch.setattr(count_ops, "count_to_set_frag", spy)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    results = [None] * len(compacts)
    try:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, compacts[i].kmers(True))) for i in range(len(compacts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert peak[0] == 1
    for got, want in zip(results, arrays):
        np.testing.assert_array_equal(got, want)
    assert backend.device_lock("cpu") is backend.device_lock("cpu")
