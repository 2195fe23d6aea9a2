"""The port's library surface (the API that docs/API.md maps the original
project's types onto) against the reference's, on the same seeded numpy
inputs; exact, since every output is an integer, a string or a file.

Covers the codec (core/kmer.py), sorted_unique_counts, the native
window_pack, count_hash and intersect_size bindings, the PackedStrings
helpers, KmerSet's queries and algebra with intersection_size,
KmerCounter's adds and extract_kmers, DisjointSet, Range, utils/io.py,
get_flag_message, the test-data generators, ops/join.intersection_count
and the unpacked-code count entries of ops/count.py (count_kmers,
count_to_set, canonical_windows, window_validity), which run the plain
versions of kernels B1/B2 and B3 here, held against the reference's
jitted functions on XLA's CPU backend (no Pallas there).  The cases
mirror the reference's own tests/test_kmer.py, test_kmer_set.py,
test_kmer_counter.py, test_range_disjoint.py and the library parts of
test_coverage_gaps.py, as parity cases.

Comparisons that reach the native library run with libkmerio as the
environment has it and with both packages' loaders forced to report no
library (their numpy branches), and once with the port's serial edition.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from kmerset_tpu.core import io as ref_io
from kmerset_tpu.core import kmer as ref_kmer
from kmerset_tpu.core import native as ref_native
from kmerset_tpu.core.arrays import sorted_unique_counts as ref_sorted_unique_counts
from kmerset_tpu.core.disjoint_set import DisjointSet as RefDisjointSet
from kmerset_tpu.core.disjoint_set import connected_components as ref_components
from kmerset_tpu.core.kmer_counter import KmerCounter as RefCounter
from kmerset_tpu.core.kmer_counter import extract_kmers as ref_extract_kmers
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu.core.kmer_set import _isin_sorted as ref_isin_sorted
from kmerset_tpu.core.kmer_set import intersection_size as ref_intersection_size
from kmerset_tpu.core.kmer_set_compact import KmerSetCompact as RefCompact
from kmerset_tpu.core.strings import PackedStrings as RefStrings
from kmerset_tpu.core.strings import complement_codes as ref_complement_codes
from kmerset_tpu.ops import count as R
from kmerset_tpu.ops.join import intersection_count as ref_intersection_count
from kmerset_tpu.utils import flags as ref_flags
from kmerset_tpu.utils import io as ref_uio
from kmerset_tpu.utils import random as ref_random
from kmerset_tpu.utils.range import Range as RefRange
from kmerset_tpu_torch.core import io as core_io
from kmerset_tpu_torch.core import kmer, native
from kmerset_tpu_torch.core.arrays import sorted_unique_counts
from kmerset_tpu_torch.core.disjoint_set import DisjointSet, connected_components
from kmerset_tpu_torch.core.kmer_counter import KmerCounter, extract_kmers
from kmerset_tpu_torch.core.kmer_set import KmerSet, _isin_sorted, intersection_size
from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact
from kmerset_tpu_torch.core.strings import PackedStrings, complement_codes
from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.ops import count as P
from kmerset_tpu_torch.ops.join import intersection_count
from kmerset_tpu_torch.utils import flags
from kmerset_tpu_torch.utils import io as uio
from kmerset_tpu_torch.utils import random as urandom
from kmerset_tpu_torch.utils.range import Range

KS = [9, 15, 19, 23, 31]


@pytest.fixture(autouse=True)
def _host_reference(monkeypatch):
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


@pytest.fixture(params=["libkmerio", "numpy"])
def lib_mode(request, monkeypatch):
    """The environment's native library, or none on either side."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    return request.param


def _eq(got, want) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- the codec (reference tests/test_kmer.py) --------------------------------


def test_string_round_trip_and_complement():
    s = "AGCTG"
    assert kmer.string_to_kmer(s) == ref_kmer.string_to_kmer(s)
    assert kmer.kmer_to_string(kmer.string_to_kmer(s), 5) == s
    x = kmer.string_to_kmer("AACCG")
    rc = int(kmer.reverse_complement(np.int64(x), 5))
    assert kmer.kmer_to_string(rc, 5) == "CGGTT"
    assert int(kmer.canonical(np.int64(x), 5)) == min(x, rc)
    with pytest.raises(ValueError):
        kmer.string_to_kmer("ACGN")


def test_next_prev_and_first_last_code():
    x = kmer.string_to_kmer("AGCTG")
    t = kmer.string_to_codes("T")[0]
    assert kmer.kmer_to_string(int(kmer.next_kmer(np.int64(x), 5, t)), 5) == "GCTGT"
    assert kmer.kmer_to_string(int(kmer.prev_kmer(np.int64(x), 5, t)), 5) == "TAGCT"
    y = np.array([kmer.string_to_kmer("ACGTT")])
    assert kmer.last_code(y)[0] == ref_kmer.last_code(y)[0] == 3
    assert kmer.first_code(y, 5)[0] == ref_kmer.first_code(y, 5)[0] == 0


def test_windows():
    codes = kmer.string_to_codes("ACGTAC")
    got = [kmer.kmer_to_string(int(x), 3) for x in kmer.kmers_from_codes(codes, 3)]
    assert got == ["ACG", "CGT", "GTA", "TAC"]
    _eq(kmer.kmers_from_codes(codes[:2], 3), ref_kmer.kmers_from_codes(codes[:2], 3))


@pytest.mark.parametrize("k", [3, 9, 15, 19, 23, 31])
def test_codec_functions_match_reference(k):
    rng = np.random.default_rng(k)
    kmers = rng.integers(0, 1 << (2 * k), size=1000, dtype=np.int64)
    _eq(kmer.last_code(kmers), ref_kmer.last_code(kmers))
    _eq(kmer.first_code(kmers, k), ref_kmer.first_code(kmers, k))
    key_bits = 2 * k - min(10, 2 * k - 2)
    for got, want in zip(kmer.bucket_and_key(kmers, key_bits),
                         ref_kmer.bucket_and_key(kmers, key_bits)):
        _eq(got, want)
    b, key = kmer.bucket_and_key(kmers, key_bits)
    _eq(kmer.kmer_from_bucket_and_key(b, key, key_bits), kmers)
    codes = rng.integers(0, 4, size=2000).astype(np.uint8)
    _eq(kmer.kmers_from_codes(codes, k), ref_kmer.kmers_from_codes(codes, k))
    text = kmer.codes_to_string(codes)
    assert text == ref_kmer.codes_to_string(codes)
    _eq(kmer.string_to_codes(text), ref_kmer.string_to_codes(text))
    _eq(kmer.string_to_codes(text.encode()), codes)
    for x in kmers[:20]:
        s = kmer.kmer_to_string(int(x), k)
        assert s == ref_kmer.kmer_to_string(int(x), k)
        assert kmer.string_to_kmer(s) == ref_kmer.string_to_kmer(s) == int(x)
        rc = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        assert kmer.kmer_to_string(int(kmer.reverse_complement(np.int64(x), k)), k) == rc


@pytest.mark.parametrize("k", [15, 31])
def test_kmers_from_codes_native_threshold(k, lib_mode):
    """From _NATIVE_MIN windows on the native rolling pack runs (where a
    library loads), below it the numpy loop; both equal the reference's."""
    codes = np.random.default_rng(k).integers(0, 4, kmer._NATIVE_MIN + k + 5)
    codes = codes.astype(np.uint8)
    assert kmer._NATIVE_MIN == ref_kmer._NATIVE_MIN
    for n in (kmer._NATIVE_MIN + k - 2, codes.size):
        _eq(kmer.kmers_from_codes(codes[:n], k), ref_kmer.kmers_from_codes(codes[:n], k))


@pytest.mark.parametrize("n", [0, 1, 7, 5000])
def test_sorted_unique_counts_matches_reference(n):
    x = np.random.default_rng(n).integers(0, 300, n).astype(np.int64)
    for got, want in zip(sorted_unique_counts(x), ref_sorted_unique_counts(x)):
        _eq(got, want)
    u, c = sorted_unique_counts(x)
    eu, ec = np.unique(x, return_counts=True)
    _eq(u, eu)
    _eq(c, ec)


# -- the native bindings ------------------------------------------------------


def _check_bindings() -> None:
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 5000, dtype=np.uint8)
    for k in (9, 15, 23, 31):
        got, want = native.window_pack(codes, k), ref_native.window_pack(codes, k)
        assert (got is None) == (want is None)
        if got is not None:
            _eq(got, want)
            _eq(got, ref_kmer.kmers_from_codes(codes.astype(np.int64), k))
        assert native.count_hash(codes, k) == ref_native.count_hash(codes, k)
    if native.get_lib() is not None:
        want = np.unique(ref_kmer.canonical(ref_kmer.kmers_from_codes(codes, 15), 15))
        assert native.count_hash(codes, 15) == want.size
    assert native.count_hash(np.zeros(100, np.uint8), 25) is None
    a = np.unique(rng.integers(0, 1 << 20, 3000))
    b = np.unique(rng.integers(0, 1 << 20, 3000))
    got, want = native.intersect_size(a, b), ref_native.intersect_size(a, b)
    assert got == want
    if got is not None:
        assert got == np.intersect1d(a, b).size


def test_native_bindings_match_reference(lib_mode):
    _check_bindings()


def test_native_bindings_on_the_serial_edition(tmp_path, monkeypatch):
    """window_pack, count_hash and intersect_size on the port's serial
    build of native/kmerio.c (no OpenMP), against the reference on the
    checkout's library."""
    from kmerset_tpu_torch import _nativebuild

    if ref_native.get_lib() is None:
        pytest.skip("no C compiler or library: the numpy case covers it")
    monkeypatch.delenv("KMERSET_TPU_NO_AUTOBUILD", raising=False)
    monkeypatch.setattr(_nativebuild, "ensure_built", lambda target, sources: None)
    monkeypatch.setattr(_nativebuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_nativebuild, "_SERIAL", {})
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_EDITION", None)
    monkeypatch.setattr(native, "_find_lib", lambda: None)
    assert native.edition().serial
    _check_bindings()


# -- PackedStrings (reference core/strings.py) ---------------------------------


@pytest.mark.parametrize("canonical", [True, False])
def test_packed_strings_surface_matches_reference(canonical, lib_mode):
    rng = np.random.default_rng(7)
    strings = ["".join("ACGT"[c] for c in rng.integers(0, 4, n))
               for n in (40, 9, 0, 3, 120)]
    port, ref = PackedStrings.from_strings(strings), RefStrings.from_strings(strings)
    _eq(port.codes, ref.codes)
    _eq(port.offsets, ref.offsets)
    assert port.n == ref.n == len(port) == 5
    for i in range(port.n):
        _eq(port.get_codes(i), ref.get_codes(i))
    assert port.to_strings() == ref.to_strings() == strings
    for k in (3, 9, 15):
        _eq(port.all_kmers(k, canonical), ref.all_kmers(k, canonical))
    _eq(complement_codes(port.codes), ref_complement_codes(ref.codes))
    _eq(complement_codes(np.array([0, 1, 2, 3], np.uint8)), [0, 1, 2, 3])
    with pytest.raises(ValueError):
        PackedStrings.from_strings(["ACGT", "ACNT"])
    empty = PackedStrings.from_strings([])
    assert empty.n == 0 and empty.to_strings() == []


# -- KmerSet (reference tests/test_kmer_set.py, test_coverage_gaps.py) -------


def _sets_from_strings(strings):
    k = len(strings[0])
    kmers = np.array([kmer.string_to_kmer(s) for s in strings])
    return KmerSet(k, kmers), RefKmerSet(k, kmers)


def test_kmer_set_basic_matches_reference():
    s, r = _sets_from_strings(["AAA", "ACG", "TTT"])
    assert s.size() == r.size() == len(s) == 3
    for q in ("ACG", "GGG"):
        x = kmer.string_to_kmer(q)
        assert s.contains_one(x) == r.contains_one(x)
    g, a = kmer.string_to_kmer("GGG"), kmer.string_to_kmer("AAA")
    s2, r2 = s.add_kmers(np.array([g])), r.add_kmers(np.array([g]))
    _eq(s2.kmers, r2.kmers)
    s3, r3 = s2.remove_kmers(np.array([a])), r2.remove_kmers(np.array([a]))
    _eq(s3.kmers, r3.kmers)
    assert s3.size() == 3 and not s3.contains_one(a)


def test_kmer_set_algebra_cases_match_reference():
    a, ra = _sets_from_strings(["AAA", "ACG", "TTT"])
    b, rb = _sets_from_strings(["ACG", "GGG"])
    for op in ("union", "subtract", "intersection"):
        _eq(getattr(a, op)(b).kmers, getattr(ra, op)(rb).kmers)
    assert (a.union(b).size(), a.subtract(b).size(), a.intersection(b).size()) == (4, 2, 1)
    assert a.diff_count(b) == ra.diff_count(rb) == 3
    assert a.equals(a) and not a.equals(b)


def test_kmer_set_find_from_kmers_and_hash():
    rng = np.random.default_rng(0)
    s = KmerSet(9, np.unique(rng.integers(0, 1 << 18, size=500)))
    r = RefKmerSet(9, s.kmers)
    allk = s.find()
    _eq(allk, r.find())
    allk[0] = -1  # find returns a copy, not a view
    assert s.kmers[0] != -1
    _eq(s.find(lambda x: x % 2 == 0), r.find(lambda x: x % 2 == 0))
    assert "KmerSet" in repr(s)
    f = KmerSet.from_kmers(7, np.array([5, 3, 5, 1], dtype=np.int64))
    _eq(f.kmers, RefKmerSet.from_kmers(7, np.array([5, 3, 5, 1])).kmers)
    assert KmerSet(9, s.kmers[::-1].copy()).hash() == s.hash() == r.hash()
    empty = KmerSet(9)
    _eq(empty.contains(np.array([1, 2])), [False, False])
    assert empty.find().size == 0 and empty.hash() == 0


@pytest.mark.parametrize("k", [9, 15, 31])
def test_kmer_set_algebra_matches_reference(k, lib_mode):
    rng = np.random.default_rng(k)
    pool = np.unique(rng.integers(0, 1 << (2 * k), 6000))
    A = pool[rng.random(pool.size) < 0.6]
    B = pool[rng.random(pool.size) < 0.5]
    a, b, ra, rb = KmerSet(k, A), KmerSet(k, B), RefKmerSet(k, A), RefKmerSet(k, B)
    q = rng.choice(pool, 500)
    _eq(a.contains(q), ra.contains(q))
    assert [a.contains_one(int(x)) for x in q[:20]] == [ra.contains_one(int(x)) for x in q[:20]]
    _eq(a.add_kmers(q).kmers, ra.add_kmers(q).kmers)
    _eq(a.remove_kmers(q).kmers, ra.remove_kmers(q).kmers)
    for op in ("union", "subtract", "intersection"):
        _eq(getattr(a, op)(b).kmers, getattr(ra, op)(rb).kmers)
        _eq(getattr(b, op)(a).kmers, getattr(rb, op)(ra).kmers)
    assert a.diff_count(b) == ra.diff_count(rb)
    assert a.equals(KmerSet(k, A)) and not a.equals(b)
    assert a.hash() == ra.hash() and b.hash() == rb.hash()
    _eq(_isin_sorted(A, B), ref_isin_sorted(A, B))
    _eq(_isin_sorted(A, B[:0]), ref_isin_sorted(A, B[:0]))


@pytest.mark.parametrize("shape", ["merge", "search", "empty"])
def test_intersection_size_branches_match_reference(shape, lib_mode, monkeypatch):
    """The native merge where the sizes are within 32x of each other (and
    a library loads), the binary search beyond; both the reference's."""
    rng = np.random.default_rng(11)
    big = np.unique(rng.integers(0, 1 << 24, 40000))
    small = {"merge": 4000, "search": 100, "empty": 0}[shape]
    a = np.sort(rng.choice(big, small, replace=False)) if small else big[:0]
    a = np.union1d(a, np.unique(rng.integers(0, 1 << 24, small // 4)))
    calls = []
    spy = native.intersect_size
    monkeypatch.setattr(native, "intersect_size",
                        lambda x, y: calls.append(1) or spy(x, y))
    for x, y in ((a, big), (big, a)):
        got = intersection_size(x, y)
        assert got == ref_intersection_size(x, y) == np.intersect1d(x, y).size
    assert bool(calls) == (shape == "merge")
    assert intersection_size(np.array([1, 3, 5, 7]), np.array([3, 4, 5, 9])) == 2


# -- KmerCounter (reference tests/test_kmer_counter.py) ------------------------


def _counters(k, reads, canonical, value_max=255):
    port = KmerCounter.from_reads(k, reads, canonical, value_max, device="cpu")
    ref = RefCounter.from_reads(k, reads, canonical, value_max)
    return port, ref


def _same_counter(port, ref) -> None:
    assert port.size() == ref.size()
    _eq(port.kmers, ref.kmers)
    _eq(port.counts, ref.counts)


@pytest.mark.parametrize("reads, canonical, probes", [
    (["AAAA"], False, {"AAA": 2}),
    (["AAANAAA"], False, {"AAA": 2}),
    (["AAANCGT"], False, {"AAA": 1, "CGT": 1, "ACG": 0}),
    (["ACG", "CGT"], True, {"ACG": 2}),
    (["AAAA", "CCC"], False, {"AAA": 2, "CCC": 1}),
])
def test_counter_cases_match_reference(reads, canonical, probes):
    port, ref = _counters(3, reads, canonical)
    _same_counter(port, ref)
    for s, n in probes.items():
        x = kmer.string_to_kmer(s)
        assert port.get(x) == ref.get(x) == n
    for cutoff in (1, 2):
        (ps, pn), (rs, rn) = port.to_kmer_set(cutoff), ref.to_kmer_set(cutoff)
        _eq(ps.kmers, rs.kmers)
        assert pn == rn


def test_counter_fasta_cases_match_reference(tmp_path):
    for lines in ([">a", "ACGT", ">b"], [">a", "ACGX"], ["ACGT", "ACGT"]):
        with pytest.raises(core_io.IOError_):
            KmerCounter.from_fasta_lines(3, lines, False, device="cpu")
    c = KmerCounter.from_fasta_lines(3, [">a", "ACGT", ">b", "GGGG"], False, device="cpu")
    assert c.size() == 3
    path = tmp_path / "x.fasta"
    path.write_text(">a\nACGTACGT\n>b\nTTTTT\n")
    port = KmerCounter.from_fasta(5, str(path), "", False, device="cpu")
    ref = RefCounter.from_fasta(5, str(path), "", False)
    _same_counter(port, ref)
    assert port.get(kmer.string_to_kmer("TTTTT")) == 1


def test_saturating_add_matches_reference():
    port, ref = KmerCounter(3, device="cpu"), RefCounter(3)
    x = kmer.string_to_kmer("ACG")
    assert port.add(x, 250) is port
    port.add(x, 250)
    ref.add(x, 250).add(x, 250)
    assert port.get(x) == ref.get(x) == 255
    assert port.size() == ref.size() == 1


@pytest.mark.parametrize("value_max", [4, 255])
def test_adds_after_a_device_count_match_reference(value_max):
    """Adds on top of a count (here the device count's plain versions on
    the CPU): a saturated count stays at value_max, sums saturate, new
    keys are merged in order, and a cutoff sees the flushed counts."""
    reads = ["ACGTACGTTT"] * 6 + ["GGGATTTACA", "CCCAN", "TTGACCA"]
    port, ref = _counters(5, reads, True, value_max)
    _same_counter(port, ref)
    sat = int(port.kmers[np.argmax(port.counts)])
    assert port.get(sat) == ref.get(sat) == min(12, value_max)
    rng = np.random.default_rng(value_max)
    adds = [(sat, value_max), (sat, 3)] + [
        (int(x), int(v)) for x, v in zip(rng.integers(0, 1 << 10, 60),
                                         rng.integers(1, 4, 60))]
    for x, v in adds:
        port.add(x, v)
        ref.add(x, v)
    assert port.get(sat) == ref.get(sat) == value_max
    _same_counter(port, ref)
    port.add(1, 2)
    ref.add(1, 2)
    for cutoff in (2, 3, 5):
        (ps, pn), (rs, rn) = port.to_kmer_set(cutoff), ref.to_kmer_set(cutoff)
        _eq(ps.kmers, rs.kmers)
        assert pn == rn


@pytest.mark.parametrize("k", [3, 15, 31])
@pytest.mark.parametrize("canonical", [True, False])
def test_extract_kmers_matches_reference(k, canonical):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 3000).astype(np.uint8)
    offsets = np.array([0, 700, 700, 705, 1900, 3000], dtype=np.int64)
    _eq(extract_kmers(codes, offsets, k, canonical),
        ref_extract_kmers(codes, offsets, k, canonical))
    _eq(extract_kmers(codes[:2], offsets[:1], k, canonical), np.empty(0, np.int64))


# -- DisjointSet and Range (reference tests/test_range_disjoint.py) ----------


@pytest.mark.parametrize("seed", range(4))
def test_disjoint_set_matches_reference(seed):
    rng = np.random.default_rng(seed)
    n = 200
    ds, ref = DisjointSet(n), RefDisjointSet(n)
    edges = rng.integers(0, n, size=(300, 2))
    for i, j in edges[:150]:
        ds.unite(int(i), int(j))
        ref.unite(int(i), int(j))
    ds.unite_edges(edges[150:, 0], edges[150:, 1])
    ref.unite_edges(edges[150:, 0], edges[150:, 1])
    _eq(ds.parent, ref.parent)
    _eq(ds.rank, ref.rank)
    for a in range(0, n, 7):
        assert ds.find(a) == ref.find(a)
        for b in range(0, n, 11):
            assert ds.is_same(a, b) == ref.is_same(a, b)
    _eq(ds.roots(), ref.roots())


@pytest.mark.parametrize("seed", range(3))
def test_connected_components_match_reference(seed):
    rng = np.random.default_rng(10 + seed)
    n = 300
    a = rng.integers(0, n, size=250).astype(np.int64)
    b = rng.integers(0, n, size=250).astype(np.int64)
    labels = connected_components(n, a, b)
    _eq(labels, ref_components(n, a, b))
    for x in range(n):
        assert labels[x] == np.flatnonzero(labels == labels[x]).min()


def test_range_matches_reference():
    for begin in range(0, 30, 7):
        for end in range(begin, begin + 40, 9):
            for n in range(1, 12):
                got = [(p.begin, p.end) for p in Range(begin, end).split(n)]
                assert got == [(p.begin, p.end) for p in RefRange(begin, end).split(n)]
                assert got[0][0] == begin and got[-1][1] == end
    assert list(Range(2, 5)) == list(RefRange(2, 5)) == [2, 3, 4]
    assert len(Range(2, 5)) == 3 and Range(1, 4) == Range(1, 4)
    with pytest.raises(ValueError):
        Range(5, 3)


# -- utils/io.py, utils/flags.py ---------------------------------------------


@pytest.mark.parametrize("canonical", [True, False])
def test_get_kmer_set_from_file_matches_reference(tmp_path, canonical):
    rng = np.random.default_rng(1)
    s = ref_random.get_random_kmer_set(9, 300, canonical, rng)
    path = str(tmp_path / "x.txt")
    RefCompact.from_kmer_set(s, canonical).dump(path)
    got = uio.get_kmer_set_from_file(9, path, "", canonical, device="cpu")
    want = ref_uio.get_kmer_set_from_file(9, path, "", canonical)
    _eq(got.kmers, want.kmers)
    assert got.hash() == want.hash()
    _eq(got.kmers, s.kmers)


@pytest.mark.parametrize("mod", [uio, ref_uio], ids=["port", "reference"])
def test_temporaries(mod):
    with mod.TemporaryFile() as tf:
        name = tf.name()
        with open(name, "w") as f:
            f.write("hello")
        assert os.path.exists(name)
        assert os.path.dirname(name) == tempfile.gettempdir()
    assert not os.path.exists(name)
    with mod.TemporaryDirectory() as td:
        dname = td.name()
        open(os.path.join(dname, "f"), "w").close()
    assert not os.path.exists(dname)


def test_get_flag_message_matches_reference():
    for name in list(ref_flags.FLAG_MESSAGES) + ["no such flag"]:
        assert flags.get_flag_message(name) == ref_flags.get_flag_message(name)


# -- the generators (reference utils/random.py) --------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_random_draws_match_reference(seed):
    """The same seed gives the same draws, in the same order: each call
    below consumes the generator as the reference's does."""
    port, ref = np.random.default_rng(seed), np.random.default_rng(seed)
    for k in (5, 15, 31):
        assert urandom.get_random_kmer(k, port) == ref_random.get_random_kmer(k, ref)
        assert urandom.get_random_read(k, port) == ref_random.get_random_read(k, ref)
        _eq(urandom.get_random_kmers(k, 200, port), ref_random.get_random_kmers(k, 200, ref))
        _eq(urandom.get_random_kmers(2, 16, port), ref_random.get_random_kmers(2, 16, ref))
        for canonical in (True, False):
            got = urandom.get_random_kmer_set(k, 300, canonical, port)
            _eq(got.kmers, ref_random.get_random_kmer_set(k, 300, canonical, ref).kmers)
    _eq(urandom.get_random_ints(50, True, True, 10, 99, port),
        ref_random.get_random_ints(50, True, True, 10, 99, ref))


@pytest.mark.parametrize("canonical", [True, False])
def test_random_kmer_counter_matches_reference(canonical):
    port = urandom.get_random_kmer_counter(7, 400, canonical, np.random.default_rng(4),
                                           device="cpu")
    ref = ref_random.get_random_kmer_counter(7, 400, canonical, np.random.default_rng(4))
    assert port.device == torch.device("cpu")
    _same_counter(port, ref)
    _eq(port.to_kmer_set(1)[0].kmers, ref.to_kmer_set(1)[0].kmers)


def test_random_compact_sets_match_reference():
    port = urandom.get_random_kmer_sets_compact(3, 200, 9, True, np.random.default_rng(2),
                                                device="cpu")
    ref = ref_random.get_random_kmer_sets_compact(3, 200, 9, True, np.random.default_rng(2))
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert isinstance(p, KmerSetCompact) and p.device == torch.device("cpu")
        _eq(p.spss.codes, r.spss.codes)
        _eq(p.spss.offsets, r.spss.offsets)
        _eq(p.kmers(True), r.kmers(True))


@pytest.mark.parametrize("k, canonical", [(9, True), (15, True), (11, False)])
def test_random_kmer_set_set_dump_matches_reference(tmp_path, k, canonical):
    port = urandom.get_random_kmer_set_set(4, 300, k, canonical, np.random.default_rng(k),
                                           device="cpu")
    ref = ref_random.get_random_kmer_set_set(4, 300, k, canonical, np.random.default_rng(k))
    assert port.size() == ref.size() >= 4
    port.dump(str(tmp_path / "port"), "", "txt")
    ref.dump(str(tmp_path / "ref"), "", "txt")
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes(), name


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks a machine without CUDA")
def test_generators_refuse_a_missing_cuda_device():
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="cuda"):
        urandom.get_random_kmer_counter(7, 10, True, rng, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        urandom.get_random_kmer_set_compact(7, 10, True, rng, device="cuda")


# -- ops/join.intersection_count ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("sizes", [(3000, 2500), (5000, 40), (0, 100), (1, 1)])
def test_intersection_count_matches_reference(dtype, sizes):
    rng = np.random.default_rng(sizes[0] + sizes[1])
    A = np.unique(rng.integers(0, 1 << 20, sizes[0]))
    B = np.unique(np.concatenate([rng.choice(A, min(A.size, sizes[1] // 2))
                                  if A.size else A[:0],
                                  rng.integers(0, 1 << 20, sizes[1] // 2 + 1)]))
    want = int(ref_intersection_count(A, B))
    got = intersection_count(torch.from_numpy(A).to(dtype), torch.from_numpy(B).to(dtype))
    assert got.dim() == 0 and got.dtype == torch.int64
    assert int(got) == want == ref_intersection_size(A, B)
    assert int(intersection_count(torch.from_numpy(B), torch.from_numpy(A))) == want


# -- the unpacked-code count entries (reference ops/count.py) ------------------


def _code_input(k: int):
    """(codes uint8, valid bool) of ~3 kb: random codes with N runs coded
    as 4 (some readers do), fragment boundaries with empty and short
    fragments, and a repeated stretch whose counts pass every cutoff."""
    rng = np.random.default_rng(100 + k)
    codes = rng.integers(0, 4, 3200).astype(np.uint8)
    for j in range(12):  # one stretch 12 times: counts above cutoff 9
        codes[1800 + 100 * j : 1860 + 100 * j] = codes[1000:1060]
    for start, n in ((300, 1), (900, 7), (1500, 40)):
        codes[start : start + n] = 4
    offsets = np.array([0, 100, 100, 100 + k // 2, 2500, 2500, 3200], np.int64)
    valid = R.window_validity(offsets, codes.size, k)
    is_n = np.concatenate([[0], np.cumsum(codes == 4)])
    n_in = is_n[np.minimum(np.arange(codes.size) + k, codes.size)] - is_n[:-1]
    return codes, valid & (n_in == 0)


@pytest.mark.parametrize("k", KS)
def test_window_validity_matches_reference(k):
    offsets = np.array([0, 0, 100, 100, 100 + k // 2, 2500, 3200], np.int64)
    for total in (3200, 0, k - 1):
        off = np.minimum(offsets, total)
        _eq(P.window_validity(off, total, k), R.window_validity(off, total, k))
    _eq(P.window_validity(offsets, 3200, 1), R.window_validity(offsets, 3200, 1))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [True, False])
def test_count_kmers_matches_reference(k, canonical):
    codes, valid = _code_input(k)
    uniq, counts, n_unique = R.count_kmers(codes, valid, k, canonical)
    n = int(n_unique)
    keys, got_counts, got_n = P.count_kmers(
        torch.from_numpy(codes), torch.from_numpy(valid), k, canonical)
    assert got_n == n and keys.dtype == torch.int64
    _eq(keys.numpy(), np.asarray(uniq)[:n])
    _eq(got_counts.numpy(), np.asarray(counts)[:n])
    # int32 codes, as the reference also takes them.
    keys32, _, _ = P.count_kmers(torch.from_numpy(codes.astype(np.int32)),
                                 torch.from_numpy(valid), k, canonical)
    _eq(keys32.numpy(), keys.numpy())


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("cutoff", [1, 2, 3, 9])
def test_count_to_set_matches_reference(k, canonical, cutoff):
    codes, valid = _code_input(k)
    uniq, n_kept, n_cut = R.count_to_set(codes, valid, k, canonical, cutoff)
    m = int(n_kept)
    keys, got_m, got_cut = P.count_to_set(
        torch.from_numpy(codes), torch.from_numpy(valid), k, canonical, cutoff)
    assert (got_m, got_cut) == (m, int(n_cut)) and keys.dtype == torch.int64
    _eq(keys.numpy(), np.asarray(uniq)[:m])
    if cutoff == 9:
        assert m > 0  # the repeated stretch passes the run-length branch


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("canonical", [True, False])
def test_canonical_windows_matches_reference(k, canonical):
    codes = np.random.default_rng(k).integers(0, 4, 2000).astype(np.uint8)
    want = np.asarray(R.canonical_windows(codes, k, canonical))[: codes.size - k + 1]
    got = P.canonical_windows(torch.from_numpy(codes), k, canonical)
    assert got.dtype == torch.int64
    _eq(got.numpy(), want)
    assert P.canonical_windows(torch.from_numpy(codes[: k - 1]), k, canonical).numel() == 0


@pytest.mark.parametrize("k", [15, 23])
def test_count_entries_equal_the_staged_count(k):
    """count_kmers on window_validity's mask of a fragment stream equals
    backend.device_count of the same stream (the *_frag path), keys
    widened to int64."""
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 4000).astype(np.uint8)
    offsets = np.array([0, 1000, 1000, 1010, 4000], np.int64)
    valid = P.window_validity(offsets, codes.size, k)
    keys, counts, n = P.count_kmers(torch.from_numpy(codes), torch.from_numpy(valid),
                                    k, True)
    want_keys, want_counts = backend.device_count(codes, offsets, k, True, device="cpu")
    _eq(keys.numpy(), want_keys)
    _eq(counts.numpy(), want_counts)
    got, m, _ = P.count_to_set(torch.from_numpy(codes), torch.from_numpy(valid), k, True, 1)
    _eq(got.numpy(), backend.device_unique(codes, offsets, k, True, device="cpu"))


def test_count_entries_stage_inputs_as_the_kernels_take_them():
    """The validity slice is copied where it is not 16-byte aligned (B1/B2
    read it with 16-byte copies), codes above 3 are masked before the
    2-bit pack, and inputs that hold no window give empty results."""
    k = 15
    codes, valid = _code_input(k)
    big = torch.zeros(valid.size + 1, dtype=torch.bool)
    big[1:] = torch.from_numpy(valid)
    view = big[1:]
    assert view.data_ptr() % 16
    packed, v, L = P._stage_codes(torch.from_numpy(codes), view, k)
    assert v.data_ptr() % 16 == 0 and v.is_contiguous() and L == codes.size
    _eq(v.numpy(), valid[: codes.size - k + 1])
    fresh = torch.from_numpy(valid)
    assert P._stage_codes(torch.from_numpy(codes), fresh, k)[1].data_ptr() == fresh.data_ptr()
    _eq(packed.numpy(), native.pack2(codes & 3) if native.get_lib() else
        ref_native.pack2(codes & 3))
    for got, want in zip(P.count_kmers(torch.from_numpy(codes), view, k, True),
                         P.count_kmers(torch.from_numpy(codes), fresh, k, True)):
        _eq(np.asarray(got), np.asarray(want))
    keys, counts, n = P.count_kmers(torch.zeros(k - 1, dtype=torch.uint8),
                                    torch.ones(k - 1, dtype=torch.bool), k, True)
    assert n == 0 and keys.dtype == torch.int64 and counts.numel() == 0
    assert P.count_to_set(torch.zeros(3, dtype=torch.uint8),
                          torch.ones(3, dtype=torch.bool), k, True, 2)[1:] == (0, 0)
    with pytest.raises(TypeError):
        P.count_kmers(codes, valid, k, True)
    with pytest.raises(ValueError):
        P.count_kmers(torch.from_numpy(codes), torch.from_numpy(valid[:-1]), k, True)
    with pytest.raises(ValueError):
        P.count_kmers(torch.from_numpy(codes), torch.from_numpy(valid), 32, True)
