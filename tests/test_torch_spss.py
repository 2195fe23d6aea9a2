"""The port's SPSS build and decode (core/spss.py) and KmerSetCompact
edition against the reference's host build and decode, on the CPU; exact.

The reference is pinned to its host arms (KMERSET_TPU_FORCE_BACKEND=host),
the build the port's dumps must equal byte for byte.  Each side gets its
own KmerSet and PackedStrings over the same arrays.
"""

import numpy as np
import pytest

from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu.core.kmer_set_compact import KmerSetCompact as RefCompact
from kmerset_tpu.core.strings import PackedStrings as RefStrings
from kmerset_tpu_torch.core import spss
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact
from kmerset_tpu_torch.core.strings import PackedStrings


def _kmer_set(k: int) -> KmerSet:
    rng = np.random.default_rng(k)
    from kmerset_tpu.core import kmer as kc

    codes = rng.integers(0, 4, 6000).astype(np.int64)
    kmers = kc.canonical(kc.kmers_from_codes(codes, k), k)
    return KmerSet(k, np.unique(kmers), _sorted=True)


def _ref(ks: KmerSet) -> RefKmerSet:
    return RefKmerSet(ks.k, ks.kmers, _sorted=True)


def _port_strings(ps: RefStrings) -> PackedStrings:
    return PackedStrings(ps.codes, ps.offsets)


@pytest.fixture(autouse=True)
def _host_reference(monkeypatch):
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


@pytest.mark.parametrize("k", [9, 15, 19, 23])
def test_decode_matches_reference(k):
    ks = _kmer_set(k)
    strings = ref_spss.get_spss_canonical(_ref(ks))
    want = ref_spss.decode_unique_kmers(strings, k, True)
    np.testing.assert_array_equal(want, ks.kmers)
    mine = _port_strings(strings)
    got = spss.decode_unique_kmers(mine, k, True, device="cpu")
    np.testing.assert_array_equal(got, want)
    rt = spss.get_kmer_set_from_spss(mine, k, True, device="cpu")
    np.testing.assert_array_equal(
        rt.kmers, ref_spss.get_kmer_set_from_spss(strings, k, True).kmers
    )


def test_compact_edition_decodes_on_device_and_dumps_like_reference(tmp_path):
    k = 15
    ks = _kmer_set(k)
    port = KmerSetCompact.from_kmer_set(ks, True, device="cpu")
    ref = RefCompact.from_kmer_set(_ref(ks), True)
    fresh = KmerSetCompact(k, port.spss, device="cpu")
    assert fresh._kmers_cache is None  # the decode below is a real one
    assert fresh.to_kmer_set(True).equals(ks)
    assert fresh.size() == ref.size() == ks.size()
    port.dump(str(tmp_path / "a.txt"))
    ref.dump(str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()


@pytest.mark.parametrize("k", [15, 19, 23])
def test_spss_build_matches_reference(k):
    """The device front-end's SPSS equals the reference's host build,
    codes and offsets."""
    ks = _kmer_set(k)
    got = spss.get_spss_canonical(ks, device="cpu")
    want = ref_spss.get_spss_canonical(_ref(ks))
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.offsets, want.offsets)
    u_got = spss.get_unitigs_canonical(ks, device="cpu")
    u_want = ref_spss.get_unitigs_canonical(_ref(ks))
    np.testing.assert_array_equal(u_got.codes, u_want.codes)
    np.testing.assert_array_equal(u_got.offsets, u_want.offsets)


def test_spss_build_edge_cases_match_reference():
    """An empty set, a one-k-mer set, and even k refused as the reference
    refuses it."""
    for kmers in (np.empty(0, np.int64), np.array([5], np.int64)):
        ks = KmerSet(19, kmers, _sorted=True)
        got = spss.get_spss_canonical(ks, device="cpu")
        want = ref_spss.get_spss_canonical(_ref(ks))
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.offsets, want.offsets)
    with pytest.raises(ValueError, match="odd k"):
        spss.get_unitigs_canonical(KmerSet(16, np.array([5])), device="cpu")


@pytest.mark.parametrize("k", [19, 23])
def test_parity_tier_2_16_kmers(k, tmp_path):
    """2^16 distinct k-mers at k = 19 and 23: the count, the SPSS and the
    dump equal the reference's (ROADMAP A.4)."""
    from kmerset_tpu.core.kmer_counter import KmerCounter as RefCounter
    from kmerset_tpu_torch.core.kmer_counter import KmerCounter

    rng = np.random.default_rng(1000 + k)
    genome = rng.integers(0, 4, (1 << 16) + k - 1, dtype=np.uint8)
    reads = ["".join("ACGT"[c] for c in genome[i : i + 5000 + k])
             for i in range(0, 1 << 16, 5000)]
    port = KmerCounter.from_reads(k, reads, True, device="cpu")
    ref = RefCounter.from_reads(k, reads, True)
    np.testing.assert_array_equal(port.kmers, ref.kmers)
    np.testing.assert_array_equal(port.counts, ref.counts)
    assert port.kmers.size > (1 << 16) - 64
    ks, _ = port.to_kmer_set(1)
    got = KmerSetCompact.from_kmer_set(ks, True, device="cpu")
    want = RefCompact.from_kmer_set(ref.to_kmer_set(1)[0], True)
    got.dump(str(tmp_path / "a.txt"))
    want.dump(str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
    fresh = KmerSetCompact(k, got.spss, device="cpu")
    assert fresh.to_kmer_set(True).equals(ks)
