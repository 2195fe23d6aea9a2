"""The port's SPSS decode (core/spss.py) and KmerSetCompact edition against
the reference's host decode, on the CPU; exact."""

import numpy as np
import pytest

from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet
from kmerset_tpu.core.kmer_set_compact import KmerSetCompact as RefCompact
from kmerset_tpu_torch.core import spss
from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact


def _kmer_set(k: int) -> KmerSet:
    rng = np.random.default_rng(k)
    from kmerset_tpu.core import kmer as kc

    codes = rng.integers(0, 4, 6000).astype(np.int64)
    kmers = kc.canonical(kc.kmers_from_codes(codes, k), k)
    return KmerSet(k, np.unique(kmers), _sorted=True)


@pytest.mark.parametrize("k", [9, 15])
def test_decode_matches_reference(k):
    ks = _kmer_set(k)
    strings = ref_spss.get_spss_canonical(ks)
    want = ref_spss.decode_unique_kmers(strings, k, True)
    np.testing.assert_array_equal(want, ks.kmers)
    got = spss.decode_unique_kmers(strings, k, True, device="cpu")
    np.testing.assert_array_equal(got, want)
    rt = spss.get_kmer_set_from_spss(strings, k, True, device="cpu")
    assert rt.equals(ref_spss.get_kmer_set_from_spss(strings, k, True))


def test_compact_edition_decodes_on_device_and_dumps_like_reference(tmp_path):
    k = 15
    ks = _kmer_set(k)
    port = KmerSetCompact.from_kmer_set(ks, True, device="cpu")
    ref = RefCompact.from_kmer_set(ks, True)
    fresh = KmerSetCompact(k, port.spss, device="cpu")
    assert fresh._kmers_cache is None  # the decode below is a real one
    assert fresh.to_kmer_set(True).equals(ks)
    assert fresh.size() == ref.size() == ks.size()
    port.dump(str(tmp_path / "a.txt"))
    ref.dump(str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()
