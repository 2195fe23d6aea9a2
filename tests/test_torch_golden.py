"""The golden-format fixtures (tests/golden/) through the port, on both
link settings.

The fixtures are hand-written files in the reference's on-disk formats.
Here they are checked against an independent packer and XOR hash in the
test (as tests/test_golden.py does for the reference), not against the
reference: the port's load, decode and re-dump must reproduce them byte
for byte, and a count and build of the fixture's strings (the count's
resident set, the gap-encoded keys and the side codes on a slow link)
must give the same k-mers.
"""

import os

import numpy as np
import pytest

from kmerset_tpu_torch.core.config import KConfig
from kmerset_tpu_torch.core.kmer_counter import KmerCounter
from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact
from kmerset_tpu_torch.core.kmer_set_set import KmerSetSet, KmerSetSetReader
from kmerset_tpu_torch.ops import backend

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
K = 9
_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}


def _pack(s: str) -> int:
    """Independent 2-bit packing, first base most significant."""
    v = 0
    for ch in s:
        v = (v << 2) | _CODE[ch]
    return v


def _lines(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def _kmers_of_file(path, k=K):
    return {_pack(s[i : i + k]) for s in _lines(path) for i in range(len(s) - k + 1)}


def _xor_hash(kmers) -> int:
    h = 0
    for v in kmers:
        h ^= v
    return h


@pytest.fixture(params=["slow", "fast"])
def link(request, monkeypatch):
    monkeypatch.setattr(backend, "_slow_link", lambda device: request.param == "slow")
    monkeypatch.setattr(backend, "DELTA_MIN_KEYS", 1)
    return request.param


def test_spss_text_golden_load_decode_redump(tmp_path, link):
    path = os.path.join(GOLDEN, "tiny.spss.txt")
    expected = _kmers_of_file(path)
    compact = KmerSetCompact.load(K, path, "", device="cpu")
    ks = compact.to_kmer_set(False)
    assert ks.size() == len(expected) and ks.hash() == _xor_hash(expected)
    np.testing.assert_array_equal(ks.kmers, np.array(sorted(expected)))
    out = tmp_path / "redump.txt"
    compact.dump(str(out), "")
    with open(path, "rb") as f:
        assert out.read_bytes() == f.read()


def test_spss_text_golden_counted_and_built(tmp_path, link):
    """The fixture's strings counted (forward k-mers, the resident set
    kept) and built into a directed SPSS: the same k-mers as the packer's,
    and the dump decodes back to them."""
    path = os.path.join(GOLDEN, "tiny.spss.txt")
    expected = np.array(sorted(_kmers_of_file(path)))
    counter = KmerCounter.from_reads(K, _lines(path), False, device="cpu")
    ks, n_cut = counter.to_kmer_set(1)
    assert n_cut == 0 and ks.device is not None
    np.testing.assert_array_equal(ks.kmers, expected)
    out = tmp_path / "built.txt"
    KmerSetCompact.from_kmer_set(ks, False, device="cpu").dump(str(out))
    back = KmerSetCompact.load(K, str(out), "", device="cpu").to_kmer_set(False)
    np.testing.assert_array_equal(back.kmers, expected)


def test_multiset_directory_golden(tmp_path, link):
    cfg = KConfig(k=K, n=4)
    d = os.path.join(GOLDEN, "multiset")
    # Set 0 is 0.txt with its child 2.txt (meta: key 0 has child 2); set 1
    # is 1.txt alone.
    exp0 = _kmers_of_file(os.path.join(d, "0.txt")) | _kmers_of_file(os.path.join(d, "2.txt"))
    exp1 = _kmers_of_file(os.path.join(d, "1.txt"))
    sss = KmerSetSet.load(cfg, d, "", "txt", False, device="cpu")
    for i, exp in ((0, exp0), (1, exp1)):
        got = sss.get(i, False)
        assert got.size() == len(exp) and got.hash() == _xor_hash(exp)
    reader = KmerSetSetReader.from_directory(cfg, d, "txt", "", False, device="cpu")
    assert reader.size() == 3
    r0 = reader.get(0)
    assert r0.size() == len(exp0) and r0.hash() == _xor_hash(exp0)
    out_dir = tmp_path / "redump"
    sss.dump(str(out_dir), "", "txt")
    for name in ("meta.txt", "0.txt", "1.txt", "2.txt"):
        with open(os.path.join(d, name), "rb") as f:
            assert (out_dir / name).read_bytes() == f.read(), name
