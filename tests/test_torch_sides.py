"""The slow link's front-end format: the port's side codes
(kmerset_tpu_torch/ops/unitigs.dispatch_sides, device_unitig_sides) and
the host successor rebuilt from them (core/native.succ_from_sides),
against the reference's (kmerset_tpu/ops/unitigs.unitig_sides, its jit on
the CPU, and kmerset_tpu/core/native.succ_from_sides on the same
library).

Byte: bit 0 term_r, bits 1-2 base_r, bit 3 same_r, bit 4 term_l, bits
5-6 base_l, bit 7 same_l, the payload zeroed on terminal sides.  The
rebuilt successor must equal the port's device front-end's, and the
canonical SPSS build through the side-code route must give the bytes of
the fast link's route and of the reference's host build.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core import native as ref_native
from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu.ops import unitigs as ref_unitigs
from kmerset_tpu_torch.core import native, spss
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.ops import backend, unitigs

pytestmark = pytest.mark.skipif(
    native.get_lib() is None, reason="native library unavailable"
)


def _set(k: int, seed: int, n_codes: int = 6000) -> np.ndarray:
    """The canonical k-mers of a random sequence with repeats (so the
    graph has branches, chains, cycles and isolated k-mers)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n_codes)
    g = np.concatenate([g, g[1000:1400], rng.integers(0, 4, 50), g[3000:3300]])
    return np.unique(kc.canonical(kc.kmers_from_codes(g.astype(np.int64), k), k))


@pytest.mark.parametrize("k", [15, 19, 23, 31])
def test_side_codes_equal_reference(k):
    A = _set(k, k)
    got = unitigs.device_unitig_sides(A, k, device="cpu")
    want = ref_unitigs.device_unitig_sides(A, k)
    assert got.dtype == np.uint8 and got.shape == A.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [15, 31])
def test_side_codes_in_query_chunks_equal_one_shot(k):
    """Below n the degrees of the whole set come first; every chunk size
    gives the same bytes."""
    A = torch.from_numpy(_set(k, 40 + k))
    whole = unitigs.dispatch_sides(A, k, query_chunk=A.shape[0])
    for chunk in (1000, 777):
        torch.testing.assert_close(unitigs.dispatch_sides(A, k, query_chunk=chunk), whole)


@pytest.mark.parametrize("k", [15, 19, 23, 31])
def test_succ_from_sides_equals_reference_and_front_end(k):
    """The port's binding rebuilds the reference's successor from the same
    side codes, and that is the port's device front-end's successor, with
    the same terminal masks."""
    A = _set(k, 60 + k)
    sides = unitigs.device_unitig_sides(A, k, device="cpu")
    got = native.succ_from_sides(A, sides, k)
    np.testing.assert_array_equal(got, ref_native.succ_from_sides(A, sides, k))
    succ, term_l, term_r, both = unitigs.device_unitig_succ(A, k, device="cpu")
    np.testing.assert_array_equal(got, succ)
    np.testing.assert_array_equal((sides & 1) != 0, term_r)
    np.testing.assert_array_equal((sides & 16) != 0, term_l)
    np.testing.assert_array_equal(((sides & 1) != 0) & ((sides & 16) != 0), both)


@pytest.mark.parametrize("k", [15, 23])
def test_succ_partitioned_edition_equals_fp(monkeypatch, k):
    """From _SUCC_PART_MIN k-mers on the rebuild takes the partitioned
    edition: the same successor, and the same refusal of corrupt codes,
    as the reference's."""
    A = _set(k, 80 + k)
    sides = unitigs.device_unitig_sides(A, k, device="cpu")
    fp = native.succ_from_sides(A, sides, k)
    monkeypatch.setattr(native, "_SUCC_PART_MIN", 1)
    monkeypatch.setattr(ref_native, "_SUCC_PART_MIN", 1)
    np.testing.assert_array_equal(native.succ_from_sides(A, sides, k), fp)
    np.testing.assert_array_equal(ref_native.succ_from_sides(A, sides, k), fp)
    bad = sides.copy()
    bad[np.flatnonzero((sides & 1) == 0)[0]] ^= 0b110
    assert native.succ_from_sides(A, bad, k) is None
    assert ref_native.succ_from_sides(A, bad, k) is None


def test_corrupt_or_mismatched_side_codes_refused():
    k = 15
    A = _set(k, 5)
    sides = unitigs.device_unitig_sides(A, k, device="cpu")
    bad = sides.copy()
    bad[np.flatnonzero((sides & 1) == 0)[0]] ^= 0b110
    assert native.succ_from_sides(A, bad, k) is None
    assert native.succ_from_sides(A, sides[:-1], k) is None
    assert native.succ_from_sides(A[:0], sides[:0], k).shape == (0,)


def test_terminal_sides_carry_no_payload():
    k = 15
    sides = unitigs.device_unitig_sides(_set(k, 3), k, device="cpu")
    term_r, term_l = (sides & 1) != 0, (sides & 16) != 0
    assert term_r.any() and (~term_r).any() and term_l.any()
    assert not (sides[term_r] & 0b00001110).any()
    assert not (sides[term_l] & 0b11100000).any()


@pytest.mark.parametrize("k", [15, 19, 23, 31])
def test_side_code_route_unitigs_equal_reference(monkeypatch, k):
    """get_unitigs_canonical on a slow link (the side codes and the host
    rebuild) gives the bytes of the fast link's route and of the
    reference's host build."""
    A = _set(k, 20 + k)
    called = []
    monkeypatch.setattr(native, "succ_from_sides",
                        lambda *a, f=native.succ_from_sides: called.append(1) or f(*a))
    monkeypatch.setattr(backend, "_slow_link", lambda device: True)
    slow = spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device="cpu")
    assert called
    monkeypatch.setattr(backend, "_slow_link", lambda device: False)
    fast = spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device="cpu")
    assert len(called) == 1
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    monkeypatch.setenv("KMERSET_TPU_LINK", "fast")
    want = ref_spss.get_unitigs_canonical(RefKmerSet(k, A, _sorted=True))
    for got in (slow, fast):
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.offsets, want.offsets)


def test_side_code_route_raises_when_the_rebuild_refuses(monkeypatch):
    """Side codes from the port's own device that the rebuild refuses are
    a fault: it raises, with no other route."""
    monkeypatch.setattr(backend, "_slow_link", lambda device: True)
    monkeypatch.setattr(native, "succ_from_sides", lambda *a: None)
    with pytest.raises(RuntimeError, match="side codes"):
        spss.get_unitigs_canonical(KmerSet(15, _set(15, 9), _sorted=True), device="cpu")
