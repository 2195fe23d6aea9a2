"""The port's unitig graph front-end (kmerset_tpu_torch/ops/neighbors.py,
ops/unitigs.py) against the reference, on the CPU.

Side tables against the host's spss._side_table_canonical; the successor
array and the terminal masks against the reference's device front-end
(kmerset_tpu.ops.unitigs.device_unitig_succ, JAX on the CPU) and against
the host construction, bit for bit.
"""

import numpy as np
import pytest
import torch

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core import spss
from kmerset_tpu.ops import unitigs as ref_unitigs
from kmerset_tpu_torch.ops import backend, neighbors, unitigs


def _canonical_set(k: int, codes: np.ndarray) -> np.ndarray:
    return np.unique(kc.canonical(kc.kmers_from_codes(codes.astype(np.int64), k), k))


def _random_set(k: int) -> np.ndarray:
    rng = np.random.default_rng(k)
    return _canonical_set(k, rng.integers(0, 4, 6000))


def _cycle_set(k: int) -> np.ndarray:
    """Every window of a circular random sequence: one pure cycle."""
    g = np.random.default_rng(100 + k).integers(0, 4, 400)
    return _canonical_set(k, np.concatenate([g, g[: k - 1]]))


def _isolated_set(k: int) -> np.ndarray:
    """A few random k-mers: no two are neighbours."""
    rng = np.random.default_rng(200 + k)
    return np.unique(kc.canonical(rng.integers(0, 1 << (2 * k), 40), k))


def _host_succ(A: np.ndarray, k: int):
    """The host construction of tests/test_join.py:113-125."""
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = spss._side_tables(A, k, True)
    mate_r = np.where(rsame, rdeg[rnbr], ldeg[rnbr])
    term_r = (rdeg != 1) | (mate_r != 1)
    mate_l = np.where(lsame, ldeg[lnbr], rdeg[lnbr])
    term_l = (ldeg != 1) | (mate_l != 1)
    succ = np.empty(2 * A.size, dtype=np.int64)
    succ[0::2] = np.where(term_r, -1, 2 * rnbr + rsame)
    succ[1::2] = np.where(term_l, -1, 2 * lnbr + (~lsame).astype(np.int64))
    return succ, term_l, term_r, term_l & term_r


@pytest.mark.parametrize("k", [9, 15, 19, 23, 31])
def test_reverse_complement_matches_host_codec(k):
    """The ~x start and torch's arithmetic >> on negatives: the all-T,
    all-A and random keys equal the host codec."""
    rng = np.random.default_rng(k)
    x = np.concatenate([[0, (1 << (2 * k)) - 1, 1, 1 << (2 * k - 2)],
                        rng.integers(0, 1 << (2 * k), 1000)]).astype(np.int64)
    got = neighbors.reverse_complement(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, kc.reverse_complement(x, k))
    assert got[1] == 0 and got[0] == (1 << (2 * k)) - 1


@pytest.mark.parametrize("k", [9, 15, 19, 23, 31])
def test_side_tables_match_host(k):
    A = _random_set(k)
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = neighbors.side_tables(
        torch.from_numpy(A), k, True
    )
    for (deg, nbr, same), right in (((rdeg, rnbr, rsame), True),
                                    ((ldeg, lnbr, lsame), False)):
        hdeg, hnbr, hsame = spss._side_table_canonical(A, k, right=right)
        np.testing.assert_array_equal(deg.numpy(), hdeg)
        # As tests/test_join.py:67-75: the neighbour and its side where
        # the degree is 1; the port keeps the host's first-hit rule
        # everywhere, so the whole arrays agree as well.
        m = hdeg == 1
        np.testing.assert_array_equal(nbr.numpy()[m], hnbr[m])
        np.testing.assert_array_equal(same.numpy()[m], hsame[m])
        np.testing.assert_array_equal(nbr.numpy(), hnbr)
        np.testing.assert_array_equal(same.numpy(), hsame)
    if k == 9:  # the set branches: the first-hit rule is exercised
        assert (rdeg.numpy() > 1).any() and (ldeg.numpy() > 1).any()


@pytest.mark.parametrize("kind", ["random", "cycle", "isolated"])
@pytest.mark.parametrize("k", [9, 15, 19, 23, 31])
def test_device_unitig_succ_bit_for_bit(k, kind):
    A = {"random": _random_set, "cycle": _cycle_set,
         "isolated": _isolated_set}[kind](k)
    got = unitigs.device_unitig_succ(A, k, device="cpu")
    ref = ref_unitigs.device_unitig_succ(A, k)
    assert ref is not None
    host = _host_succ(A, k)
    names = ("succ", "term_l", "term_r", "both")
    for name, g, r, h in zip(names, got, ref, host):
        assert g.dtype == h.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
        np.testing.assert_array_equal(g, h, err_msg=name)
    succ, term_l, term_r, both = got
    if kind == "cycle" and k >= 15:  # at k = 9, 400 windows may repeat
        assert (succ >= 0).all() and not (term_l | term_r).any()
    if kind == "isolated":
        assert (succ == -1).all() and both.all()


def test_next_kmer_wraps_through_the_sign_bit_at_k_31():
    """At k = 31, (Q << 2) carries bits 61-62 of a key whose first base
    is T into bit 63, the sign bit of int64; the mask drops it, so the
    side tables equal the host's.  Each T...A key has its four right
    extensions in the set."""
    k = 31
    mid = np.random.default_rng(31).integers(0, 1 << 58, 50)
    x = kc.canonical((3 << 60) | (mid << 2), k)
    assert (x >> 60 == 3).all()  # either strand of a T...A key is T...A
    ext = [kc.next_kmer(x, k, c) for c in range(4)]
    A = np.unique(kc.canonical(np.concatenate([x, *ext]), k))
    assert (torch.from_numpy(A) << 2).min() < 0
    for (deg, nbr, same), right in zip(
        neighbors.side_tables(torch.from_numpy(A), k, True), (True, False)
    ):
        hdeg, hnbr, hsame = spss._side_table_canonical(A, k, right=right)
        np.testing.assert_array_equal(deg.numpy(), hdeg)
        np.testing.assert_array_equal(nbr.numpy(), hnbr)
        np.testing.assert_array_equal(same.numpy(), hsame)
    rdeg = neighbors.side_tables(torch.from_numpy(A), k, True)[0][0].numpy()
    assert (rdeg[np.searchsorted(A, x)] == 4).all()


def test_front_end_limits_raise(monkeypatch):
    """An empty query chunk raises; the directed graph no longer does (its
    tables are the host's plain ones), nor does a set above the
    front-end's one-shot memory budget (it is built in query chunks,
    equal to the one-shot result)."""
    A = _random_set(9)
    for (deg, nbr, same), right in zip(
        neighbors.side_tables(torch.from_numpy(A), 9, canonical=False),
        (True, False),
    ):
        hdeg, hnbr = spss._side_table_plain(A, 9, right=right)
        np.testing.assert_array_equal(deg.numpy(), hdeg)
        np.testing.assert_array_equal(nbr.numpy(), hnbr)
        assert not same.numpy().any()
    with pytest.raises(ValueError, match="query_chunk"):
        unitigs.device_unitig_succ(A, 9, device="cpu", query_chunk=0)
    want = unitigs.device_unitig_succ(A, 9, device="cpu")
    budget = backend.FRONT_END_BYTES_PER_QUERY * (A.size - 1)
    monkeypatch.setattr(backend, "memory_budget", lambda device: budget)
    for g, w in zip(unitigs.device_unitig_succ(A, 9, device="cpu"), want):
        np.testing.assert_array_equal(g, w)
