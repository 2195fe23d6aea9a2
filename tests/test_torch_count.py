"""The port's counting pipeline (kmerset_tpu_torch/ops/count.py, backend.py)
against kmerset_tpu.ops.count on the same staged numpy inputs, on the CPU.

Every comparison is exact: trimmed keys, counts, n_unique, n_kept and
n_cut are integers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerset_tpu.core import io as core_io
from kmerset_tpu.ops import backend as ref_backend
from kmerset_tpu.ops import count as R
from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.ops import count as P

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _reads(seed: int):
    """~4x coverage of a 3 kb genome, both strands, a read repeated 12
    times (counts above the shift cutoff) and reads split by N runs."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 3000, dtype=np.uint8)
    reads = []
    for _ in range(40):
        s = int(rng.integers(0, 2700))
        r = genome[s : s + 300]
        if rng.random() < 0.5:
            r = 3 - r[::-1]
        reads.append(_BASES[r].tobytes().decode())
    reads += [_BASES[genome[100:180]].tobytes().decode()] * 12
    for j in range(4):
        r = _BASES[genome[500 * j : 500 * j + 400]].copy()
        r[rng.integers(0, 400, 6)] = ord("N")
        reads.append(r.tobytes().decode())
    return reads


def _inputs(k: int):
    codes, offsets = core_io.reads_to_codes(_reads(k))
    ref_staged = ref_backend._staged_windows_u8(codes, offsets, k)
    port_staged = backend.stage(codes, offsets, k, "cpu")
    return ref_staged, port_staged


def _port_from_ref_staging(ref_staged):
    """The reference's own padded staging, handed to the port as is."""
    packed, bounds, total, L = ref_staged
    return torch.from_numpy(packed), torch.from_numpy(bounds), total, L


@pytest.mark.parametrize("k", [9, 15, 19, 23, 31])
def test_count_kmers_frag_matches_reference(k):
    ref_staged, port_staged = _inputs(k)
    uniq, counts, n_unique = R.count_kmers_frag(*ref_staged, k, True)
    n = int(n_unique)
    want_u, want_c = np.asarray(uniq)[:n], np.asarray(counts)[:n]
    assert want_c.max() >= 12  # the repeated read
    for staged in (port_staged, _port_from_ref_staging(ref_staged)):
        pu, pc, pn = P.count_kmers_frag(*staged, k, True)
        assert pn == n
        assert pu.dtype == (torch.int32 if k <= 15 else torch.int64)
        assert pc.dtype == torch.int32
        np.testing.assert_array_equal(pu.numpy(), want_u)
        np.testing.assert_array_equal(pc.numpy(), want_c)


@pytest.mark.parametrize("cutoff", [1, 2, 3, 9])
@pytest.mark.parametrize("k", [9, 15, 19, 23, 31])
def test_count_to_set_frag_matches_reference(k, cutoff):
    ref_staged, port_staged = _inputs(k)
    uniq, n_kept, n_cut = R.count_to_set_frag(*ref_staged, k, True, cutoff)
    m = int(n_kept)
    for staged in (port_staged, _port_from_ref_staging(ref_staged)):
        pu, pk, pcut = P.count_to_set_frag(*staged, k, True, cutoff)
        assert (pk, pcut) == (m, int(n_cut))
        np.testing.assert_array_equal(pu.numpy(), np.asarray(uniq)[:m])
    if cutoff > 1:
        assert int(n_cut) > 0


def test_forward_keys_match_reference():
    k = 15
    ref_staged, port_staged = _inputs(k)
    uniq, counts, n_unique = R.count_kmers_frag(*ref_staged, k, False)
    pu, pc, pn = P.count_kmers_frag(*port_staged, k, False)
    n = int(n_unique)
    assert pn == n
    np.testing.assert_array_equal(pu.numpy(), np.asarray(uniq)[:n])
    np.testing.assert_array_equal(pc.numpy(), np.asarray(counts)[:n])


def test_reference_kernel_branch_interpret_matches_port(monkeypatch):
    """The reference's compaction-kernel branches (position-diff counts;
    keys-only compaction) are the ones the port carries over; force them
    in the reference through interpret mode (as tests/test_parallel.py
    does) and compare.  The monkeypatching is of the reference, in this
    test only."""
    from kmerset_tpu.ops import pallas_compact as PC

    monkeypatch.setattr(PC, "use_compact_kernel", lambda n, kk: n % PC.BLOCK == 0)
    calls = []
    orig = PC.compact_select_multi

    def spy(lanes, keep, num_keys=1, interpret=False):
        calls.append(1)
        return orig(lanes, keep, num_keys, interpret=True)

    monkeypatch.setattr(PC, "compact_select_multi", spy)
    k = 11
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, PC.BLOCK + 100, dtype=np.uint8)
    codes = np.concatenate([codes, codes[:3000]])  # repeats: counts of 2
    offsets = np.array([0, 5000, codes.size], dtype=np.int64)
    ref_staged = ref_backend._staged_windows_u8(codes, offsets, k)
    port_staged = backend.stage(codes, offsets, k, "cpu")
    jitted = (R.count_kmers_frag, R.count_to_set_frag, R.count_to_set)
    for f in jitted:  # a cached trace would skip the patched branch
        f.clear_cache()
    try:
        uniq, counts, n_unique = R.count_kmers_frag(*ref_staged, k, True)
        uniq2, n_kept, n_cut = R.count_to_set_frag(*ref_staged, k, True, 2)
        assert len(calls) == 2
    finally:
        for f in jitted:
            f.clear_cache()
    n, m = int(n_unique), int(n_kept)
    pu, pc, pn = P.count_kmers_frag(*port_staged, k, True)
    assert pn == n
    np.testing.assert_array_equal(pu.numpy(), np.asarray(uniq)[:n])
    np.testing.assert_array_equal(pc.numpy(), np.asarray(counts)[:n])
    pu2, pk, pcut = P.count_to_set_frag(*port_staged, k, True, 2)
    assert (pk, pcut) == (m, int(n_cut))
    assert m > 0
    np.testing.assert_array_equal(pu2.numpy(), np.asarray(uniq2)[:m])


def test_count_of_input_without_a_window_is_empty():
    """An input whose every window crosses a fragment boundary counts
    nothing."""
    codes = np.zeros(40, np.uint8)
    offsets = np.arange(0, 41, 10, dtype=np.int64)  # fragments of 10 < k
    keys, counts, n = P.count_kmers_frag(*backend.stage(codes, offsets, 15, "cpu"),
                                         15, True)
    assert n == keys.shape[0] == counts.shape[0] == 0


@pytest.mark.parametrize("k", [9, 15, 19, 23, 31])
def test_frag_window_validity_matches_reference(k):
    ref_staged, _ = _inputs(k)
    _, bounds, total, L = ref_staged
    want = np.asarray(R._frag_window_validity(jnp.asarray(bounds), total, L, k))
    got = P._frag_window_validity(torch.from_numpy(bounds), total, L, k)
    np.testing.assert_array_equal(got.numpy(), want)


def test_frag_window_validity_random_bounds_match_reference():
    """The port marks invalid bands with a scatter where the reference
    scans; hold them equal on short inputs, boundaries at 0, fragments
    shorter than k and bounds padded with `total`."""
    rng = np.random.default_rng(17)
    L = 48  # one shape: the reference's eager ops compile once
    for _ in range(100):
        total = int(rng.integers(0, L + 1))
        k = int(rng.integers(1, 16))
        nb = int(rng.integers(1, 8))
        b = np.sort(rng.integers(0, total + 1, nb))
        b = np.concatenate([b, [total] * (10 - nb)]).astype(np.int32)
        want = np.asarray(R._frag_window_validity(jnp.asarray(b), total, L, k))
        got = P._frag_window_validity(torch.from_numpy(b), total, L, k)
        np.testing.assert_array_equal(got.numpy(), want)


def test_run_lengths_and_reaches_match_reference():
    rng = np.random.default_rng(5)
    s = np.sort(rng.integers(0, 300, 2000).astype(np.int32))
    s[-50:] = R._S_SENT
    live = s != R._S_SENT
    boundary = live & np.concatenate([[True], s[1:] != s[:-1]])
    want = np.asarray(R._run_lengths(jnp.asarray(boundary), jnp.asarray(live)))
    got = P._run_lengths(torch.from_numpy(boundary), torch.from_numpy(live))
    np.testing.assert_array_equal(got.numpy(), want)
    for c in (1, 2, 5, 3000):
        want = np.asarray(R._run_reaches((jnp.asarray(s),), jnp.asarray(live), c))
        got = P._run_reaches(torch.from_numpy(s), torch.from_numpy(live), c)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("value_max", [0, 3, 255, 1000])
def test_device_count_saturates_like_reference(value_max):
    k = 9
    codes, offsets = core_io.reads_to_codes(_reads(k))
    uniq, counts, n_unique = R.count_kmers_frag(
        *ref_backend._staged_windows_u8(codes, offsets, k), k, True
    )
    n = int(n_unique)
    want_c = np.asarray(counts)[:n].astype(np.int64)
    if value_max:
        want_c = np.minimum(want_c, value_max)
    keys, got_c = backend.device_count(
        codes, offsets, k, True, device="cpu", value_max=value_max
    )
    assert keys.dtype == np.int64
    assert got_c.dtype == (np.uint8 if 0 < value_max <= 255 else np.int64)
    np.testing.assert_array_equal(keys, np.asarray(uniq)[:n])
    np.testing.assert_array_equal(got_c.astype(np.int64), want_c)


def test_device_unique_and_empty_inputs():
    k = 15
    codes, offsets = core_io.reads_to_codes(_reads(k))
    want = np.unique(
        ref_backend.device_unique(codes, offsets, k, True)
    )
    np.testing.assert_array_equal(
        backend.device_unique(codes, offsets, k, True, device="cpu"), want
    )
    short = codes[: k - 1]
    offs = np.array([0, k - 1], np.int64)
    assert backend.device_unique(short, offs, k, True, device="cpu").size == 0
    keys, counts = backend.device_count(short, offs, k, True, device="cpu")
    assert keys.size == counts.size == 0


def test_limits_raise(monkeypatch):
    codes, offsets = core_io.reads_to_codes(_reads(9))
    with pytest.raises(ValueError, match="k <= 31"):
        backend.device_count(codes, offsets, 32, True, device="cpu")
    monkeypatch.setattr(backend, "MAX_WINDOWS", 100)
    with pytest.raises(ValueError, match="in one shot"):
        backend.device_count(codes, offsets, 9, True, device="cpu")


@pytest.mark.parametrize("k", [19, 23, 31])
def test_pair_forward_keys_and_steps_match_reference(k):
    """Forward (non-canonical) int64 keys and counts equal the reference's
    pair layout (its int64 layout at k = 31), and the pack step is kernel
    B2's: int64 keys."""
    ref_staged, port_staged = _inputs(k)
    uniq, counts, n_unique = R.count_kmers_frag(*ref_staged, k, False)
    pu, pc, pn = P.count_kmers_frag(*port_staged, k, False)
    n = int(n_unique)
    assert pn == n
    assert pu.dtype == torch.int64
    np.testing.assert_array_equal(pu.numpy(), np.asarray(uniq)[:n])
    np.testing.assert_array_equal(pc.numpy(), np.asarray(counts)[:n])


@pytest.mark.parametrize("k", [19, 23, 31])
def test_pair_short_and_split_inputs_count_like_reference(k):
    """An input shorter than k counts nothing; fragments split by N runs
    count only the windows inside them, as the reference does."""
    short = np.zeros(k - 1, np.uint8)
    offs = np.array([0, k - 1], np.int64)
    keys, counts = backend.device_count(short, offs, k, True, device="cpu")
    assert keys.size == counts.size == 0
    assert backend.device_unique(short, offs, k, True, device="cpu").size == 0
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 4, 700, dtype=np.uint8)
    offsets = np.array([0, 10, 10 + k, 300, 301, 700], np.int64)
    uniq, counts, n_unique = R.count_kmers_frag(
        *ref_backend._staged_windows_u8(codes, offsets, k), k, True
    )
    n = int(n_unique)
    assert 0 < n <= np.maximum(np.diff(offsets) - k + 1, 0).sum()
    got_k, got_c = backend.device_count(codes, offsets, k, True, device="cpu")
    np.testing.assert_array_equal(got_k, np.asarray(uniq)[:n])
    np.testing.assert_array_equal(got_c, np.asarray(counts)[:n])
