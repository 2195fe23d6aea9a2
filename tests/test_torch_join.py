"""The port's lookup_join (kmerset_tpu_torch/ops/join.py) against the
reference's three sort-joins (kmerset_tpu/ops/join.py), on the CPU.

The reference returns (n_groups, m / n_groups) arrays and leaves idx
unspecified where a query is absent; the port returns (m,) arrays with
idx 0 there.  Found flags and the positions of found queries must be
equal; exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerset_tpu.ops.join import lookup_join as ref_join
from kmerset_tpu.ops.join import lookup_join32, lookup_join_pair
from kmerset_tpu_torch.ops.join import lookup_join


def _set_and_queries(seed: int, bits: int, n: int, m: int):
    """Sorted unique set, and queries half drawn from it, half random
    (so some are absent and some lie above the set's last key)."""
    rng = np.random.default_rng(seed)
    A = np.unique(rng.integers(0, 1 << bits, n))
    Q = rng.integers(0, 1 << bits, m)
    if A.size:
        Q[: m // 2] = A[rng.integers(0, A.size, m // 2)]
    return A, Q


def _port(A, Q):
    found, idx = lookup_join(torch.from_numpy(A), torch.from_numpy(Q))
    assert found.dtype == torch.bool and idx.dtype == torch.int64
    found, idx = found.numpy(), idx.numpy()
    assert (idx[~found] == 0).all()
    return found, idx


def _expect(A, Q, found, idx):
    want = np.isin(Q, A)
    np.testing.assert_array_equal(found, want)
    np.testing.assert_array_equal(A[idx[found]], Q[found])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_lookup_join_matches_reference(seed, dtype):
    A, Q = _set_and_queries(seed, 20, 500, 1024)
    A, Q = A.astype(dtype), Q.astype(dtype)
    found, idx = _port(A, Q)
    rf, ri = ref_join(jnp.asarray(A), jnp.asarray(Q), n_groups=2)
    rf, ri = np.asarray(rf).reshape(-1), np.asarray(ri).reshape(-1)
    np.testing.assert_array_equal(found, rf)
    np.testing.assert_array_equal(idx[found], ri[rf])
    _expect(A, Q, found, idx)


def test_lookup_join_matches_join32_with_all_t_key():
    """k = 15 keys in int32, the reference's tag-fused join; the all-T
    key (the reference's PAD32) is queried and absent."""
    k = 15
    all_t = (1 << (2 * k)) - 1
    A, Q = _set_and_queries(9, 2 * k, 4096, 8192)
    A = A[A != all_t].astype(np.int32)
    Q = np.concatenate([Q, [all_t, 0, all_t - 1]]).astype(np.int32)
    found, idx = _port(A, Q)
    rf, ri = lookup_join32(jnp.asarray(A), jnp.asarray(Q), n_groups=1)
    rf, ri = np.asarray(rf)[0], np.asarray(ri)[0]
    np.testing.assert_array_equal(found, rf)
    np.testing.assert_array_equal(idx[found], ri[rf])
    assert not found[-3]
    _expect(A, Q, found, idx)


def test_lookup_join_matches_join_pair_with_all_t_key():
    """k = 23 keys as int64, against the reference's (hi, lo) pair join;
    the all-T key is queried, absent and then present."""
    k = 23
    klo = k - (k + 1) // 2
    all_t = (1 << (2 * k)) - 1
    A, Q = _set_and_queries(11, 2 * k, 4096, 8192)
    Q = np.concatenate([Q, [all_t, 0]])

    def lanes(x):
        return (jnp.asarray((x >> (2 * klo)).astype(np.int32)),
                jnp.asarray((x & ((1 << (2 * klo)) - 1)).astype(np.int32)))

    for S in (A[A != all_t], np.append(A[A != all_t], all_t)):
        found, idx = _port(S, Q)
        rf, ri = lookup_join_pair(*lanes(S), *lanes(Q), n_groups=1)
        rf, ri = np.asarray(rf)[0], np.asarray(ri)[0]
        np.testing.assert_array_equal(found, rf)
        np.testing.assert_array_equal(idx[found], ri[rf])
        assert found[-2] == (S[-1] == all_t)
        _expect(S, Q, found, idx)


@pytest.mark.parametrize("n", [0, 1, 2])
def test_lookup_join_tiny_sets(n):
    """n = 0 finds nothing; queries below, at and above the last key."""
    A = np.arange(5, 5 + 10 * n, 10, dtype=np.int64)
    Q = np.array([-1, 0, 4, 5, 6, 15, 16, 1 << 62], dtype=np.int64)
    found, idx = _port(A, Q)
    _expect(A, Q, found, idx)
    assert found.sum() == n


def test_lookup_join_promotes_queries_and_checks_shapes():
    A = torch.tensor([2, 4, 8], dtype=torch.int32)
    Q = torch.tensor([8, 3, (1 << 32) + 8], dtype=torch.int64)
    found, idx = lookup_join(A, Q)  # no query wraps into int32
    assert found.tolist() == [True, False, False] and idx.tolist() == [2, 0, 0]
    with pytest.raises(ValueError):
        lookup_join(A.view(1, 3), A)
