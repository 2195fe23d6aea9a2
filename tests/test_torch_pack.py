"""Kernels B1 and B2 (kmerset_tpu_torch/ops/pack.py) held against the
reference.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernels
are held against that version on the card by chip_smoke.py.  The
reference is the Pallas kernels in interpret mode, the XLA roll
formulation (ops/count.py:_pair_windows) and the host k-mer codec.  All
comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core import native
from kmerset_tpu.ops import count as R
from kmerset_tpu.ops.pallas_pack import (
    canonical_windows_pair_pallas,
    canonical_windows_pallas,
)
from kmerset_tpu_torch.ops import pack


def _codes(k: int, L: int = 3000) -> np.ndarray:
    return np.random.default_rng(100 + k).integers(0, 4, L, dtype=np.uint8)


def _packed(codes: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(native.pack2(codes))


@pytest.mark.parametrize("k", [7, 9, 11, 15])
def test_pack_matches_pallas_interpret(k):
    codes = _codes(k)
    L = codes.size
    got = pack.canonical_windows(_packed(codes), L, k).numpy()
    want = np.asarray(
        canonical_windows_pallas(jnp.asarray(codes.astype(np.int32)), k,
                                 interpret=True)
    )
    assert got.shape == (L - k + 1,)
    np.testing.assert_array_equal(got, want[: L - k + 1])


@pytest.mark.parametrize("k", [7, 9, 11, 15])
def test_pack_matches_host_canonical(k):
    codes = _codes(k)
    got = pack.canonical_windows(_packed(codes), codes.size, k).numpy()
    want = kc.canonical(kc.kmers_from_codes(codes.astype(np.int64), k), k)
    np.testing.assert_array_equal(got.astype(np.int64), want)


def test_pack_forward_only():
    k = 15
    codes = _codes(k)
    got = pack.canonical_windows(_packed(codes), codes.size, k, canonical=False)
    want = kc.kmers_from_codes(codes.astype(np.int64), k)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want)


def test_pack_valid_mask_writes_sentinel():
    k = 11
    codes = _codes(k)
    n = codes.size - k + 1
    valid = np.random.default_rng(7).random(n) > 0.2
    got = pack.canonical_windows(
        _packed(codes), codes.size, k, valid=torch.from_numpy(valid)
    ).numpy()
    want = kc.canonical(kc.kmers_from_codes(codes.astype(np.int64), k), k)
    np.testing.assert_array_equal(got[valid].astype(np.int64), want[valid])
    assert (got[~valid] == pack.S_SENT).all()


@pytest.mark.parametrize("L", [1, 4, 5, 4099])
def test_unpack2_matches_native(L):
    codes = np.random.default_rng(L).integers(0, 4, L, dtype=np.uint8)
    got = pack.unpack2(_packed(codes), L).numpy()
    np.testing.assert_array_equal(got, codes.astype(np.int32))


def test_pack_rejects_bad_inputs():
    codes = _codes(9, 100)
    packed = _packed(codes)
    with pytest.raises(ValueError):
        pack.canonical_windows(packed, 100, 24)  # above the int64 layout
    with pytest.raises(ValueError):
        pack.canonical_windows(packed, 96, 9)  # byte count does not match L
    with pytest.raises(TypeError):
        pack.canonical_windows(packed.to(torch.int32), 100, 9)
    with pytest.raises(TypeError):
        pack.canonical_windows(packed, 100, 9, valid=torch.ones(5, dtype=torch.bool))


def _pair_codes(k: int, kind: str) -> np.ndarray:
    """Random codes, or a run of one base (all A, all T) with a random
    tail: the extreme keys 0 and 4^k - 1."""
    codes = _codes(k, 2000)
    if kind != "random":
        codes[:1500] = {"all-A": 0, "all-T": 3}[kind]
    return codes


def _combined(hi, lo, k: int) -> np.ndarray:
    klo = k - (k + 1) // 2
    return (np.asarray(hi).astype(np.int64) << (2 * klo)) | np.asarray(lo)


@pytest.mark.parametrize("kind", ["random", "all-A", "all-T"])
@pytest.mark.parametrize("k", [17, 19, 21, 23])
def test_pack_pair_matches_pallas_interpret(k, kind):
    """B2's plain version is the TPU pair kernel's (hi, lo) lanes combined
    as (hi << 2*klo) | lo (reference count.py:canonical_windows)."""
    codes = _pair_codes(k, kind)
    L, n = codes.size, codes.size - k + 1
    got = pack.canonical_windows(_packed(codes), L, k)
    assert got.dtype == torch.int64 and got.shape == (n,)
    hi, lo = canonical_windows_pair_pallas(
        jnp.asarray(codes.astype(np.int32)), k, interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), _combined(hi, lo, k)[:n])
    if kind != "random":  # all-A is canonical, and so is the rc of all-T
        assert (got.numpy()[:1000] == 0).all()


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [17, 19, 21, 23])
def test_pack_pair_matches_xla_pair_windows(k, canonical):
    for kind in ("random", "all-A", "all-T"):
        codes = _pair_codes(k, kind)
        L, n = codes.size, codes.size - k + 1
        got = pack.canonical_windows(_packed(codes), L, k, canonical)
        hi, lo = R._pair_windows(jnp.asarray(codes), k, canonical)
        np.testing.assert_array_equal(got.numpy(), _combined(hi, lo, k)[:n])
    if not canonical:  # the all-T windows keep their forward key
        assert got.numpy()[0] == (1 << (2 * k)) - 1


def test_pack_pair_valid_mask_writes_int64_sentinel():
    k = 19
    codes = _codes(k)
    n = codes.size - k + 1
    valid = np.random.default_rng(8).random(n) > 0.2
    got = pack.canonical_windows(
        _packed(codes), codes.size, k, valid=torch.from_numpy(valid)
    ).numpy()
    want = kc.canonical(kc.kmers_from_codes(codes.astype(np.int64), k), k)
    np.testing.assert_array_equal(got[valid], want[valid])
    assert (got[~valid] == pack.SENTINEL).all()
    assert pack.SENTINEL == int(R.SENTINEL)
    assert pack.SINGLE_MAX_K == R.SINGLE_MAX_K and pack.MAX_K == R.PAIR_MAX_K
