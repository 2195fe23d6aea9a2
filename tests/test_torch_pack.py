"""Kernel B1 (kmerset_tpu_torch/ops/pack.py) held against the reference.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held against that version on the card by chip_smoke.py.  The reference is
the Pallas kernel in interpret mode and the host k-mer codec.  All
comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core import native
from kmerset_tpu.ops.pallas_pack import canonical_windows_pallas
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
        pack.canonical_windows(packed, 100, 16)  # pair keys: kernel B2
    with pytest.raises(ValueError):
        pack.canonical_windows(packed, 96, 9)  # byte count does not match L
    with pytest.raises(TypeError):
        pack.canonical_windows(packed.to(torch.int32), 100, 9)
    with pytest.raises(TypeError):
        pack.canonical_windows(packed, 100, 9, valid=torch.ones(5, dtype=torch.bool))
