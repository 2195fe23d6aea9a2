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
        pack.canonical_windows(packed, 100, 32)  # above the int64 layout
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
    assert pack.SINGLE_MAX_K == R.SINGLE_MAX_K
    assert R.PAIR_MAX_K < pack.MAX_K == 31  # B2 also takes the int64 layout


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", range(24, 32))
def test_pack_int64_matches_xla_int64_windows(k, canonical):
    """Above k = 23 the reference keys windows with XLA's int64 layout
    (count.py:_int64_windows, through canonical_windows), not a Pallas
    kernel; B2's plain version equals it, extreme keys included."""
    for kind in ("random", "all-A", "all-T"):
        codes = _pair_codes(k, kind)
        L, n = codes.size, codes.size - k + 1
        got = pack.canonical_windows(_packed(codes), L, k, canonical)
        assert got.dtype == torch.int64 and got.shape == (n,)
        want = np.asarray(R.canonical_windows(jnp.asarray(codes), k, canonical))
        assert want.dtype == np.int64
        np.testing.assert_array_equal(got.numpy(), want[:n])
        assert int(got.max()) < pack.SENTINEL
    if not canonical:  # the all-T windows keep their forward key
        assert got.numpy()[0] == (1 << (2 * k)) - 1


# -- the redesigned kernels' per-window arithmetic (csrc/pack.cu) ----------

_PAIR_SWAPS = (
    (1, 0x5555555555555555), (2, 0x3333333333333333),
    (4, 0x0F0F0F0F0F0F0F0F), (8, 0x00FF00FF00FF00FF),
    (16, 0x0000FFFF0000FFFF), (32, 0x00000000FFFFFFFF),
)


def _brev(x: torch.Tensor, bits: int) -> torch.Tensor:
    """__brev (bits = 32) or __brevll (bits = 64) on non-negative int64
    lanes; every right shift is masked, so the sign bit never spreads."""
    for s, m in _PAIR_SWAPS:
        if s < bits:
            x = ((x >> s) & m) | ((x & m) << s)
    return x


def _kernel_formula(packed, L, k, canonical, valid=None):
    """The CUDA kernel's window keys, written once in torch int64 ops: the
    32-bit words of the packed tile (16 codes each, low bits first), two
    funnel shifts over words w, w+1, w+2 for the span x of window p, the
    reverse complement ~x & mask, the forward key as x's 2-bit pairs
    reversed (bit reversal, a swap of the bits of every pair, a shift
    right by word bits - 2k), and the min."""
    n = L - k + 1
    b = torch.cat([packed, packed.new_zeros(16)]).long()
    b = b[: (b.shape[0] // 4) * 4].view(-1, 4)
    words = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    p = torch.arange(n)
    w, sh = p >> 4, 2 * (p & 15)
    w0, w1, w2 = words[w], words[w + 1], words[w + 2]
    lo = (((w1 << 32) | w0) >> sh) & 0xFFFFFFFF
    hi = (((w2 << 32) | w1) >> sh) & 0xFFFFFFFF
    mask = (1 << (2 * k)) - 1
    bits = 32 if k <= pack.SINGLE_MAX_K else 64
    x = (lo if bits == 32 else (hi << 32) | lo) & mask
    y = _brev(x, bits)
    y = ((y >> 1) & 0x5555555555555555) | ((y & 0x5555555555555555) << 1)
    fwd = (y >> (bits - 2 * k)) & mask
    rc = ~x & mask
    key = torch.minimum(fwd, rc) if canonical else fwd
    if valid is not None:
        key = torch.where(valid, key, torch.full_like(key, pack.key_sentinel(k)))
    return key.to(pack.key_dtype(k))


@pytest.mark.parametrize("k", range(1, pack.MAX_K + 1))
def test_kernel_formula_equals_plain(k):
    """The funnel-shift formula of csrc/pack.cu equals
    canonical_windows_plain at every k, canonical and forward, on random
    codes and all-A / all-T runs, with the stream starting at every offset
    mod 4 (so every packed-byte phase and a ragged last byte occur), with
    and without `valid`."""
    rng = np.random.default_rng(500 + k)
    for kind in ("random", "all-A", "all-T"):
        codes = rng.integers(0, 4, 400 + k, dtype=np.uint8)
        if kind != "random":
            codes[:300] = {"all-A": 0, "all-T": 3}[kind]
        for start in range(4):
            c = codes[start:]
            L, n = c.size, c.size - k + 1
            packed = _packed(c)
            valid = torch.from_numpy(rng.random(n) > 0.1)
            for canonical in (True, False):
                for v in (valid, None):
                    got = _kernel_formula(packed, L, k, canonical, v)
                    want = pack.canonical_windows_plain(packed, L, k, canonical, v)
                    assert got.dtype == want.dtype
                    assert torch.equal(got, want), (kind, start, canonical)
