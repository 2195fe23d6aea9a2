"""The port's gap-encoded key downloads (kmerset_tpu_torch/ops/deltas.py)
against the reference's (kmerset_tpu/ops/deltas.py).

The same keys, made from a numpy seed, go through the reference's encode
jit (XLA on the CPU) and the port's torch encode (its exception rows
compacted by kernel B3's plain version on the CPU): the wire arrays must
be equal element for element.  plan_escape must equal the reference's
wherever the reference's plan is sound; where it is not (the
cancellation at k = 27 to 31, and the 4-8 B/key band at k <= 15) the
port's divergence is pinned, with the reference's plan shown to overflow
or to cost more than the port's raw download.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kmerset_tpu.core import native as ref_native
from kmerset_tpu.core.kmer_counter import KmerCounter as RefCounter
from kmerset_tpu.ops import deltas as ref_deltas
from kmerset_tpu_torch.core import native
from kmerset_tpu_torch.core.kmer_counter import KmerCounter
from kmerset_tpu_torch.ops import backend, deltas
from kmerset_tpu_torch.ops.pack import SINGLE_MAX_K, key_dtype


def _keys(case: str, rng) -> np.ndarray:
    """Sorted unique non-negative int64 keys under 2^30 of one shape."""
    if case == "escapes":  # small gaps with scattered jumps of both widths
        gaps = rng.integers(1, 200, size=30_000)
        gaps[rng.integers(0, 30_000, size=400)] += 300
        gaps[rng.integers(0, 30_000, size=100)] += 70_000
    elif case == "big_first":  # the first key itself overflows
        gaps = np.concatenate([[1 << 28], rng.integers(1, 50, size=20_000)])
    elif case == "over_cap":  # more overflows than the table's rows
        gaps = rng.integers(250, 80_000, size=6_000)
    else:  # "short": fewer keys than the table's rows
        gaps = rng.integers(1, 100_000, size=300)
    return np.cumsum(gaps).astype(np.int64)


def _ref_encode(vals: np.ndarray, esc: int, cap: int, narrow: bool):
    import jax.numpy as jnp

    dsmall, exc = ref_deltas._build_encode()(
        jnp.asarray(vals), vals.shape[0], esc, cap, narrow
    )
    return np.asarray(dsmall), np.asarray(exc)


@pytest.mark.parametrize("case", ["escapes", "big_first", "over_cap", "short"])
@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("esc", [255, 65535])
def test_wire_arrays_equal_reference(case, narrow, esc):
    """dsmall and exc (rows, sentinel padding, min(n, cap) rows, the
    (n_over, last) tail row, int32 when narrow) equal the reference
    encode's, element for element."""
    vals = _keys(case, np.random.default_rng(len(case) * 7 + esc + narrow))
    cap = 1024
    keys = torch.from_numpy(vals.astype(np.int32) if narrow else vals)
    dsmall, exc = deltas.encode(keys, vals.shape[0], esc, cap, narrow)
    got_d = dsmall.numpy() if esc == 255 else dsmall.numpy().view(np.uint16)
    want_d, want_exc = _ref_encode(vals, esc, cap, narrow)
    assert got_d.dtype == want_d.dtype
    np.testing.assert_array_equal(got_d, want_d)
    assert exc.numpy().dtype == want_exc.dtype
    np.testing.assert_array_equal(exc.numpy(), want_exc)
    assert exc.shape[0] == min(vals.shape[0], cap) + 1


def _wire(n: int, plan) -> int:
    esc, cap, narrow = plan
    return n * (1 if esc == 255 else 2) + cap * (8 if narrow else 16)


@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("k", [9, 11, 13, 15, 17, 19, 21, 23])
def test_plan_escape_equals_reference(k, canonical):
    """Over n from 2^8 to 2^27 the port's plan is the reference's, except
    where k <= SINGLE_MAX_K and the reference's plan costs 4 B/key or more:
    the port's raw download of int32 keys costs 4, so there it has none."""
    banded = 0
    for e in range(8, 28):
        for n in (1 << e, 3 << (e - 1)):
            want = ref_deltas.plan_escape(n, k, canonical)
            if want is not None and k <= SINGLE_MAX_K and _wire(n, want) >= 4 * n:
                banded += 1
                want = None
            assert deltas.plan_escape(n, k, canonical) == want, (n, k)
            assert deltas.expected_escape(n, k, canonical) == (
                None if want is None else want[0])
    assert (banded > 0) == (k <= SINGLE_MAX_K)


@pytest.mark.parametrize("k", [27, 29, 31])
def test_plan_escape_without_cancellation(k):
    """The reference's canonical expectation cancels to 0 for tiny a, so its
    plan is (255, CAP, False) at k = 27-31 where nearly every gap
    overflows (reference deltas.py:142); the port's expectation tends to n
    there, so it plans none.  The reference's plan overflows on a real
    set: its encode counts more overflows than its table holds, and its
    fetch returns None (the raw download after a wasted encode)."""
    ns = [n for n in (1 << 18, 1 << 20, 1 << 22, 1 << 24, 1 << 26)
          if ref_deltas.plan_escape(n, k, True) is not None]
    assert ns
    for n in ns:
        assert ref_deltas.plan_escape(n, k, True) == (255, ref_deltas.CAP, False)
        assert deltas.plan_escape(n, k, True) is None
        assert deltas.expected_overflows(n, k, True, 255) > 0.99 * n
    import jax.numpy as jnp

    from kmerset_tpu_torch.core import kmer as kmer_ops

    rng = np.random.default_rng(k)
    n = ns[0]
    raw = rng.integers(0, 1 << (2 * k), size=n + n // 8, dtype=np.int64)
    vals = np.unique(kmer_ops.canonical(raw, k))[:n]
    n = vals.shape[0]
    assert ref_deltas.plan_escape(n, k, True) == (255, ref_deltas.CAP, False)
    _, exc = _ref_encode(vals, 255, ref_deltas.CAP, False)
    assert exc[-1, 0] > ref_deltas.CAP
    assert ref_deltas.device_delta_download(jnp.asarray(vals), n, k, True) is None


@pytest.mark.parametrize("k", [9, 13, 15])
def test_plan_escape_band_at_int32_keys(k):
    """Where the reference's plan costs between 4 and 8 B/key at k <=
    SINGLE_MAX_K it still beats its 8 B/key yardstick (deltas.py:152), but
    costs more than the port's raw download of int32 keys: the port plans
    none."""
    n = 131072
    want = ref_deltas.plan_escape(n, k, True)
    assert want is not None and 4 * n <= _wire(n, want) < 8 * n
    assert deltas.raw_key_bytes(k) == 4
    assert deltas.plan_escape(n, k, True) is None


def test_narrow_rows_and_raw_bytes_key_on_the_key_width():
    """narrow (int32 rows) and the raw download's bytes follow the count's
    key dtype, int32 through SINGLE_MAX_K (the reference tests a literal
    k <= 15, deltas.py:148)."""
    for k in range(1, 32):
        width = torch.tensor([], dtype=key_dtype(k)).element_size()
        assert deltas.raw_key_bytes(k) == width
        plan = deltas.plan_escape(1 << 26, k, False)
        if plan is not None:
            assert plan[2] == (k <= SINGLE_MAX_K)


def test_cap_class_equals_reference():
    for c in [*range(1, 5000), 65536, 65537, (3 << 15) + 1, 749_000, 1 << 21]:
        assert deltas._cap_class(c) == ref_deltas._cap_class(c), c


@pytest.mark.parametrize("width", ["u8", "u16", "out_of_order"])
def test_native_delta_decode_equals_reference(width):
    """The port's binding of kmerio_delta_decode returns what the
    reference's does on the same library, rejections included."""
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(23)
    gaps = rng.integers(1, 200, size=10_000).astype(np.int64)
    gaps[rng.choice(10_000, size=40, replace=False)] += 70_000
    esc = 255 if width != "u16" else 65535
    d = np.minimum(gaps, esc).astype(np.uint8 if esc == 255 else np.uint16)
    idx = np.flatnonzero(gaps >= esc)
    exc = np.stack([idx, gaps[idx]], axis=1).astype(np.int64)
    if width == "out_of_order":
        exc = exc[::-1].copy()
    got = native.delta_decode(d, exc, exc.shape[0])
    want = ref_native.delta_decode(d, exc, exc.shape[0])
    if width == "out_of_order":
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.cumsum(gaps))
    # int32 rows (the narrow table) decode alike.
    if width == "u8":
        np.testing.assert_array_equal(
            native.delta_decode(d, exc.astype(np.int32), exc.shape[0]), got)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(deltas, "rejections", dict.fromkeys(deltas.rejections, 0))
    monkeypatch.setattr(deltas, "downloads", 0)


@pytest.mark.parametrize("decoder", ["native", "numpy"])
def test_fetch_roundtrip(monkeypatch, counters, decoder):
    """fetch_delta's keys equal the encoded ones through the native decode
    and its numpy edition (no library)."""
    if decoder == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    vals = _keys("escapes", np.random.default_rng(3))
    n = vals.shape[0]
    pending = deltas.Pending(*deltas.encode(torch.from_numpy(vals), n, 255, 4096, False), 255)
    np.testing.assert_array_equal(deltas.fetch_delta(pending, n), vals)
    assert deltas.downloads == 1 and not any(deltas.rejections.values())


def test_fetch_rejects_overflow_and_integrity(counters):
    """More overflows than rows, or a tail row whose last key differs from
    the decode's, is a rejection: None, counted by reason."""
    vals = _keys("over_cap", np.random.default_rng(4))
    n = vals.shape[0]
    keys = torch.from_numpy(vals)
    assert deltas.fetch_delta(deltas.Pending(*deltas.encode(keys, n, 255, 64, False), 255), n) is None
    assert deltas.rejections["overflow"] == 1
    dsmall, exc = deltas.encode(keys, n, 65535, 8192, False)
    exc[-1, 1] += 1
    assert deltas.fetch_delta(deltas.Pending(dsmall, exc, 65535), n) is None
    assert deltas.rejections["integrity"] == 1 and deltas.downloads == 0


def _reads(rng, n_reads: int, length: int):
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, length)) for _ in range(n_reads)]


@pytest.mark.parametrize("link", ["slow", "fast"])
def test_device_count_gap_encoded_equals_reference(monkeypatch, counters, link):
    """On a slow link a dense count's keys come down gap-encoded (the plan
    holds at k = 11 with 2^18 keys); keys and counts equal the reference's
    host count either way."""
    monkeypatch.setattr(backend, "_slow_link", lambda device: link == "slow")
    monkeypatch.setattr(backend, "DELTA_MIN_KEYS", 1 << 10)
    k = 11
    reads = _reads(np.random.default_rng(11), 60, 8000)
    got = KmerCounter.from_reads(k, reads, True, device="cpu")
    assert deltas.downloads == (link == "slow")
    assert not any(deltas.rejections.values())
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    want = RefCounter.from_reads(k, reads, True)
    np.testing.assert_array_equal(got.kmers, want.kmers)
    np.testing.assert_array_equal(got.counts, want.counts)


def test_device_count_rejected_plan_takes_the_raw_download(monkeypatch, counters):
    """A sparse set has no plan: the rejection is counted and the raw
    download gives the same keys."""
    monkeypatch.setattr(backend, "_slow_link", lambda device: True)
    monkeypatch.setattr(backend, "DELTA_MIN_KEYS", 1)
    reads = _reads(np.random.default_rng(12), 20, 300)
    got = KmerCounter.from_reads(23, reads, True, device="cpu")
    assert deltas.rejections["plan"] == 1 and deltas.downloads == 0
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    np.testing.assert_array_equal(got.kmers, RefCounter.from_reads(23, reads, True).kmers)
