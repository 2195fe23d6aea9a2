"""Kernel B3 (kmerset_tpu_torch/ops/compact.py) held against the reference.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held against that version on the card by chip_smoke.py.  The reference is
the Pallas stream compactor in interpret mode, on its own domain (sorted
keys with strictly increasing kept values, n a multiple of its BLOCK), as
tests/test_join.py drives it.  All comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerset_tpu.ops.pallas_compact import BLOCK, compact_select_multi
from kmerset_tpu_torch.ops import compact


def _sorted_heads(frac: float, n: int):
    rng = np.random.default_rng(int(frac * 100) + 3)
    keys = np.sort(rng.integers(0, n // 3, n).astype(np.int32))
    keys[-77:] = (1 << 31) - 1  # sentinel tail, as the count pipeline has
    keep = rng.random(n) <= frac if frac else np.zeros(n, bool)
    keep &= keys < (1 << 30)
    keep[1:] &= keys[1:] != keys[:-1]  # kept values strictly increasing
    return keys, keep


@pytest.mark.parametrize("n_lanes", [1, 2])
@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5, 1.0])
def test_compact_matches_pallas_interpret(frac, n_lanes):
    n = 2 * BLOCK
    keys, keep = _sorted_heads(frac, n)
    pos = np.arange(n, dtype=np.int32)
    lanes = [keys, pos][:n_lanes]
    ref_lanes, ref_n = compact_select_multi(
        [jnp.asarray(x) for x in lanes], jnp.asarray(keep), 1, interpret=True
    )
    got, n_sel = compact.compact_select(
        [torch.from_numpy(x) for x in lanes], torch.from_numpy(keep)
    )
    m = int(ref_n)
    assert int(n_sel) == m == int(keep.sum())
    for g, r in zip(got, ref_lanes):
        np.testing.assert_array_equal(g.numpy()[:m], np.asarray(r)[:m])


@pytest.mark.parametrize("n", [0, 1, 2047, 5011])
def test_compact_any_length_and_order(n):
    """Beyond the reference's domain: unsorted lanes, three of them, and
    lengths that are no multiple of a block."""
    rng = np.random.default_rng(n)
    lanes = [rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
             for _ in range(3)]
    keep = rng.random(n) < 0.3
    got, n_sel = compact.compact_select(
        [torch.from_numpy(x) for x in lanes],
        torch.from_numpy(keep.astype(np.uint8)),
    )
    assert int(n_sel) == int(keep.sum())
    for g, x in zip(got, lanes):
        assert g.shape == (n,)
        np.testing.assert_array_equal(g.numpy()[: int(n_sel)], x[keep])


def test_compact_rejects_bad_inputs():
    keep = torch.ones(8, dtype=torch.bool)
    lane = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        compact.compact_select([], keep)
    with pytest.raises(ValueError):
        compact.compact_select([lane] * 4, keep)
    with pytest.raises(TypeError):
        compact.compact_select([lane.to(torch.int16)], keep)
    with pytest.raises(TypeError):
        compact.compact_select([lane[:4]], keep)
    with pytest.raises(TypeError):
        compact.compact_select([lane], keep.int())


@pytest.mark.parametrize("frac", [0.0, 0.5, 1.0])
def test_compact_int64_lane_beside_int32(frac):
    """The k = 19/23 count compacts [int64 key, int32 position]; each lane
    keeps its dtype and equals lane[keep], full-width int64 values
    included."""
    n = 6007
    rng = np.random.default_rng(int(frac * 10) + 40)
    key = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    key[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 1 << 62]
    pos = np.arange(n, dtype=np.int32)
    keep = rng.random(n) < frac
    keep[:3] = frac > 0
    got, n_sel = compact.compact_select(
        [torch.from_numpy(key), torch.from_numpy(pos)], torch.from_numpy(keep)
    )
    assert int(n_sel) == int(keep.sum())
    assert [g.dtype for g in got] == [torch.int64, torch.int32]
    m = int(n_sel)
    np.testing.assert_array_equal(got[0].numpy()[:m], key[keep])
    np.testing.assert_array_equal(got[1].numpy()[:m], pos[keep])


@pytest.mark.parametrize("lanes_kind", ["int32", "int64+int32", "int32x3"])
@pytest.mark.parametrize("shift", ["keep", "lanes", "both"])
def test_compact_takes_offset_views(lanes_kind, shift):
    """Views at element offset 1 (not 16-byte aligned on the card, where
    the kernel reads them element by element) are legal input; uint8 keep
    bytes other than 0 and 1 count as kept."""
    n = 5011
    rng = np.random.default_rng(len(lanes_kind) + len(shift))
    dtypes = {"int32": [np.int32], "int64+int32": [np.int64, np.int32],
              "int32x3": [np.int32] * 3}[lanes_kind]
    full = [rng.integers(-(1 << 31), (1 << 31) - 1, n + 1).astype(d) for d in dtypes]
    flags = np.where(rng.random(n + 1) < 0.4, rng.integers(1, 256, n + 1), 0)
    keep_full = torch.from_numpy(flags.astype(np.uint8))
    keep = keep_full[1:] if shift in ("keep", "both") else keep_full[:n]
    lanes = [torch.from_numpy(x)[1:] if shift in ("lanes", "both")
             else torch.from_numpy(x)[:n] for x in full]
    assert all(t.is_contiguous() for t in (*lanes, keep))
    got, n_sel = compact.compact_select(lanes, keep)
    mask = keep.numpy() != 0
    assert int(n_sel) == int(mask.sum())
    for g, x in zip(got, lanes):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g.numpy()[: int(n_sel)], x.numpy()[mask])
