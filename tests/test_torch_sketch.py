"""The port's sketch table (kmerset_tpu_torch/ops/sketch.py) against the
reference's DeviceSketchTable (JAX on the CPU) and the host
intersection_size, on the CPU.  Pair weights are exact int64 counts.
"""

import numpy as np
import pytest

from kmerset_tpu.core.kmer_set import intersection_size
from kmerset_tpu.ops.sketch import DeviceSketchTable as RefTable
from kmerset_tpu_torch.ops import backend, sketch
from kmerset_tpu_torch.ops.pack import SENTINEL
from kmerset_tpu_torch.ops.sketch import DeviceSketchTable


def _sketches(seed: int, n: int, size: int):
    """Related sorted sketches (a shared core plus private keys), an
    empty one, and one holding a key at the top of the 46-bit range."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 1 << 30, size)
    out = []
    for i in range(n):
        own = rng.integers(0, 1 << 30, int(rng.integers(0, size)))
        keep = core[rng.random(size) < rng.random()]
        out.append(np.unique(np.concatenate([keep, own])).astype(np.int64))
    out[1] = np.empty(0, np.int64)
    out[2] = np.append(out[2], (1 << 46) - 1)
    return out


def _all_pairs(n: int):
    return [(i, j) for i in range(n) for j in range(i + 1, n)]


def _host(sketches, pairs):
    return np.array([intersection_size(sketches[i], sketches[j])
                     for i, j in pairs], np.int64)


def test_pair_weights_match_reference_and_host():
    sk = _sketches(1, 9, 300)
    pairs = _all_pairs(9) + [(3, 3), (5, 0)]
    port = DeviceSketchTable(sk, device="cpu")
    got = port.pair_weights(pairs)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, RefTable(sk).pair_weights(pairs))
    np.testing.assert_array_equal(got, _host(sk, pairs))
    assert got[pairs.index((3, 3))] == sk[3].size
    assert (got[[p[0] == 1 or p[1] == 1 for p in pairs]] == 0).all()
    assert port.rows.shape == (9, max(s.size for s in sk))
    assert port.pair_weights([]).shape == (0,)


def test_set_row_and_append_past_capacity_match_reference():
    sk = _sketches(2, 3, 200)
    port, ref = DeviceSketchTable(sk, device="cpu"), RefTable(sk)
    cur = list(sk)
    rng = np.random.default_rng(3)
    for step in range(6):  # appends double the port's capacity twice
        new = np.unique(rng.choice(np.concatenate(cur), 150))
        assert port.append_row(new) == ref.append_row(new) == len(cur)
        cur.append(new)
        j = int(rng.integers(0, len(cur)))
        cur[j] = cur[j][rng.random(cur[j].size) < 0.5] if step % 2 else np.empty(0, np.int64)
        port.set_row(j, cur[j])
        ref.set_row(j, cur[j])
        pairs = _all_pairs(len(cur))
        want = _host(cur, pairs)
        np.testing.assert_array_equal(port.pair_weights(pairs), want)
        np.testing.assert_array_equal(ref.pair_weights(pairs), want)
    assert port.n == len(cur) and (port.rows[:, -1] == SENTINEL).any()


def test_bad_rows_raise():
    sk = _sketches(4, 4, 50)
    port = DeviceSketchTable(sk, device="cpu")
    wide = np.arange(0, 3 * (port.S + 1), 3, dtype=np.int64)
    with pytest.raises(ValueError, match="capacity"):
        port.set_row(0, wide)
    ref = RefTable(sk)
    with pytest.raises(ValueError, match="capacity"):
        ref.set_row(0, np.arange(0, 3 * (ref.S + 1), 3, dtype=np.int64))
    with pytest.raises(IndexError):
        port.set_row(4, sk[0])
    with pytest.raises(IndexError):
        port.pair_weights([(0, 4)])
    empty = DeviceSketchTable([], device="cpu")
    assert empty.append_row(wide[:1]) == 0
    assert empty.pair_weights([(0, 0)]).tolist() == [1]


def test_batches_split_by_the_memory_budget(monkeypatch):
    sk = _sketches(5, 12, 400)
    pairs = _all_pairs(12)
    port = DeviceSketchTable(sk, device="cpu")
    want = port.pair_weights(pairs)
    assert port.batch_pairs() >= len(pairs)
    per_pair = sketch._BYTES_PER_PAIR_SLOT * port.S
    monkeypatch.setattr(backend, "memory_budget", lambda device: 7 * per_pair)
    assert port.batch_pairs() == 7
    calls = []
    orig = sketch._row_intersections
    monkeypatch.setattr(
        sketch, "_row_intersections",
        lambda a, b: calls.append(a.shape[0]) or orig(a, b),
    )
    np.testing.assert_array_equal(port.pair_weights(pairs), want)
    assert calls == [7] * (len(pairs) // 7) + [len(pairs) % 7]
    np.testing.assert_array_equal(want, _host(sk, pairs))
