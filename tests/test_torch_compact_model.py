"""Kernel B3's single pass (kmerset_tpu_torch/csrc/compact.cu), written
once in torch ops and held against compact_select_plain and against the
Pallas compactor in interpret mode.

The CUDA kernel runs only on the card, where chip_smoke.py holds it
against the plain version.  This model repeats its schedule step by step
on the CPU, so that a slip in its index arithmetic shows here: tiles of
4096 elements; 16 keep bytes per thread, tested for nonzero bytes with the
kernel's 32-bit word arithmetic; the warp shuffle scan of the threads'
counts and the pass over the warp totals; each warp's 16-byte loads of a
lane, ranked through the owning thread's (prefix << 16 | mask) word; the
decoupled look-back over 64-bit status words under interleaved and
adversarial schedules of the tiles; and the scalar head, 16-byte body and
scalar tail of each tile's store.  All comparisons are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kmerset_tpu.ops.pallas_compact import BLOCK, compact_select_multi
from kmerset_tpu_torch.ops import compact

THREADS, PER, WARPS = 256, 16, 8
TILE = THREADS * PER
WARP_SPAN = 32 * PER
AGGREGATE, PREFIX = 1 << 62, 2 << 62
VALUE = AGGREGATE - 1


def _popc16(x: torch.Tensor) -> torch.Tensor:
    return sum((x >> j) & 1 for j in range(16))


def _nonzero4(words: torch.Tensor) -> torch.Tensor:
    """((__vcmpne4(w, 0) & 0x01010101) * 0x10204080) >> 28 on 32-bit
    words held in int64: bit j set iff byte j of w is nonzero."""
    low = torch.zeros_like(words)
    for j in range(4):
        low |= (((words >> (8 * j)) & 0xFF) != 0).long() << (8 * j)
    return ((low * 0x10204080) & 0xFFFFFFFF) >> 28


def _tile_ranks(keep8: torch.Tensor, tile: int):
    """Step 1 of one tile: the (8, 32) owner words, (exclusive rank in the
    tile << 16) | flag mask, and the tile's kept count."""
    chunk = keep8[tile * TILE : (tile + 1) * TILE].long()
    chunk = torch.cat([chunk, chunk.new_zeros(TILE - chunk.shape[0])])
    b = chunk.view(THREADS, 4, 4)  # thread, 32-bit word, byte
    words = b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24
    nz = _nonzero4(words)
    mask = (nz[:, 0] | nz[:, 1] << 4 | nz[:, 2] << 8 | nz[:, 3] << 12).view(WARPS, 32)
    count = _popc16(mask)
    incl = count.clone()
    lane = torch.arange(32)
    for o in (1, 2, 4, 8, 16):  # __shfl_up_sync
        up = torch.cat([incl.new_zeros(WARPS, o), incl[:, :-o]], 1)
        incl = incl + torch.where(lane >= o, up, 0)
    warp_total = incl[:, 31]
    before = torch.cumsum(warp_total, 0) - warp_total
    owner = ((before[:, None] + incl - count) << 16) | mask
    return owner, int(warp_total.sum())


def _stage_lane(src: torch.Tensor, tile: int, owner: torch.Tensor, n: int):
    """Step 3 for one lane: each warp's 16-byte loads, the rank of each
    loaded element from its owner's word (one __shfl_sync), and the write
    into the tile's shared-memory buffer.  Returns the buffer and which
    slots were written."""
    V = 16 // src.element_size()
    stage = torch.zeros(TILE, dtype=src.dtype)
    written = torch.zeros(TILE, dtype=torch.int64)
    lane = torch.arange(32)
    w0 = (torch.arange(WARPS) * WARP_SPAN)[:, None]
    for j in range(WARP_SPAN // (32 * V)):
        q = (j * 32 + lane) * V
        o = owner[:, q // PER]
        sub = q % PER
        r = (o >> 16) + _popc16(o & ((1 << sub) - 1))
        for i in range(V):
            g = tile * TILE + w0 + q + i
            kept = ((o >> (sub + i)) & 1) == 1
            assert not (kept & (g >= n)).any(), "a flag past n was set"
            stage[r[kept]] = src[g[kept]]
            written.index_add_(0, r[kept], torch.ones_like(r[kept]))
            r = r + kept.long()
    return stage, written


def _store_lane(out: torch.Tensor, stage: torch.Tensor, count: int, offset: int):
    """Step 5: a scalar head up to the first 16-byte boundary of the
    destination (a fresh tensor, so 16-byte aligned at element 0), 16-byte
    stores, a scalar tail; together they cover [0, count) once."""
    w = out.element_size()
    V = 16 // w
    lead = ((16 - (offset * w) % 16) % 16) // w
    head = min(lead, count)
    n_vec = (count - head) // V
    spans = [(r, r + 1) for r in range(head)]
    for qv in range(n_vec):
        r = head + qv * V
        assert ((offset + r) * w) % 16 == 0, "unaligned 16-byte store"
        spans.append((r, r + V))
    spans += [(r, r + 1) for r in range(head + n_vec * V, count)]
    assert [x for a, b in spans for x in range(a, b)] == list(range(count))
    for a, b in spans:
        out[offset + a : offset + b] = stage[a:b]


def _tile_program(t, counts, status, prefixes, rng):
    """One block's steps 2 and 4, yielding wherever the card may switch to
    another block; lanes of the look-back read their status words at
    random times, each keeping the first flagged word it sees."""
    yield  # running, nothing published yet
    status[t] = (PREFIX if t == 0 else AGGREGATE) | counts[t]
    yield
    exclusive = 0
    if t > 0:
        last = t - 1
        while True:
            w = [0] * 32
            while True:
                for lane in range(32):
                    if w[lane] >> 62 == 0 and rng.random() < 0.7:
                        i = last - lane
                        w[lane] = PREFIX if i < 0 else status[i]
                if all(x >> 62 for x in w):
                    break
                yield  # spinning on a tile with no flag yet
            stops = [lane for lane in range(32) if w[lane] >> 62 == 2]
            stop = stops[0] if stops else 31
            exclusive += sum(w[lane] & VALUE for lane in range(stop + 1))
            if stops:
                break
            last -= 32
            yield
    status[t] = PREFIX | (exclusive + counts[t])
    prefixes[t] = exclusive


def _run_schedule(counts, rng, schedule: str):
    """Every tile's exclusive prefix as its look-back found it, and the
    status words at the end.  Tiles start in index order (the kernel's
    atomic counter).  "interleaved": each step starts the next tile or
    advances a random running one.  "descending": every tile publishes its
    aggregate first, then the look-backs run from the highest tile down,
    so each walks back to tile 0 through windows of aggregates only."""
    T = len(counts)
    status, prefixes = [0] * T, [None] * T
    progs = [_tile_program(t, counts, status, prefixes, rng) for t in range(T)]
    if schedule == "descending":
        for p in progs:
            next(p), next(p)
        for p in reversed(progs):
            for _ in p:
                pass
        return prefixes, status
    running, started = [], 0
    for _ in range(200 * T * T + 1000):
        if started < T and (not running or rng.random() < 0.3):
            running.append(progs[started])
            started += 1
        p = running[int(rng.integers(len(running)))]
        try:
            next(p)
        except StopIteration:
            running.remove(p)
        if started == T and not running:
            return prefixes, status
    raise AssertionError("the schedule did not finish")


def single_pass_model(lanes, keep, rng, schedule="interleaved"):
    """compact_select's contract computed by the kernel's steps: (lanes
    out, n_sel as the last tile writes it)."""
    n = keep.shape[0]
    keep8 = keep.view(torch.uint8) if keep.dtype == torch.bool else keep
    outs = [torch.full_like(lane, -7) for lane in lanes]
    if n == 0:
        return outs, 0
    tiles = [_tile_ranks(keep8, t) for t in range(-(-n // TILE))]
    counts = [c for _, c in tiles]
    prefixes, status = _run_schedule(counts, rng, schedule)
    assert all(s >> 62 == 2 for s in status)
    for t, (owner, count) in enumerate(tiles):
        for lane, out in zip(lanes, outs):
            stage, written = _stage_lane(lane, t, owner, n)
            assert (written[:count] == 1).all() and not written[count:].any()
            _store_lane(out, stage, count, prefixes[t])
    return outs, status[-1] & VALUE


def _lanes(rng, n, kinds):
    out = []
    for kind in kinds:
        if kind == "int64":
            x = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
        else:
            x = rng.integers(-(1 << 31), (1 << 31) - 1, n, dtype=np.int32)
        out.append(torch.from_numpy(x))
    return out


def _keep(rng, n, frac, kind):
    kept = rng.random(n) < frac
    if kind == "bool":
        return torch.from_numpy(kept)
    # uint8 flags whose kept bytes hold 2..255, never 1
    return torch.from_numpy(np.where(kept, rng.integers(2, 256, n), 0).astype(np.uint8))


LANE_SETS = {
    "int32": ("int32",), "int32x2": ("int32", "int32"),
    "int32x3": ("int32",) * 3, "int64": ("int64",),
    "int64+int32": ("int64", "int32"),
}


@pytest.mark.parametrize("n", [1, 1000, TILE + 77, 5 * TILE + 3])
@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("lane_set", list(LANE_SETS))
def test_single_pass_model_equals_plain(n, frac, lane_set):
    """Ragged n (one element, below a tile, a tile and 77, no multiple of
    16), n_sel from 0 to n, every lane set the wrapper takes, bool and
    uint8 keep."""
    rng = np.random.default_rng(n + int(frac * 100) + len(lane_set))
    lanes = _lanes(rng, n, LANE_SETS[lane_set])
    for kind in ("bool", "uint8"):
        keep = _keep(rng, n, frac, kind)
        got, n_sel = single_pass_model(lanes, keep, rng)
        want, want_n = compact.compact_select_plain(lanes, keep)
        m = int(want_n)
        assert n_sel == m
        assert m == (0 if frac == 0 else n if frac == 1 else m)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            assert torch.equal(g[:m], w[:m])


@pytest.mark.parametrize("schedule", ["interleaved", "descending"])
@pytest.mark.parametrize("n_lanes", [1, 2])
def test_single_pass_model_across_many_tiles(schedule, n_lanes):
    """70 tiles, so a look-back crosses windows of 32 tiles; every fifth
    tile keeps nothing and the last keeps all."""
    n = 69 * TILE + 901
    rng = np.random.default_rng(70 + n_lanes)
    lanes = _lanes(rng, n, ("int64", "int32")[:n_lanes])
    keep = rng.random(n) < 0.4
    for t in range(0, 70, 5):
        keep[t * TILE : (t + 1) * TILE] = False
    keep[69 * TILE :] = True
    keep = torch.from_numpy(keep)
    got, n_sel = single_pass_model(lanes, keep, rng, schedule)
    want, want_n = compact.compact_select_plain(lanes, keep)
    assert n_sel == int(want_n)
    for g, w in zip(got, want):
        assert torch.equal(g[:n_sel], w[:n_sel])


@pytest.mark.parametrize("schedule", ["interleaved", "descending"])
def test_look_back_prefixes_equal_exclusive_sums(schedule):
    """The look-back alone over 150 tiles with counts from 0 to 4096:
    every tile's prefix is the sum of the counts before it."""
    rng = np.random.default_rng(150)
    counts = [int(c) for c in rng.integers(0, TILE + 1, 150)]
    counts[:40] = [0] * 40
    prefixes, status = _run_schedule(counts, rng, schedule)
    assert prefixes == [int(x) for x in np.cumsum([0] + counts[:-1])]
    assert [s & VALUE for s in status] == [int(x) for x in np.cumsum(counts)]


@pytest.mark.parametrize("n_lanes", [1, 2])
@pytest.mark.parametrize("frac", [0.0, 0.05, 0.5, 1.0])
def test_single_pass_model_matches_pallas_interpret(frac, n_lanes):
    """The reference's domain, as tests/test_torch_compact.py drives it:
    sorted keys with strictly increasing kept values, n = 2 * BLOCK."""
    n = 2 * BLOCK
    rng = np.random.default_rng(int(frac * 100) + 3)
    keys = np.sort(rng.integers(0, n // 3, n).astype(np.int32))
    keys[-77:] = (1 << 31) - 1
    keep = rng.random(n) <= frac if frac else np.zeros(n, bool)
    keep &= keys < (1 << 30)
    keep[1:] &= keys[1:] != keys[:-1]
    lanes = [keys, np.arange(n, dtype=np.int32)][:n_lanes]
    ref_lanes, ref_n = compact_select_multi(
        [jnp.asarray(x) for x in lanes], jnp.asarray(keep), 1, interpret=True
    )
    got, n_sel = single_pass_model(
        [torch.from_numpy(x) for x in lanes], torch.from_numpy(keep), rng
    )
    m = int(ref_n)
    assert n_sel == m == int(keep.sum())
    for g, r in zip(got, ref_lanes):
        np.testing.assert_array_equal(g.numpy()[:m], np.asarray(r)[:m])


def test_nonzero4_tests_every_byte_value_in_every_position():
    values = torch.arange(256)
    for j in range(4):
        got = _nonzero4(values << (8 * j))
        assert torch.equal(got, (values != 0).long() << j)
    assert int(_nonzero4(torch.tensor([0x01FF0200]))) == 0b1110


def test_tile_matches_the_kernel_source():
    """The model's tile is the kernel's and the wrapper's."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(compact.__file__), "..", "csrc",
                            "compact.cu")).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\w+);", src))
    assert int(consts["kThreads"]) == THREADS and int(consts["kPer"]) == PER
    assert compact.TILE == TILE
