"""Kernel W1's plain version (ops/walk.py) against the host walk of the
native library, and the canonical build's routing between the two.

The host walk is composed here as core/spss.py runs it: the mirror-dedup
chain walk (native.chain_walk_kept with the reference's skip rule), the
chains' and the isolated k-mers' emission (native.emit_kmer_chains) and
the leftover-cycle walk (native.walk_cycles).  W1's plain version, on CPU
tensors of the front-end's own arrays (ops/unitigs.unitig_succ), must
give the same code bytes and offsets, and the JAX package's host build
(kmerset_tpu.core.spss, the reference) the same strings again; or W1
refuses (None) exactly where it cannot promise them, and the build then
raises.
"""

import json
import logging

import numpy as np
import pytest
import torch

from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu_torch.core import kmer, native, spss
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.core.strings import PackedStrings
from kmerset_tpu_torch.ops import backend, unitigs
from kmerset_tpu_torch.ops import walk
from kmerset_tpu_torch.parallel.mesh import Mesh
from kmerset_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _native_library(monkeypatch):
    assert native.get_lib() is not None, "the host walk under test is the native one"
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


def _kmer_set(k: int, seed: int, frags: int = 300, isolated: int = 0,
              cycles: int = 0) -> np.ndarray:
    """Sorted canonical k-mers of random fragments (one chain each), SNP
    variants of a quarter of them (bubbles, so chains branch), `isolated`
    lone k-mers and `cycles` circular sequences (pure cycles)."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, int(rng.integers(k + 1, k + 120)))
            for _ in range(frags)]
    for s in seqs[: frags // 4]:
        v = s.copy()
        i = int(rng.integers(0, v.shape[0]))
        v[i] = (v[i] + 1) % 4
        seqs.append(v)
    seqs += [rng.integers(0, 4, k) for _ in range(isolated)]
    for _ in range(cycles):
        c = rng.integers(0, 4, int(rng.integers(40, 120)))
        seqs.append(np.concatenate([c, c[: k - 1]]))
    kmers = np.concatenate([kmer.kmers_from_codes(s, k) for s in seqs])
    return np.unique(kmer.canonical(kmers, k))


def _front(A: np.ndarray, k: int):
    return unitigs.unitig_succ(torch.from_numpy(A), k)


def _host_strings(A, k, succ, term_l, term_r, both):
    """The native host walk's strings (core/spss.py's host path), or None
    where native.chain_walk_kept refuses succ."""
    succ, term_l, term_r, both = (np.asarray(x) for x in (succ, term_l, term_r, both))
    starts = np.concatenate([np.flatnonzero(term_l & ~term_r) * 2,
                             np.flatnonzero(term_r & ~term_l) * 2 + 1])
    kept = native.chain_walk_kept(succ, starts, lambda s, e: A[s >> 1] >= A[e >> 1])
    if kept is None:
        return None
    nodes, groups = kept
    parts = []
    if nodes.size:
        parts.append(PackedStrings(*native.emit_kmer_chains(A, k, nodes, groups, True)))
    iso = np.flatnonzero(both)
    if iso.size:
        parts.append(PackedStrings(*native.emit_kmer_chains(
            A, k, 2 * iso, np.arange(iso.size + 1), True)))
    visited = np.zeros(A.shape[0], dtype=bool)
    visited[nodes >> 1] = True
    visited[iso] = True
    parts.append(PackedStrings(*native.walk_cycles(succ, A, k, True, visited)))
    return spss._concat_packed(parts)


def _w1_strings(A, k, succ, term_l, term_r, both):
    """The same strings through W1's plain version, the cycles left to
    native.walk_cycles as the caller does; None where W1 refuses."""
    At = torch.from_numpy(A)
    ch = walk.chain_walk(succ, term_l, term_r, At, k)
    if ch is None:
        return None
    out = walk.emit_strings(ch, succ, both, At, k)
    if out is None:
        return None
    parts = [PackedStrings(out.codes.numpy(), out.offsets.numpy())]
    if out.n_covered < A.shape[0]:
        visited = out.covered.numpy().astype(bool)
        parts.append(PackedStrings(*native.walk_cycles(
            succ.numpy(), A, k, True, visited)))
    return spss._concat_packed(parts)


def _equal(got: PackedStrings, want: PackedStrings) -> None:
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.codes, want.codes)


@pytest.mark.parametrize("k", [15, 19, 23, 31])
@pytest.mark.parametrize("shape", ["random", "isolated", "cycles"])
def test_plain_walk_equals_host_walk(k, shape):
    A = _kmer_set(k, seed=k, isolated=40 if shape == "isolated" else 0,
                  cycles=6 if shape == "cycles" else 0)
    front = _front(A, k)
    want = _host_strings(A, k, *front)
    got = _w1_strings(A, k, *front)
    _equal(got, want)
    _equal(got, ref_spss.get_unitigs_canonical(RefKmerSet(k, A, _sorted=True)))
    if shape == "isolated":
        assert int(front[3].sum()) >= 40
    if shape == "cycles":
        # The chains and isolated k-mers leave entities for the host.
        ch = walk.chain_walk(*front[:3], torch.from_numpy(A), k)
        out = walk.emit_strings(ch, front[0], front[3], torch.from_numpy(A), k)
        assert out.n_covered < A.shape[0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_mirrors_in_one_batch_and_across_batches(seed):
    """Over 64 starts; some mirror pairs share a 64-lane batch (the lower
    lane records) and some do not (the earlier batch records)."""
    k = 15
    A = _kmer_set(k, seed=100 + seed, frags=400)
    succ, term_l, term_r, both = _front(A, k)
    starts, n_right = walk.starts_of(term_l, term_r)
    assert starts.shape[0] > 4 * walk.LANES
    bad = torch.zeros(1, dtype=torch.int32)
    ends, _ = walk.measure(succ, starts, bad)
    pm = walk._mirror_positions(starts, n_right, ends)
    p = torch.arange(starts.shape[0])
    paired = pm >= 0
    same = paired & (pm // walk.LANES == p // walk.LANES) & (pm != p)
    assert bool(same.any()) and bool((paired & ~same & (pm != p)).any())
    _equal(_w1_strings(A, k, succ, term_l, term_r, both),
           _host_strings(A, k, succ, term_l, term_r, both))


def test_length_one_chains_and_orphan_starts():
    """Hand-made arrays: starts whose chain is one node, starts whose
    mirror is no start, a two-node chain kept in its mirror's
    orientation."""
    k = 15
    A = np.array([5, 9, 12, 40, 41], dtype=np.int64)
    term_l = torch.tensor([True, True, False, True, False])
    term_r = torch.tensor([False, True, True, False, True])
    succ = torch.full((10,), -1, dtype=torch.int64)
    succ[6], succ[9] = 8, 7  # 3 -> 4 and its mirror, kept: A[3] < A[4]
    both = term_l & term_r
    want = _host_strings(A, k, succ, term_l, term_r, both)
    _equal(_w1_strings(A, k, succ, term_l, term_r, both), want)
    assert (np.diff(want.offsets) == k).any()


def test_empty_arrays():
    k = 15
    A = np.empty(0, dtype=np.int64)
    empty = torch.empty(0, dtype=torch.bool)
    succ = torch.empty(0, dtype=torch.int64)
    ch = walk.chain_walk(succ, empty, empty, torch.from_numpy(A), k)
    assert ch.n_chains == 0 and ch.chain_bytes == 0
    out = walk.emit_strings(ch, succ, empty, torch.from_numpy(A), k)
    assert out.codes.numel() == 0 and out.offsets.tolist() == [0]
    assert out.n_covered == 0


def _cycle_from_start():
    """A start whose walk enters a cycle: both walks refuse it."""
    A = np.array([3, 7, 11], dtype=np.int64)
    term_l = torch.tensor([True, False, False])
    term_r = torch.tensor([False, False, False])
    succ = torch.full((6,), -1, dtype=torch.int64)
    succ[0], succ[2], succ[4] = 2, 4, 2
    return A, succ, term_l, term_r, term_l & term_r


def _unpaired_mirrors():
    """Two starts that are not each other's mirrors: the host walk emits
    entity 1 twice; W1 refuses, so that the caller takes the host walk."""
    A = np.array([3, 7], dtype=np.int64)
    term_l = torch.tensor([True, False])
    term_r = torch.tensor([False, True])
    succ = torch.full((4,), -1, dtype=torch.int64)
    succ[0] = 2
    return A, succ, term_l, term_r, term_l & term_r


@pytest.mark.parametrize("case", [_cycle_from_start, _unpaired_mirrors])
def test_broken_chain_contract_is_refused(case):
    A, succ, term_l, term_r, both = case()
    assert _w1_strings(A, 15, succ, term_l, term_r, both) is None
    if case is _cycle_from_start:
        assert _host_strings(A, 15, succ, term_l, term_r, both) is None


def _counts():
    c = trace.counts()
    return c.get("walk.device", 0), c.get("walk.host", 0)


def _host_budget(monkeypatch, budget: int = backend.HOST_BUDGET):
    """backend.memory_budget reading `budget` on every device, as the CPU
    reads HOST_BUDGET (torch.cuda's free memory is not there to read)."""
    monkeypatch.setattr(backend, "memory_budget", lambda device: budget)


def _as_cuda_route(monkeypatch, min_kmers: int):
    """backend.walk_route with the CPU taken for a CUDA device, from
    min_kmers k-mers: the device walk's route on CPU tensors (W1's plain
    version)."""
    real = backend.walk_route
    _host_budget(monkeypatch)
    monkeypatch.setattr(backend, "WALK_MIN_KMERS", min_kmers)
    monkeypatch.setattr(backend, "walk_route", lambda n, device: real(n, "cuda"))


@pytest.mark.parametrize("k", [15, 23])
@pytest.mark.parametrize("shape", ["random", "cycles"])
def test_build_on_the_device_route_equals_the_host_route(monkeypatch, k, shape):
    ks = KmerSet(k, _kmer_set(k, seed=7 * k, isolated=10,
                              cycles=5 if shape == "cycles" else 0), _sorted=True)
    d0, h0 = _counts()
    want = spss.get_unitigs_canonical(ks, device="cpu")
    want_spss = spss.get_spss_canonical(ks, device="cpu")
    assert _counts() == (d0, h0 + 2)
    _as_cuda_route(monkeypatch, ks.size())
    got = spss.get_unitigs_canonical(ks, device="cpu")
    assert _counts() == (d0 + 1, h0 + 2)
    _equal(got, want)
    _equal(spss.get_spss_canonical(ks, device="cpu"), want_spss)
    ref = RefKmerSet(k, ks.kmers, _sorted=True)
    _equal(got, ref_spss.get_unitigs_canonical(ref))
    _equal(want_spss, ref_spss.get_spss_canonical(ref))


@pytest.mark.parametrize("below", [1, 1000])
def test_sets_below_the_size_constant_keep_the_host_walk(monkeypatch, below):
    ks = KmerSet(15, _kmer_set(15, seed=5), _sorted=True)
    _as_cuda_route(monkeypatch, ks.size() + below)
    d0, h0 = _counts()
    spss.get_unitigs_canonical(ks, device="cpu")
    assert _counts() == (d0, h0 + 1)


def test_walk_route_reads_the_constant_and_the_device(monkeypatch):
    """The route holds on CUDA from WALK_MIN_KMERS k-mers up to the walk's
    own ceiling, WALK_BYTES_PER_KMER per k-mer within half the budget:
    above the front-end's one-shot ceiling too (its bounded mode keeps
    the rows on the device); a budget whose walk ceiling is below the set
    keeps the host walk."""
    _host_budget(monkeypatch)
    n = backend.WALK_MIN_KMERS
    assert backend.walk_route(n, "cuda")
    assert backend.walk_route(n, torch.device("cuda:0"))
    assert not backend.walk_route(n - 1, "cuda")
    assert not backend.walk_route(n, "cpu")
    small = backend.FRONT_END_BYTES_PER_KMER * n  # front-end ceiling n / 2
    assert backend.front_end_plan(n, small)[0]
    assert backend.walk_ceiling(small) >= n
    _host_budget(monkeypatch, small)
    assert backend.walk_route(n, "cuda")
    tight = 2 * backend.WALK_BYTES_PER_KMER * n
    assert backend.walk_ceiling(tight) == n
    _host_budget(monkeypatch, tight - 1)
    assert not backend.walk_route(n, "cuda")
    _host_budget(monkeypatch, tight)
    assert backend.walk_route(n, "cuda")
    monkeypatch.setattr(backend, "WALK_BYTES_PER_KMER",
                        backend.WALK_BYTES_PER_KMER + 1)
    assert not backend.walk_route(n, "cuda")


@pytest.fixture
def trace_lines():
    """The "kmerset" logger at debug level, its messages captured; its
    handlers, level and propagation restored afterwards."""
    log = logging.getLogger("kmerset")
    saved = log.handlers[:], log.level, log.propagate
    lines = []

    class Capture(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log.handlers = [Capture(logging.DEBUG)]
    log.setLevel(logging.DEBUG)
    log.propagate = False
    try:
        yield lines
    finally:
        log.handlers, log.propagate = saved[0], saved[2]
        log.setLevel(saved[1])


def _traced(lines, fn):
    """fn() inside a traced call: its result and the call's trace line."""
    with trace.root("cli.test", True):
        out = fn()
    found = [m for m in lines if m.startswith(trace.PREFIX)]
    assert len(found) == 1
    lines.clear()
    return out, json.loads(found[0][len(trace.PREFIX):])


def _bounded_walk_budget(monkeypatch, n: int) -> int:
    """A budget whose front-end ceiling is below n and whose walk ceiling
    is not, read on every device."""
    budget = (backend.FRONT_END_BYTES_PER_KMER + backend.WALK_BYTES_PER_KMER) * n
    assert backend.front_end_ceiling(budget) < n <= backend.walk_ceiling(budget)
    _host_budget(monkeypatch, budget)
    return budget


@pytest.mark.parametrize("k", [15, 23])
def test_a_set_above_the_front_end_ceiling_walks_on_the_device(
        monkeypatch, trace_lines, k):
    """A set above the front-end's one-shot ceiling and under the walk's:
    the bounded front-end keeps its rows on the device and W1 walks them,
    with the strings of the host route; the front_end.plan span states
    the plan, and front_end.bounded and walk.bounded count the set."""
    ks = KmerSet(k, _kmer_set(k, seed=13 * k, isolated=10, cycles=3), _sorted=True)
    n = ks.size()
    want = spss.get_unitigs_canonical(ks, device="cpu")
    _as_cuda_route(monkeypatch, n)
    budget = _bounded_walk_budget(monkeypatch, n)
    bounded = []
    real = unitigs.bounded_unitig_succ
    monkeypatch.setattr(unitigs, "bounded_unitig_succ",
                        lambda *a: bounded.append(a[3:]) or real(*a))
    d0, h0 = _counts()
    got, line = _traced(trace_lines,
                        lambda: spss.get_unitigs_canonical(ks, device="cpu"))
    assert _counts() == (d0 + 1, h0) and bounded == [(True,)]
    _equal(got, want)
    _equal(got, ref_spss.get_unitigs_canonical(RefKmerSet(k, ks.kmers, _sorted=True)))
    plans = [s for s in line["spans"] if s["name"] == "front_end.plan"]
    q = backend.front_end_plan(n, budget, keep=True)[1]
    assert [p["attrs"] for p in plans] == [{
        "kmers": n, "ceiling": backend.front_end_ceiling(budget),
        "budget": budget, "mode": "bounded", "walk": "device",
        "query_chunk": q, "query_chunks": -(-n // q)}]
    assert line["counters"]["front_end.bounded"] == 1
    assert line["counters"]["walk.bounded"] == 1
    assert line["counters"]["walk.device"] == 1
    assert not any(s["name"] == "front_end.download" for s in line["spans"])


@pytest.mark.parametrize("walk", ["device", "host"])
@pytest.mark.parametrize("mode", ["one-shot", "bounded"])
def test_the_plan_span_and_counters_of_each_route(monkeypatch, trace_lines,
                                                  mode, walk):
    """One front_end.plan span per front-end call, with its mode, walk and
    query chunks; front_end.bounded counts the bounded calls and
    walk.bounded the sets W1 walked from them, nothing else; the bounded
    mode's two passes have a span each, and front_end.query_chunks counts
    the side-table builds of every pass."""
    ks = KmerSet(15, _kmer_set(15, seed=41), _sorted=True)
    n = ks.size()
    if walk == "device":
        _as_cuda_route(monkeypatch, n)
    if mode == "bounded":
        budget = _bounded_walk_budget(monkeypatch, n)
    else:
        budget = backend.HOST_BUDGET
        _host_budget(monkeypatch, budget)
    _, line = _traced(trace_lines,
                      lambda: spss.get_unitigs_canonical(ks, device="cpu"))
    plans = [s["attrs"] for s in line["spans"] if s["name"] == "front_end.plan"]
    q = backend.front_end_plan(n, budget, keep=walk == "device")[1]
    assert plans == [{"kmers": n, "ceiling": backend.front_end_ceiling(budget),
                      "budget": budget, "mode": mode, "walk": walk,
                      "query_chunk": q, "query_chunks": -(-n // q)}]
    c = line["counters"]
    assert c.get("front_end.bounded", 0) == (mode == "bounded")
    assert c.get("walk.bounded", 0) == (mode == "bounded" and walk == "device")
    assert c.get(f"walk.{walk}", 0) == 1
    passes = 2 if mode == "bounded" else 1
    assert c["front_end.query_chunks"] == passes * plans[0]["query_chunks"]
    for name in ("front_end.degrees", "front_end.rows"):
        got = [s["attrs"] for s in line["spans"] if s["name"] == name]
        assert got == ([{"chunks": plans[0]["query_chunks"]}]
                       if mode == "bounded" else []), name


def test_a_mesh_keeps_the_host_walk(monkeypatch):
    ks = KmerSet(15, _kmer_set(15, seed=11), _sorted=True)
    want = spss.get_unitigs_canonical(ks, device="cpu")
    _as_cuda_route(monkeypatch, 1)
    d0, h0 = _counts()
    got = spss.get_unitigs_canonical(ks, device="cpu", mesh=Mesh(["cpu"]))
    assert _counts() == (d0, h0 + 1)
    _equal(got, want)


@pytest.mark.parametrize("case", [_cycle_from_start, _unpaired_mirrors])
def test_a_refused_successor_falls_back_to_the_host_walk(monkeypatch, case):
    """The front-end's arrays replaced by ones that break the chain
    contract: the host route falls back to its own walks, as the
    reference does, while the device route raises (the front-end's own
    arrays keep the contract, so a refusal there is W1's fault and no
    host walk may hide it), counting no set walked either way."""
    A, succ, term_l, term_r, both = case()

    def front(A_, k, *, device, resident=None, keep=False):
        out = (succ, term_l, term_r, both)
        return (*out, torch.from_numpy(A)) if keep else tuple(x.numpy() for x in out)

    monkeypatch.setattr(spss, "device_unitig_succ", front)
    ks = KmerSet(15, A, _sorted=True)
    d0, h0 = _counts()
    spss.get_unitigs_canonical(ks, device="cpu")
    assert _counts() == (d0, h0 + 1)
    _as_cuda_route(monkeypatch, 1)
    with pytest.raises(RuntimeError, match="kernel W1 refused"):
        spss.get_unitigs_canonical(ks, device="cpu")
    assert _counts() == (d0, h0 + 1)
