"""Kernel J1's plain version (ops/overlap.py) against the host's edge
discovery of the canonical path cover, and the path cover's routing
between the two.

The host's edges are those of core/spss.py's host route: the native join
(native.overlap_edges) followed by the first-occurrence dedup
(spss._dedup_port_edges), or both numpy fallbacks without the library.
J1's plain version, on CPU tensors of the same first and last k-mers,
must give the same ports in the same order, which the greedy matching
consumes as its priority; and a build whose edges take J1's route (forced
onto CPU tensors by patching backend.edges_route) the same strings as the
host route and the JAX package's host build (the reference).
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
from kmerset_tpu_torch.ops import backend, overlap
from kmerset_tpu_torch.parallel.mesh import Mesh
from kmerset_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def _native_library(monkeypatch):
    assert native.get_lib() is not None, "the host join under test is the native one"
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


def _kmer_set(k: int, seed: int, frags: int = 300) -> np.ndarray:
    """Sorted canonical k-mers of random fragments and SNP variants of a
    quarter of them (bubbles, so unitigs meet at branches)."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 4, int(rng.integers(k + 1, k + 120)))
            for _ in range(frags)]
    for s in seqs[: frags // 4]:
        v = s.copy()
        i = int(rng.integers(0, v.shape[0]))
        v[i] = (v[i] + 1) % 4
        seqs.append(v)
    kmers = np.concatenate([kmer.kmers_from_codes(s, k) for s in seqs])
    return np.unique(kmer.canonical(kmers, k))


def _strings(seqs) -> PackedStrings:
    lens = [len(s) for s in seqs]
    codes = (np.concatenate(seqs).astype(np.uint8) if seqs
             else np.empty(0, dtype=np.uint8))
    return PackedStrings(codes, np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))


def _rc_codes(s: np.ndarray) -> np.ndarray:
    return 3 - s[::-1]


def _unitigs(k: int, shape: str, seed: int) -> PackedStrings:
    """Strings of at least k codes, by shape:
    - unitigs: the canonical unitigs of a k-mer set (the path cover's input);
    - repeats: ends drawn from the k-mers of one short sequence and their
      reverse complements, so that one probe matches several j and each
      edge's mirror comes from both sides, in every pass;
    - self: strings whose own ends match (y + y[:k-1]: next(S, c) == P;
      an end (k-1)-mer that is its own reverse complement: the mirrored
      passes B and D from i to i), beside copies of each other;
    - one: a single string; none: no string."""
    rng = np.random.default_rng(seed)
    if shape == "unitigs":
        return spss.get_unitigs_canonical(KmerSet(k, _kmer_set(k, seed), _sorted=True),
                                          device="cpu")
    if shape == "repeats":
        src = rng.integers(0, 4, k + 12)
        pool = [src[i : i + k] for i in range(13)]
        pool += [_rc_codes(p) for p in pool]
        seqs = []
        for _ in range(150):
            mid = rng.integers(0, 4, int(rng.integers(0, 6)))
            a, b = (pool[int(x)] for x in rng.integers(0, len(pool), 2))
            seqs.append(np.concatenate([a, mid, b]))
        return _strings(seqs)
    if shape == "self":
        seqs = []
        h = (k - 1) // 2
        for _ in range(40):
            y = rng.integers(0, 4, int(rng.integers(k, k + 20)))
            z = rng.integers(0, 4, h)
            pal = np.concatenate([z, _rc_codes(z)])
            seqs.append(np.concatenate([y, y[: k - 1]]))
            seqs.append(np.concatenate([y, rng.integers(0, 4, 1), pal]))
            seqs.append(np.concatenate([pal, rng.integers(0, 4, 1), y]))
        seqs += seqs[:20]
        return _strings(seqs)
    if shape == "one":
        return _strings([rng.integers(0, 4, k + 7)])
    return _strings([])


def _ends(unitigs: PackedStrings, k: int):
    if not len(unitigs):
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    return unitigs.first_kmers(k), unitigs.last_kmers(k)


def _plain(P: np.ndarray, S: np.ndarray, k: int):
    pairs = overlap.edges(torch.from_numpy(P), torch.from_numpy(S), k)
    assert pairs.dtype == torch.int32 and pairs.shape[0] == 2
    return pairs[0].numpy().astype(np.int64), pairs[1].numpy().astype(np.int64)


def _same(got, want) -> None:
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("k", [15, 19, 23, 31])
@pytest.mark.parametrize("shape", ["unitigs", "repeats", "self", "one", "none"])
def test_plain_edges_equal_the_native_join_and_dedup(k, shape):
    unitigs = _unitigs(k, shape, seed=k)
    P, S = _ends(unitigs, k)
    n = P.shape[0]
    a, b = native.overlap_edges(P, S, k)
    want = spss._dedup_port_edges(a, b, n)
    got = _plain(P, S, k)
    _same(got, want)
    if n:
        _same(got, spss._candidate_port_edges_canonical(unitigs, k))
    # Each edge is discovered once from each end: the dedup halves them.
    assert a.shape[0] == 2 * want[0].shape[0]
    if shape in ("unitigs", "repeats", "self"):
        assert want[0].shape[0] > 0
    if shape == "repeats":
        assert np.unique(P).shape[0] < n and np.unique(S).shape[0] < n
        first_b = np.unique(want[1] & 1)
        assert first_b.tolist() == [0, 1]
    if shape == "self":
        # Unitig i's own ends meet (j == i), which the join skips: its
        # right side to its left (A), and to itself (B, D).
        assert (kmer.next_kmer(S, k, P & 3) == P).any()
        top = S >> (2 * (k - 1))
        assert (kmer.reverse_complement(kmer.next_kmer(S, k, 3 - top), k) == S).any()
        assert (kmer.reverse_complement(kmer.prev_kmer(P, k, 3 - (P & 3)), k) == P).any()


@pytest.mark.parametrize("bad", ["int32", "lengths", "2d"])
def test_edges_refuse_what_the_kernel_does_not_take(bad):
    P = torch.arange(6, dtype=torch.int64)
    S = P.clone()
    if bad == "int32":
        S = S.to(torch.int32)
    elif bad == "lengths":
        S = S[:5]
    else:
        P, S = P.view(2, 3), S.view(2, 3)
    with pytest.raises(ValueError, match="kernel J1 takes"):
        overlap.edges(P, S, 15)


@pytest.mark.parametrize("k", [15, 23])
def test_plain_edges_equal_the_numpy_join_and_dedup(monkeypatch, k):
    unitigs = _unitigs(k, "repeats", seed=50 + k)
    P, S = _ends(unitigs, k)
    want = _plain(P, S, k)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    _same(spss._candidate_port_edges_canonical(unitigs, k), want)


def _counts():
    c = trace.counts()
    return c.get("edges.device", 0), c.get("edges.host", 0)


def _as_cuda_route(monkeypatch, min_unitigs: int = 1):
    """backend.edges_route with the CPU taken for a CUDA device, from
    min_unitigs unitigs, at the CPU's budget: J1's route on CPU tensors
    (its plain version)."""
    real = backend.edges_route
    monkeypatch.setattr(backend, "memory_budget", lambda device: backend.HOST_BUDGET)
    monkeypatch.setattr(backend, "EDGES_MIN_UNITIGS", min_unitigs)
    monkeypatch.setattr(backend, "edges_route", lambda n, device: real(n, "cuda"))


def _equal(got: PackedStrings, want: PackedStrings) -> None:
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.codes, want.codes)


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("k", [15, 23])
def test_path_cover_on_the_device_route_equals_the_host_route(monkeypatch, k, fast):
    ks = KmerSet(k, _kmer_set(k, seed=3 * k + fast), _sorted=True)
    d0, h0 = _counts()
    want = spss.get_spss_canonical(ks, fast, device="cpu")
    assert _counts() == (d0, h0 + 1)
    _as_cuda_route(monkeypatch)
    got = spss.get_spss_canonical(ks, fast, device="cpu")
    assert _counts() == (d0 + 1, h0 + 1)
    _equal(got, want)
    _equal(want, ref_spss.get_spss_canonical(RefKmerSet(k, ks.kmers, _sorted=True), fast))
    unitigs = spss.get_unitigs_canonical(ks, device="cpu")
    _equal(spss.get_spss_canonical_from_unitigs(unitigs, k, fast, device="cpu"), want)
    assert _counts() == (d0 + 2, h0 + 1)


@pytest.mark.parametrize("below", [1, 1000])
def test_unitigs_below_the_size_constant_keep_the_host_join(monkeypatch, below):
    ks = KmerSet(15, _kmer_set(15, seed=5), _sorted=True)
    n = len(spss.get_unitigs_canonical(ks, device="cpu"))
    _as_cuda_route(monkeypatch, n + below)
    d0, h0 = _counts()
    spss.get_spss_canonical(ks, device="cpu")
    assert _counts() == (d0, h0 + 1)
    _as_cuda_route(monkeypatch, n)
    spss.get_spss_canonical(ks, device="cpu")
    assert _counts() == (d0 + 1, h0 + 1)


def test_edges_route_reads_the_constant_the_device_and_the_budget(monkeypatch):
    """The route holds on CUDA from EDGES_MIN_UNITIGS unitigs up to J1's
    ceiling, EDGES_BYTES_PER_UNITIG a unitig within half the budget, with
    the native library loaded."""
    monkeypatch.setattr(backend, "memory_budget", lambda device: backend.HOST_BUDGET)
    n = backend.EDGES_MIN_UNITIGS
    assert backend.edges_route(n, "cuda")
    assert backend.edges_route(n, torch.device("cuda:0"))
    assert not backend.edges_route(n - 1, "cuda")
    assert not backend.edges_route(n, "cpu")
    tight = 2 * backend.EDGES_BYTES_PER_UNITIG * n
    assert backend.edges_ceiling(tight) == n
    monkeypatch.setattr(backend, "memory_budget", lambda device: tight - 1)
    assert not backend.edges_route(n, "cuda")
    monkeypatch.setattr(backend, "memory_budget", lambda device: tight)
    assert backend.edges_route(n, "cuda")
    assert backend.edges_ceiling(1 << 50) == (1 << 30) - 1
    assert backend.edges_ceiling(0) == 1
    monkeypatch.setattr(backend, "host_library_loaded", lambda: False)
    assert not backend.edges_route(n, "cuda")


def test_a_mesh_and_the_directed_build_keep_the_host_join(monkeypatch):
    ks = KmerSet(15, _kmer_set(15, seed=11), _sorted=True)
    want = spss.get_spss_canonical(ks, device="cpu")
    _as_cuda_route(monkeypatch)
    called = []
    real = overlap.edges
    monkeypatch.setattr(overlap, "edges", lambda *a: called.append(1) or real(*a))
    d0, h0 = _counts()
    got = spss.get_spss_canonical(ks, device="cpu", mesh=Mesh(["cpu"]))
    assert _counts() == (d0, h0 + 1)
    _equal(got, want)
    directed = KmerSet(15, np.unique(kmer.kmers_from_codes(
        np.random.default_rng(2).integers(0, 4, 3000), 15)), _sorted=True)
    spss.get_spss(directed, device="cpu")
    assert _counts() == (d0, h0 + 1) and not called
    spss.get_spss_canonical(ks, device="cpu")
    assert _counts() == (d0 + 1, h0 + 1) and called == [1]


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


@pytest.mark.parametrize("route", ["device", "host"])
def test_the_spans_and_counters_of_each_route(monkeypatch, trace_lines, route):
    """One edges.<route> counter a path cover in the call's trace line,
    the phases' spans and debug lines under both routes, and on J1's the
    upload of the ends and the download of the kept ports."""
    ks = KmerSet(15, _kmer_set(15, seed=41), _sorted=True)
    if route == "device":
        _as_cuda_route(monkeypatch)
    with trace.root("cli.test", True):
        spss.get_spss_canonical(ks, device="cpu")
    found = [m for m in trace_lines if m.startswith(trace.PREFIX)]
    assert len(found) == 1
    line = json.loads(found[0][len(trace.PREFIX):])
    c = line["counters"]
    other = "host" if route == "device" else "device"
    assert c.get(f"edges.{route}") == 1 and f"edges.{other}" not in c
    names = [s["name"] for s in line["spans"]]
    for phase in ("spss.first_last", "spss.overlap_join", "spss.edge_dedup"):
        assert names.count(phase) == 1
    for text in ("spss: first/last kmers: ", "spss: overlap join: ",
                 "spss: edge dedup: "):
        assert sum(m.startswith(text) for m in trace_lines) == 1
    copies = {s["attrs"]["what"] for s in line["spans"]
              if s["name"] in ("copy.h2d", "copy.d2h")}
    assert ({"unitig ends", "overlap edges"} <= copies) == (route == "device")
