"""The port's out-of-core paths on the CPU: the chunked count and decode
(kmerset_tpu_torch/ops/backend.py) against the reference's
device_count_chunked and device_unique_chunked (JAX on the CPU, with
CHUNK_WINDOWS patched small as tests/test_parallel.py does) and against
the port's one-shot path; the graph front-end in query chunks and in its
bounded mode (rows downloaded, or kept on the device for the device
walk) against its one-shot result; the memory-derived ceilings; and
kmerset-build of generated reads at k = 19 whose count takes 3 chunks,
against the benchmark's plain reference and the one-shot build's dump.
Every comparison is exact.
"""

import logging

import numpy as np
import pytest
import torch

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core.kmer_counter import KmerCounter as RefCounter
from kmerset_tpu.core.kmer_counter import extract_kmers
from kmerset_tpu.ops import backend as ref_backend
from kmerset_tpu_torch.core import spss as port_spss
from kmerset_tpu_torch.core.kmer_counter import KmerCounter
from kmerset_tpu_torch.core.strings import PackedStrings
from kmerset_tpu_torch.ops import backend, unitigs
from kmerset_tpu_torch.utils import trace


def _codes(seed: int, n: int = 6000):
    """Random codes split into fragments, with boundaries at and around
    the 1500-window chunk edges and fragments shorter than k."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n).astype(np.uint8)
    codes[3000:3600] = codes[100:700]  # repeats: counts above 1
    offsets = np.array([0, 1499, 1501, 1510, 3000, 4500, 4501, n], np.int64)
    return codes, offsets


@pytest.mark.parametrize("k", [9, 15, 23, 31])
def test_count_chunked_matches_reference_and_one_shot(monkeypatch, k):
    codes, offsets = _codes(k)
    monkeypatch.setattr(ref_backend, "CHUNK_WINDOWS", 1500)
    want = ref_backend.device_count_chunked(codes, offsets, k, True)
    assert want is not None
    one_k, one_c = backend.device_count(codes, offsets, k, True, device="cpu")
    np.testing.assert_array_equal(one_k, want[0])
    np.testing.assert_array_equal(one_c, want[1])
    assert want[1].max() > 1
    for chunk in (1500, 977, 6000):
        keys, counts = backend.device_count_chunked(
            codes, offsets, k, True, device="cpu", chunk_windows=chunk
        )
        assert keys.dtype == counts.dtype == np.int64
        np.testing.assert_array_equal(keys, want[0])
        np.testing.assert_array_equal(counts, want[1])


@pytest.mark.parametrize("k", [9, 15, 23, 31])
def test_unique_chunked_matches_reference_and_one_shot(monkeypatch, k):
    codes, offsets = _codes(100 + k)
    monkeypatch.setattr(ref_backend, "CHUNK_WINDOWS", 1500)
    want = ref_backend.device_unique_chunked(codes, offsets, k, True)
    assert want is not None
    np.testing.assert_array_equal(
        backend.device_unique(codes, offsets, k, True, device="cpu"), want
    )
    for chunk in (1500, 977, 6000):
        got = backend.device_unique_chunked(
            codes, offsets, k, True, device="cpu", chunk_windows=chunk
        )
        np.testing.assert_array_equal(got, want)


def test_chunk_slices_keep_halo_and_reject_empty_chunks():
    codes, offsets = _codes(3)
    k, chunk = 15, 1500
    parts = list(backend.chunk_slices(codes, offsets, k, chunk))
    assert len(parts) == -(-(codes.size - k + 1) // chunk)
    lo = 0
    for c, o in parts:
        np.testing.assert_array_equal(c, codes[lo : lo + c.size])
        assert c.size <= chunk + k - 1 and o[0] == 0 and o[-1] == c.size
        lo += chunk
    with pytest.raises(ValueError, match="chunk_windows"):
        list(backend.chunk_slices(codes, offsets, k, 0))
    short = codes[: k - 1]
    offs = np.array([0, k - 1], np.int64)
    keys, counts = backend.device_count_chunked(short, offs, k, True, device="cpu")
    assert keys.size == counts.size == 0
    assert backend.device_unique_chunked(short, offs, k, True, device="cpu").size == 0


def test_ceilings_at_given_budgets():
    for k, per in ((9, 48), (15, 48), (19, 72), (23, 72), (31, 72)):
        assert backend.count_bytes_per_window(k) == per
        assert backend.window_ceiling(k, per * 1000) == 1000
        assert backend.window_ceiling(k, per * 1000 + per - 1) == 1000
        assert backend.window_ceiling(k, 0) == 1
        assert backend.window_ceiling(k, 1 << 50) == backend.MAX_WINDOWS
    per = backend.FRONT_END_BYTES_PER_QUERY
    assert backend.query_chunk_kmers(per * 4096) == 4096
    assert backend.query_chunk_kmers(per - 1) == 1
    per = 2 * backend.FRONT_END_BYTES_PER_KMER
    assert backend.front_end_ceiling(per * 4096 + per - 1) == 4096
    assert backend.front_end_ceiling(0) == 1
    assert backend.memory_budget("cpu") == backend.HOST_BUDGET
    # 80 GB of free memory: the k = 15 ceiling is far above 2^24 windows.
    assert backend.window_ceiling(15, 40 << 30) > 1 << 28


@pytest.mark.parametrize("budget", [0, 1000, 1 << 20, 40 << 30])
def test_front_end_plan_fits_whole_set_and_chunk_in_the_budget(budget):
    """The front-end's whole-set arrays and its query chunk are planned
    together: where the mode's whole-set arrays and a 1-k-mer chunk fit,
    both together stay within the budget; the one-shot mode runs up to
    the ceiling, with a chunk of at least half the budget's worth."""
    ceiling = backend.front_end_ceiling(budget)
    per_query = backend.FRONT_END_BYTES_PER_QUERY
    for n in (0, 1, ceiling - 1, ceiling, ceiling + 1, 8 * ceiling,
              budget // backend.BOUNDED_BYTES_PER_KMER,
              budget // backend.BOUNDED_BYTES_PER_KMER + 1):
        bounded, q = backend.front_end_plan(n, budget)
        assert bounded == (n > ceiling)
        assert 1 <= q <= max(n, 1)
        held = n * (backend.BOUNDED_BYTES_PER_KMER if bounded
                    else backend.FRONT_END_BYTES_PER_KMER)
        if held + per_query <= budget:
            assert held + q * per_query <= budget, (n, q)
        if not bounded and budget:  # a zero budget still plans 1 k-mer
            assert held <= budget // 2
            assert q >= min(n, backend.query_chunk_kmers(budget // 2))


@pytest.mark.parametrize("budget", [0, 1000, 1 << 20, 40 << 30])
def test_front_end_plan_with_keep_holds_the_walk_bytes(budget):
    """With keep (the device walk's plan) the bounded mode's whole-set
    arrays are WALK_BYTES_PER_KMER a k-mer, and its query chunk is what
    they leave; up to the walk's ceiling that is at least half the
    budget's worth.  The one-shot mode plans as without keep."""
    ceiling = backend.front_end_ceiling(budget)
    per_query = backend.FRONT_END_BYTES_PER_QUERY
    walk = backend.walk_ceiling(budget)
    assert walk == max(1, budget // (2 * backend.WALK_BYTES_PER_KMER))
    for n in (1, ceiling, ceiling + 1, walk, walk + 1, 8 * walk):
        bounded, q = backend.front_end_plan(n, budget, keep=True)
        assert bounded == (n > ceiling)
        if not bounded:
            assert (bounded, q) == backend.front_end_plan(n, budget)
            continue
        held = n * backend.WALK_BYTES_PER_KMER
        assert q == max(1, min(n, (budget - held) // per_query))
        if n <= walk and budget:
            assert held <= budget // 2
            assert q >= min(n, backend.query_chunk_kmers(budget // 2))


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*args, **kw):
        calls.append(1)
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("k", [15, 23, 31])
def test_counter_and_decode_route_by_the_ceiling(monkeypatch, k):
    """Below the ceiling the one-shot path, above it the chunked one; both
    equal the reference's host count and decode.  Chunked counts stay raw
    until after the merge, then saturate at value_max."""
    codes, offsets = _codes(200 + k)
    codes[3600:4500] = np.tile(codes[3000:3090], 10)  # a run above value_max
    ref = RefCounter._from_codes(k, codes, offsets, True, value_max=3)
    ps = PackedStrings(codes, offsets)
    want = np.unique(extract_kmers(codes, offsets, k, True))
    chunked = _spy(monkeypatch, backend, "device_count_chunked")
    unique_chunked = _spy(monkeypatch, backend, "device_unique_chunked")
    port = KmerCounter._from_codes(k, codes, offsets, True, 3, device="cpu")
    np.testing.assert_array_equal(
        port_spss.decode_unique_kmers(ps, k, True, device="cpu"), want
    )
    assert chunked == unique_chunked == []
    per = backend.count_bytes_per_window(k)
    monkeypatch.setattr(backend, "memory_budget", lambda device: per * 1000)
    small = KmerCounter._from_codes(k, codes, offsets, True, 3, device="cpu")
    np.testing.assert_array_equal(
        port_spss.decode_unique_kmers(ps, k, True, device="cpu"), want
    )
    assert chunked == unique_chunked == [1]
    for c in (port, small):
        np.testing.assert_array_equal(c.kmers, ref.kmers)
        np.testing.assert_array_equal(c.counts, ref.counts)
    assert (ref.counts == 3).any() and ref.counts.max() == 3


def _canonical_set(k: int, n: int, seed: int) -> np.ndarray:
    codes = np.random.default_rng(seed).integers(0, 4, n).astype(np.int64)
    return np.unique(kc.canonical(kc.kmers_from_codes(codes, k), k))


@pytest.mark.parametrize("chunk", ["1", "7", "n"])
@pytest.mark.parametrize("k", [9, 23])
def test_unitig_succ_query_chunks_bit_for_bit(k, chunk):
    A = _canonical_set(k, 600 if chunk == "1" else 5000, k)
    want = unitigs.device_unitig_succ(A, k, device="cpu")
    q = A.size if chunk == "n" else int(chunk)
    got = unitigs.device_unitig_succ(A, k, device="cpu", query_chunk=q)
    for name, g, w in zip(("succ", "term_l", "term_r", "both"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    if k == 9:  # a branching set: first-neighbour order is exercised
        assert (want[0] == -1).sum() > 0 and (want[0] >= 0).sum() > 0


def test_front_end_above_the_memory_ceiling_does_not_raise(monkeypatch):
    """A set larger than the front-end's one-shot budget (the role the old
    fixed 2^26 cap played) is built in query chunks, equal to the host's
    construction.  This one is also above the whole-set ceiling, so the
    bounded mode makes two passes over the query chunks."""
    from kmerset_tpu.core import spss

    k = 15
    A = _canonical_set(k, 8000, 5)
    calls = _spy(monkeypatch, unitigs, "side_tables")
    budget = backend.FRONT_END_BYTES_PER_QUERY * 1000
    monkeypatch.setattr(backend, "memory_budget", lambda device: budget)
    bounded, q = backend.front_end_plan(A.size, budget)
    assert bounded and q < 1000
    succ, term_l, term_r, both = unitigs.device_unitig_succ(A, k, device="cpu")
    assert len(calls) == 2 * -(-A.size // q) > 2
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = spss._side_tables(A, k, True)
    mate_r = np.where(rsame, rdeg[rnbr], ldeg[rnbr])
    want_r = (rdeg != 1) | (mate_r != 1)
    mate_l = np.where(lsame, ldeg[lnbr], rdeg[lnbr])
    want_l = (ldeg != 1) | (mate_l != 1)
    np.testing.assert_array_equal(term_r, want_r)
    np.testing.assert_array_equal(term_l, want_l)
    np.testing.assert_array_equal(succ[0::2], np.where(want_r, -1, 2 * rnbr + rsame))
    with pytest.raises(ValueError, match="query_chunk"):
        unitigs.unitig_succ(torch.from_numpy(A), k, 0)


@pytest.mark.parametrize("k", [9, 23, 31])
def test_front_end_bounded_mode_below_its_budget(monkeypatch, k):
    """A set above the front-end's one-shot ceiling takes the bounded mode
    (only A and the degrees on the device for the whole set, every other
    row downloaded per query chunk), with outputs equal to one shot and
    to the host's construction."""
    from kmerset_tpu.core import spss

    A = _canonical_set(k, 5000, 300 + k)
    one = unitigs.device_unitig_succ(A, k, device="cpu")
    bounded = _spy(monkeypatch, unitigs, "bounded_unitig_succ")
    budget = backend.FRONT_END_BYTES_PER_KMER * (A.size // 3)
    monkeypatch.setattr(backend, "memory_budget", lambda device: budget)
    assert backend.front_end_ceiling(budget) < A.size
    chunks = _spy(monkeypatch, unitigs, "side_tables")
    got = unitigs.device_unitig_succ(A, k, device="cpu")
    assert bounded == [1]
    # Two passes over the query chunks (degrees, then rows).
    q = backend.front_end_plan(A.size, budget)[1]
    assert len(chunks) == 2 * -(-A.size // q) > 2
    (rdeg, rnbr, rsame), (ldeg, lnbr, lsame) = spss._side_tables(A, k, True)
    want_r = (rdeg != 1) | (np.where(rsame, rdeg[rnbr], ldeg[rnbr]) != 1)
    want_l = (ldeg != 1) | (np.where(lsame, ldeg[lnbr], rdeg[lnbr]) != 1)
    for name, g, w in zip(("succ", "term_l", "term_r", "both"), got, one):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(got[1], want_l)
    np.testing.assert_array_equal(got[2], want_r)
    assert (got[0] >= 0).any() and (got[0] == -1).any()
    with pytest.raises(ValueError, match="query_chunk"):
        unitigs.bounded_unitig_succ(torch.from_numpy(A), k, 0)


@pytest.mark.parametrize("k", [9, 23, 31])
def test_bounded_mode_with_keep_gives_the_one_shot_tensors(monkeypatch, k):
    """With keep (the device walk's plan) the bounded mode writes each
    query chunk's rows into whole-set tensors on the set's device and
    downloads nothing; its tensors equal the one-shot mode's on the same
    set, through bounded_unitig_succ and through device_unitig_succ's
    plan at a budget above and below the front-end's ceiling."""
    A = _canonical_set(k, 5000, 500 + k)
    At = torch.from_numpy(A)
    one = unitigs.unitig_succ(At, k)
    got, down_s = unitigs.bounded_unitig_succ(At, k, 700, keep=True)
    assert down_s == 0.0
    names = ("succ", "term_l", "term_r", "both")
    for name, g, w in zip(names, got, one):
        assert isinstance(g, torch.Tensor) and g.dtype == w.dtype, name
        assert torch.equal(g, w), name
    downloads = _spy(monkeypatch, backend, "download")
    kept = {}
    for mode, budget in (("one-shot", 1 << 30),
                         ("bounded", (backend.FRONT_END_BYTES_PER_KMER
                                      + backend.WALK_BYTES_PER_KMER) * A.size)):
        monkeypatch.setattr(backend, "memory_budget", lambda device: budget)
        before = trace.counts().get("walk.bounded", 0)
        kept[mode] = unitigs.device_unitig_succ(A, k, device="cpu", keep=True)
        assert trace.counts().get("walk.bounded", 0) - before == (mode == "bounded")
        assert len(kept[mode]) == 5 and torch.equal(kept[mode][4], At)
    assert downloads == []
    for name, b, o, w in zip(names, kept["bounded"], kept["one-shot"], one):
        assert torch.equal(b, o) and torch.equal(o, w), name
    assert bool((one[0] >= 0).any()) and bool((one[0] == -1).any())


def test_key_merge_fallback_matches_native_merge(monkeypatch):
    """The keys-only merge of the chunked decode: the native merge, and
    without it the sorted_unique fallback, equal np.union1d on shared,
    disjoint and empty runs."""
    from kmerset_tpu.core import native

    rng = np.random.default_rng(29)
    a = np.unique(rng.integers(0, 5000, 3000)).astype(np.int64)
    b = np.unique(rng.integers(2500, 9000, 3000)).astype(np.int64)
    e = np.empty(0, np.int64)
    cases = [(a, b), (b, a), (a, e), (e, e), (a, a)]
    want = [np.union1d(x, y) for x, y in cases]
    for merge_keys in (native.merge_keys, lambda ak, bk: None):
        monkeypatch.setattr(native, "merge_keys", merge_keys)
        for (x, y), w in zip(cases, want):
            got = backend._merge_key_pair(x, y)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, w)


def _plan_lines(caplog, prefix: str):
    return [r.getMessage() for r in caplog.records
            if r.getMessage().startswith(prefix) and "(ceiling" in r.getMessage()]


@pytest.mark.parametrize("k", [15, 23])
def test_count_and_decode_plan_lines_at_a_patched_budget(monkeypatch, caplog, k):
    """The count's and the decode's debug lines state the plan that the
    budget gives: one shot up to the ceiling (budget // bytes per
    window), above it ceil(W / ceiling) halo chunks of the ceiling.  The
    line is the decision: each reads the budget once, and the halo
    chunks that run are those of the line."""
    codes, offsets = _codes(400 + k)
    ps = PackedStrings(codes, offsets)
    w = codes.size - k + 1
    per = 48 if k <= 15 else 72
    caplog.set_level(logging.DEBUG, logger="kmerset")
    slices = []
    chunk_slices = backend.chunk_slices

    def spy_slices(*args):
        slices.append(list(chunk_slices(*args)))
        return slices[-1]

    monkeypatch.setattr(backend, "chunk_slices", spy_slices)
    for budget, chunks, chunk, ceiling in (
        (per * 1500 + per - 1, 4, 1500, 1500),
        (1 << 30, 1, w, (1 << 30) // per),
    ):
        reads = []
        monkeypatch.setattr(backend, "memory_budget",
                            lambda device: reads.append(1) or budget)
        caplog.clear()
        slices.clear()
        KmerCounter._from_codes(k, codes, offsets, True, device="cpu")
        port_spss.decode_unique_kmers(ps, k, True, device="cpu")
        plan = (f"{w} windows in {chunks} chunk(s) of at most {chunk} "
                f"(ceiling {ceiling}, budget {budget})")
        assert _plan_lines(caplog, "count: ") == ["count: " + plan]
        assert _plan_lines(caplog, "decode: ") == ["decode: " + plan]
        assert reads == [1, 1]
        assert [len(c) for c in slices] == ([chunks, chunks] if chunks > 1 else [])


def test_front_end_plan_line_at_a_patched_budget(monkeypatch, caplog):
    """The front-end's debug line states its mode, query chunk, ceiling
    and budget as front_end_plan gives them: the whole-set arrays (80 B
    per k-mer one shot, 10 bounded) within half the budget, and a query
    chunk of what they leave at 320 B per queried k-mer."""
    k = 23
    A = _canonical_set(k, 5000, 77)
    n = A.size
    caplog.set_level(logging.DEBUG, logger="kmerset")
    bounded = _spy(monkeypatch, unitigs, "bounded_unitig_succ")
    for budget, mode, q, ceiling in (
        (160 * 1000, "bounded", (160 * 1000 - 10 * n) // 320, 1000),
        (1 << 30, "one-shot", n, (1 << 30) // 160),
    ):
        monkeypatch.setattr(backend, "memory_budget", lambda device: budget)
        caplog.clear()
        unitigs.device_unitig_succ(A, k, device="cpu")
        assert _plan_lines(caplog, "unitigs: ") == [
            f"unitigs: {mode}, query chunk {q} of {n} k-mers (ceiling "
            f"{ceiling}, budget {budget})"]
    assert bounded == [1]


# -- kmerset-build above the count's one-shot ceiling ------------------------

_READS_K, _READS_CUTOFF, _READS_GENOME = 19, 2, 60_000


@pytest.fixture(scope="module")
def reads10x_builds(tmp_path_factory):
    """kmerset-build through main(argv) at k = 19 and cutoff 2 of reads
    that kmerbench's generator makes from the reads10x mix over a 60 kb
    genome: once in one shot and once with the budget patched so that
    the count takes exactly 3 halo chunks.  Returns the FASTA, the two
    dumps, and the chunks each count ran (chunk_slices' yields)."""
    from kmerbench import generate, spec
    from kmerset_tpu_torch.cli import kmerset_build

    d = tmp_path_factory.mktemp("reads10x")
    mix = spec.load_json(f"{spec.HERE}/mixes/reads10x.json")
    genome = generate.genomes({"genome_bp": _READS_GENOME}, 23)[0]
    fasta = str(d / "reads.fa")
    bases = generate.write_reads(fasta, genome, mix, generate.rng_of(23, 2))
    windows = bases - _READS_K + 1
    per = backend.count_bytes_per_window(_READS_K)
    chunks = []
    real_slices = backend.chunk_slices

    def spy_slices(*args):
        chunks.append(len(list(real_slices(*args))))
        return real_slices(*args)

    dumps = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(backend, "chunk_slices", spy_slices)
        for name, budget in (("one shot", None),
                             ("chunked", per * -(-windows // 3))):
            if budget is not None:
                mp.setattr(backend, "memory_budget", lambda device: budget)
            dumps[name] = str(d / f"{name.replace(' ', '_')}.txt")
            kmerset_build.main([
                "--device", "cpu", "--k", str(_READS_K), "--cutoff",
                str(_READS_CUTOFF), "--out", dumps[name], fasta])
    return fasta, dumps, chunks


def test_a_reads10x_build_counts_in_exactly_three_chunks(reads10x_builds):
    _, _, chunks = reads10x_builds
    assert chunks == [3]


def test_the_chunked_reads10x_dump_is_the_reference_set(reads10x_builds):
    from kmerbench.reference import kmers as plain

    fasta, dumps, _ = reads10x_builds
    want, stats = plain.kmer_set(fasta, _READS_K, _READS_CUTOFF, "cpu")
    got, doubled, malformed, strings = plain.decode_dump(
        dumps["chunked"], _READS_K, "cpu")
    assert torch.equal(got, want)
    assert doubled == malformed == 0 and strings > 0
    # Errors seen once fall under the cutoff, so it does cut something.
    assert 0 < stats["kept"] < stats["distinct"]


def test_the_chunked_reads10x_dump_equals_the_one_shot_dump(reads10x_builds):
    _, dumps, _ = reads10x_builds
    with open(dumps["chunked"], "rb") as a, open(dumps["one shot"], "rb") as b:
        chunked, one_shot = a.read(), b.read()
    assert chunked and chunked == one_shot
