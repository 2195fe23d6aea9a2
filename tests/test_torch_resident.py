"""The counted set kept resident on its device from the count to the SPSS
build (kmerset_tpu_torch/ops/resident.py), against the reference's
handle (kmerset_tpu/ops/resident.py, XLA on the CPU), and the slice as a
whole: kmerset-build on both link settings against the reference's host
build.

The handle rides KmerCounter -> KmerSet -> KmerSetCompact; its cutoff
filter must equal the reference's (saturating at value_max); a stale,
mismatched or foreign handle must be refused; and the front-end on a
valid handle must upload nothing.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from kmerset_tpu.cli import kmerset_build as ref_build
from kmerset_tpu.core.kmer_counter import KmerCounter as RefCounter
from kmerset_tpu_torch.cli import kmerset_build
from kmerset_tpu_torch.core import native, spss
from kmerset_tpu_torch.core.kmer_counter import KmerCounter
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact
from kmerset_tpu_torch.ops import backend, deltas, unitigs
from kmerset_tpu_torch.ops.resident import DeviceKmers


def _reads(k: int, seed: int, n_reads: int = 40, length: int = 300) -> list:
    rng = np.random.default_rng(seed)
    return ["".join("ACGT"[c] for c in rng.integers(0, 4, length))
            for _ in range(n_reads)]


@pytest.mark.parametrize("k", [15, 19, 23, 31])
def test_handle_rides_counter_to_set(k):
    counter = KmerCounter.from_reads(k, _reads(k, k), True, device="cpu")
    h = counter._device
    assert h is not None and h.valid_for(counter.kmers, k) and h.on("cpu")
    ks, n_cut = counter.to_kmer_set(1)
    assert n_cut == 0 and ks.device is h
    # int64 at every k: the layout of the port's front-end, where the
    # reference's handle is int32 through k = 15 (spss.py:134).
    assert h.graph_input().dtype == torch.int64
    np.testing.assert_array_equal(h.graph_input().numpy(), ks.kmers)
    np.testing.assert_array_equal(h.counts.numpy(), counter.counts)


def _dup_reads(seed: int) -> list:
    reads = _reads(15, seed, n_reads=30)
    return reads + reads[::2] + reads[::3] + reads[::5]


@pytest.mark.parametrize("cutoff,value_max", [(2, 255), (3, 255), (3, 3), (3, 2)])
def test_filtered_equals_reference(monkeypatch, cutoff, value_max):
    """The handle's device filter keeps what the reference's does, in the
    same sorted order, with counts saturated at value_max first; the set
    it goes with is the host filter's, its endpoints verified."""
    k = 15
    reads = _dup_reads(7)
    counter = KmerCounter.from_reads(k, reads, True, value_max, device="cpu")
    got = counter._device.filtered(cutoff, value_max)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "device")
    ref = RefCounter.from_reads(k, reads, True, value_max)
    want = ref._device.filtered(cutoff, value_max)
    assert got.n == want.n
    np.testing.assert_array_equal(
        got.graph_input().numpy(), np.asarray(want.graph_input())[: want.n])
    ks, n_cut = counter.to_kmer_set(cutoff)
    want_ks, want_cut = ref.to_kmer_set(cutoff)
    assert n_cut == want_cut
    np.testing.assert_array_equal(ks.kmers, want_ks.kmers)
    if ks.size():
        assert ks.device is not None and ks.device.valid_for(ks.kmers, k)
    else:  # value_max 2 < cutoff 3: nothing survives
        assert value_max < cutoff and ks.device is None


def test_verified_endpoints_read_the_device():
    """A host array of the same length and endpoints that differs from the
    device copy at one of the 16 sampled positions is refused: the check
    reads device values."""
    counter = KmerCounter.from_reads(15, _dup_reads(19), True, device="cpu")
    h = counter._device.filtered(2, 255)
    keys = h.graph_input().numpy().copy()
    assert h.n > 16
    wrong = keys.copy()
    wrong[np.linspace(0, h.n - 1, 16, dtype=np.int64)[7]] += 1
    assert counter._device.filtered(2, 255).with_verified_endpoints(wrong) is None
    assert h.with_verified_endpoints(keys) is h and h.valid_for(keys, 15)


@pytest.mark.parametrize("fault", ["length", "sample"])
def test_filter_fault_raises(fault):
    """A device filter that disagrees with the host filter raises in
    to_kmer_set: one that keeps a k-mer fewer (a count changed on the
    device only), or one of the same length whose kept keys differ at a
    read-back sample (a key changed on the device only)."""
    counter = KmerCounter.from_reads(15, _dup_reads(19), True, device="cpu")
    h = counter._device
    kept = torch.nonzero(h.counts >= 2).flatten()
    assert kept.numel() > 16
    if fault == "length":
        h.counts[kept[0]] = 1
        match = "kept .* the host filter"
    else:
        h.arr[kept[np.linspace(0, kept.numel() - 1, 16, dtype=np.int64)[7]]] += 1
        match = "read-back sample"
    with pytest.raises(RuntimeError, match=match):
        counter.to_kmer_set(2)


def test_stale_mismatched_or_foreign_handle_refused(monkeypatch):
    """A handle on another set (one k-mer fewer), of another k, or on
    another device is not taken: the front-end uploads the host array and
    builds the same strings."""
    k = 15
    counter = KmerCounter.from_reads(k, _reads(k, 3), True, device="cpu")
    ks, _ = counter.to_kmer_set(1)
    h = ks.device
    other = KmerSet(k, ks.kmers[:-1], _sorted=True)
    other.device = h
    assert not h.valid_for(other.kmers, k) and not h.valid_for(ks.kmers, 17)
    foreign = DeviceKmers(torch.empty(h.n, dtype=torch.int64, device="meta"),
                          None, h.n, k, True, h.first, h.last)
    assert foreign.valid_for(ks.kmers, k) and not foreign.on("cpu")
    for kset, handle in ((other, h), (ks, foreign)):
        kset.device = handle
        assert spss._resident(kset, "cpu") is None
        bare = KmerSet(k, kset.kmers, _sorted=True)
        got = spss.get_unitigs_canonical(kset, device="cpu")
        want = spss.get_unitigs_canonical(bare, device="cpu")
        np.testing.assert_array_equal(got.codes, want.codes)
        np.testing.assert_array_equal(got.offsets, want.offsets)
    with pytest.raises(ValueError, match="resident handle"):
        unitigs.device_unitig_succ(other.kmers, k, device="cpu", resident=h)


@pytest.fixture
def uploads(monkeypatch):
    """Counts the front-end's uploads of a host set (torch.from_numpy on an
    int64 array, in ops/unitigs)."""
    seen = []
    real = torch.from_numpy

    def spy(a):
        seen.append(a.shape)
        return real(a)

    monkeypatch.setattr(unitigs.torch, "from_numpy", spy)
    return seen


@pytest.mark.parametrize("k,canonical,link", [
    (15, True, "fast"), (31, True, "fast"), (15, False, "fast"),
    (19, False, "fast"), (15, True, "slow"),
])
def test_front_end_on_handle_makes_no_upload(monkeypatch, k, canonical, link, uploads):
    """The canonical and directed front-ends (and on a slow link the side
    codes) take the handle's tensor: no upload, and the strings of the
    set without a handle."""
    monkeypatch.setattr(backend, "_slow_link", lambda device: link == "slow")
    counter = KmerCounter.from_reads(k, _reads(k, k + 1), canonical,
                                     device="cpu")
    ks, _ = counter.to_kmer_set(1)
    assert ks.device is not None
    build = spss.get_unitigs_canonical if canonical else spss.get_unitigs
    uploads.clear()
    got = build(ks, device="cpu")
    assert uploads == []
    want = build(KmerSet(k, ks.kmers, _sorted=True), device="cpu")
    assert uploads == [ks.kmers.shape]
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.offsets, want.offsets)


def test_adds_drop_the_handle():
    counter = KmerCounter.from_reads(15, _reads(15, 9), True, device="cpu")
    assert counter._device is not None
    counter.add(5)
    counter.size()  # flushes
    assert counter._device is None
    assert counter.to_kmer_set(1)[0].device is None


def test_set_algebra_starts_without_a_handle():
    counter = KmerCounter.from_reads(15, _reads(15, 10), True, device="cpu")
    ks, _ = counter.to_kmer_set(1)
    assert ks.device is not None
    for derived in (ks.union(ks), ks.subtract(ks), ks.intersection(ks),
                    ks.add_kmers(ks.kmers[:3]), ks.remove_kmers(ks.kmers[:3])):
        assert derived.device is None


def test_chunked_and_empty_counts_keep_no_handle(monkeypatch):
    """Only the one-shot count keeps its set on the device; an input with
    no window keeps none."""
    monkeypatch.setattr(backend, "window_ceiling", lambda k, budget: 500)
    assert KmerCounter.from_reads(15, _reads(15, 11), True, device="cpu")._device is None
    monkeypatch.undo()
    assert KmerCounter.from_reads(15, ["ACGT"], True, device="cpu")._device is None
    keys, counts, h = backend.device_count(
        np.zeros(3, np.uint8), np.array([0, 3]), 15, True, device="cpu", resident=True)
    assert keys.shape == (0,) and h is None


@pytest.mark.parametrize("lazy", [False, True])
def test_compact_build_carries_the_handle(lazy, uploads):
    """KmerSetCompact's build, eager or deferred, hands the set's handle
    to the front-end: no upload."""
    counter = KmerCounter.from_reads(15, _reads(15, 21), True, device="cpu")
    ks, _ = counter.to_kmer_set(1)
    uploads.clear()
    compact = KmerSetCompact.from_kmer_set(ks, True, lazy=lazy, device="cpu")
    strings = compact.spss
    assert uploads == []
    want = KmerSetCompact.from_kmer_set(KmerSet(15, ks.kmers, _sorted=True), True,
                                        device="cpu").spss
    np.testing.assert_array_equal(strings.codes, want.codes)


def test_slow_link_setting_and_probe(monkeypatch):
    """KMERSET_TPU_LINK decides at every call; without it the CPU is a fast
    link and probes nothing; the side-code route needs a slow link and the
    native library."""
    monkeypatch.delenv("KMERSET_TPU_LINK", raising=False)
    assert not backend._slow_link("cpu") and not backend._link_slow
    monkeypatch.setenv("KMERSET_TPU_LINK", "slow")
    assert backend._slow_link("cpu")
    assert backend.side_code_route(10, "cpu") == (native.get_lib() is not None)
    assert not backend.side_code_route(0, "cpu")
    assert not backend.side_code_route(native.MAX_SIDES_KMERS + 1, "cpu")
    monkeypatch.setattr(backend, "host_library_loaded", lambda: False)
    assert not backend.side_code_route(10, "cpu")
    monkeypatch.setenv("KMERSET_TPU_LINK", "fast")
    assert not backend._slow_link("cpu")


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """A FASTA of a random genome in overlapping 5 kb reads, one with a run
    of N: 400 kb (k = 15: dense enough for the gap format) and 60 kb."""
    out = {}
    for size in (400_000, 60_000):
        rng = np.random.default_rng(size)
        g = "".join("ACGT"[c] for c in rng.integers(0, 4, size))
        reads = [g[i : i + 5000] for i in range(0, size, 4900)]
        reads[1] = reads[1][:100] + "N" * 30 + reads[1][130:]
        path = tmp_path_factory.mktemp("link") / f"g{size}.fa"
        path.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
        out[size] = str(path)
    return out


@pytest.mark.parametrize("k,extra", [
    (15, ()), (19, ()), (23, ()), (31, ()), (15, ("--canonical=false",)),
])
def test_build_dump_equals_reference_on_both_links(monkeypatch, tmp_path, genomes, k, extra):
    """The slice as a whole: kmerset-build --device cpu with
    KMERSET_TPU_LINK=slow (the gap-encoded keys where the plan takes them,
    the side-code route) and with fast writes the reference host build's
    dump, byte for byte.  The slow canonical build makes its side codes
    once, in the SPSS phase, from the count's handle with no upload."""
    fasta = genomes[400_000 if k == 15 else 60_000]
    monkeypatch.setattr(backend, "DELTA_MIN_KEYS", 1 << 10)
    monkeypatch.setattr(deltas, "downloads", 0)
    built, in_sides = [], []
    real_sides, real_upload = spss.device_unitig_sides, backend.upload

    def upload_spy(what, *a, **kw):
        if in_sides:
            built.append(("upload", what))
        return real_upload(what, *a, **kw)

    def sides_spy(A, k, *, device, resident=None):
        built.append(("sides", resident is not None))
        in_sides.append(1)
        try:
            return real_sides(A, k, device=device, resident=resident)
        finally:
            in_sides.pop()

    monkeypatch.setattr(backend, "upload", upload_spy)
    monkeypatch.setattr(spss, "device_unitig_sides", sides_spy)
    dumps = {}
    for link in ("slow", "fast"):
        monkeypatch.setenv("KMERSET_TPU_LINK", link)
        dumps[link] = tmp_path / f"{link}.txt"
        kmerset_build.main(["--device", "cpu", "--k", str(k), *extra, "--check",
                            "--out", str(dumps[link]), fasta])
    assert deltas.downloads == (1 if k == 15 else 0)
    assert built == ([] if extra or native.get_lib() is None
                     else [("sides", True)])
    want = tmp_path / "ref.txt"
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    monkeypatch.setenv("KMERSET_TPU_LINK", "fast")
    ref_build.main(["--k", str(k), *extra, "--check", "--out", str(want), fasta])
    assert os.path.getsize(want) > 0
    for link, path in dumps.items():
        assert path.read_bytes() == want.read_bytes(), link
