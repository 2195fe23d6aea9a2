"""The port's own host layer (kmerset_tpu_torch/core/{kmer, io, strings,
kmer_set, native, graph, spss}.py, utils/{random, flags}.py and the host
merges of ops/backend.py) against the reference's modules it copies, on
the same numpy inputs; exact.

Each comparison runs twice where the native library is involved: with
libkmerio as the environment has it, and with both packages' loaders
forced to report no library, so that both take their numpy fallbacks.
The reference runs pinned to its host arms (KMERSET_TPU_FORCE_BACKEND=
host), as the port's dumps must equal that build byte for byte.
"""

import argparse

import numpy as np
import pytest

from kmerset_tpu.core import io as ref_io
from kmerset_tpu.core import kmer as ref_kmer
from kmerset_tpu.core import native as ref_native
from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu.core.strings import Packed2Strings as RefPacked2
from kmerset_tpu.core.strings import PackedStrings as RefStrings
from kmerset_tpu.ops import backend as ref_backend
from kmerset_tpu.utils import flags as ref_flags
from kmerset_tpu.utils.random import get_random_ints as ref_random_ints
from kmerset_tpu_torch.core import io, kmer, native, spss
from kmerset_tpu_torch.core.config import get_config
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.core.strings import Packed2Strings, PackedStrings
from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.utils import flags
from kmerset_tpu_torch.utils.random import get_random_ints


@pytest.fixture(autouse=True)
def _host_reference(monkeypatch):
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


@pytest.fixture(params=["libkmerio", "numpy"])
def lib_mode(request, monkeypatch):
    """The environment's native library, or none on either side."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(native, "get_lines_lib", lambda: None)
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    return request.param


def _canonical_set(k: int, n: int, seed: int) -> np.ndarray:
    codes = np.random.default_rng(seed).integers(0, 4, n).astype(np.int64)
    return np.unique(ref_kmer.canonical(ref_kmer.kmers_from_codes(codes, k), k))


def _forward_set(k: int, n: int, seed: int) -> np.ndarray:
    codes = np.random.default_rng(seed).integers(0, 4, n).astype(np.int64)
    return np.unique(ref_kmer.kmers_from_codes(codes, k))


def _same_strings(got, want) -> None:
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.offsets, want.offsets)


def test_both_packages_load_the_same_library():
    assert (native.get_lib() is None) == (ref_native.get_lib() is None)
    if native.get_lib() is not None:
        assert native._find_lib() == ref_native._find_lib()


@pytest.fixture
def serial_only(tmp_path, monkeypatch):
    """The port's loader with a fresh state, `native/libkmerio.so` made
    unloadable and the serial edition built under tmp_path; returns a
    function that points the checkout's library at a path (or None)."""
    from kmerset_tpu_torch import _nativebuild

    monkeypatch.delenv("KMERSET_TPU_NO_AUTOBUILD", raising=False)
    monkeypatch.setattr(_nativebuild, "ensure_built", lambda target, sources: None)
    monkeypatch.setattr(_nativebuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_nativebuild, "_SERIAL", {})
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_EDITION", None)

    def point_at(path):
        monkeypatch.setattr(native, "_find_lib", lambda: path)

    return point_at


@pytest.mark.parametrize("checkout_lib", ["not a library", "missing"])
def test_serial_edition_when_the_checkout_library_does_not_load(
    serial_only, tmp_path, checkout_lib
):
    """The serial edition's rule: when native/libkmerio.so is missing or
    does not load, the port compiles kmerio.c without OpenMP into its
    build directory, named by the source's hash, and loads it; its dumps
    equal the reference's (which loads the checkout's library here)."""
    from kmerset_tpu.core.kmer_set_compact import KmerSetCompact as RefCompact
    from kmerset_tpu_torch import _nativebuild
    from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact

    fake = tmp_path / "libkmerio.so"
    fake.write_bytes(b"not an ELF file\n")
    serial_only(str(fake) if checkout_lib == "not a library" else None)
    assert native.get_lib() is not None
    ed = native.edition()
    assert ed.serial and ed.path == _nativebuild.serial_library_path()
    assert ed.path.startswith(str(tmp_path / "build"))
    assert ed.build_s is not None and ed.build_s > 0
    assert native.set_threads(4)  # a no-op without OpenMP
    k = 15
    A = _canonical_set(k, 8000, 71)
    got, want = tmp_path / "port.txt", tmp_path / "ref.txt"
    KmerSetCompact.from_kmer_set(KmerSet(k, A, _sorted=True), True,
                                 device="cpu").dump(str(got))
    RefCompact.from_kmer_set(RefKmerSet(k, A, _sorted=True), True).dump(str(want))
    assert got.read_bytes() == want.read_bytes()
    assert ref_native.get_lib() is not None


def test_serial_edition_is_built_once_and_reused(serial_only):
    """A second process (here: a fresh loader state) finds the serial
    edition built and compiles nothing; the checkout's library, where it
    loads, is always taken first."""
    from kmerset_tpu_torch import _nativebuild

    serial_only(None)
    first = native.edition()
    native._LIB, native._TRIED, native._EDITION = None, False, None
    _nativebuild._SERIAL.clear()
    second = native.edition()
    assert second.path == first.path and second.build_s is None
    native._LIB, native._TRIED, native._EDITION = None, False, None
    serial_only(first.path)  # a library that loads, where the checkout's is
    assert native.edition() == native.Edition(first.path, False, None)


def test_both_editions_export_the_lines_codec(serial_only, monkeypatch):
    """The dump's text codec (kmerset_lines_encode, kmerset_lines_decode)
    is built from the port's own csrc/lines.c into a library of its own,
    named by the source's hash; libkmerio, in either edition, stays as the
    reference has it, without the codec, at ABI 3.  The bindings refuse
    bad offsets and codes before the C pass writes past its buffer."""
    import ctypes

    from kmerset_tpu_torch import _nativebuild

    serial_only(None)
    kmerio = native.edition()
    assert kmerio.serial and native.get_lib().kmerio_abi_version() == 3
    assert not hasattr(ctypes.CDLL(kmerio.path), "kmerset_lines_encode")
    monkeypatch.setattr(native, "_LINES", None)
    monkeypatch.setattr(native, "_LINES_TRIED", False)
    path, secs = _nativebuild.build_lines()
    assert path == _nativebuild.lines_library_path() and secs > 0
    assert path.startswith(_nativebuild.BUILD_DIR)
    lib = native.get_lines_lib()
    assert lib is not None and lib._name == path
    assert hasattr(lib, "kmerset_lines_encode")
    assert hasattr(lib, "kmerset_lines_decode")
    with pytest.raises(ValueError, match="0..3"):
        native.lines_encode(np.array([1, 4], np.uint8), np.array([0, 2]))
    for offsets in ([0, 3, 2, 4], [0, 5, 2]):
        with pytest.raises(ValueError, match="must not decrease"):
            native.lines_encode(np.zeros(4, np.uint8), np.array(offsets))
    # Decreasing offsets write nothing: [0, 5, 2] would put 6 bytes
    # into the 4 that offsets[-1] - offsets[0] + n sizes.
    out = np.full(16, 7, np.uint8)
    assert lib.kmerset_lines_encode(
        np.zeros(8, np.uint8).ctypes.data_as(native._u8p),
        np.array([0, 5, 2], np.int64).ctypes.data_as(native._i64p), 2,
        out.ctypes.data_as(native._u8p)) == -1
    assert (out == 7).all()
    with pytest.raises(ValueError, match="within the codes"):
        native.lines_encode(np.zeros(4, np.uint8), np.array([0, 5]))
    assert bytes(native.lines_encode(np.array([0, 1, 2, 3], np.uint8),
                                     np.array([0, 1, 1, 4]))) == b"A\n\nCGT\n"


def test_failed_make_is_recorded_and_not_retried(tmp_path, monkeypatch):
    """A `make -C native` that fails (the OpenMP build on a compiler
    without an OpenMP runtime) is recorded under the build directory: a
    later process skips it, and tries again only once the source or the
    Makefile has changed.  A build that succeeds records nothing."""
    from kmerset_tpu_torch import _nativebuild

    ndir = tmp_path / "native"
    ndir.mkdir()
    (ndir / "kmerio.c").write_text("int x;\n")
    (ndir / "Makefile").write_text(
        "libkmerio.so: kmerio.c\n\techo run >> calls.txt; false\n")
    monkeypatch.delenv("KMERSET_TPU_NO_AUTOBUILD", raising=False)
    monkeypatch.setattr(_nativebuild, "_native_dir", lambda: str(ndir))
    monkeypatch.setattr(_nativebuild, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_nativebuild, "_ATTEMPTED", set())

    def new_process_build():
        _nativebuild._ATTEMPTED.clear()
        _nativebuild.ensure_built("libkmerio.so", ["kmerio.c"])
        return (ndir / "calls.txt").read_text().count("run")

    assert new_process_build() == 1
    assert len(list((tmp_path / "build").glob("make_failed_*"))) == 1
    assert new_process_build() == 1  # skipped: the same doomed build
    (ndir / "kmerio.c").write_text("int y;\n")
    assert new_process_build() == 2  # the source changed: tried again
    (ndir / "Makefile").write_text(
        "libkmerio.so: kmerio.c\n\techo run >> calls.txt; touch $@\n")
    assert new_process_build() == 3 and (ndir / "libkmerio.so").exists()
    assert len(list((tmp_path / "build").glob("make_failed_*"))) == 2
    assert new_process_build() == 3  # built and up to date


def test_pointer_double_guard_raises_without_allocating():
    """2^31 nodes overflow the 31-bit pointer field: a ValueError, which
    python -O keeps (an assert would be stripped), before any array of
    that size is built (the stub is one element with stride 0)."""
    from kmerset_tpu_torch.core import graph

    big = np.lib.stride_tricks.as_strided(
        np.zeros(1, np.int64), shape=(1 << 31,), strides=(0,)
    )
    with pytest.raises(ValueError, match="31 bits"):
        graph.pointer_double(big)
    end, dist, is_chain, _ = graph.pointer_double(np.array([1, -1], np.int64))
    np.testing.assert_array_equal(end, [1, 1])
    np.testing.assert_array_equal(dist, [1, 0])
    assert is_chain.all()


# -- the codec --------------------------------------------------------------


@pytest.mark.parametrize("n", [100, 1 << 16])  # below and at the native cut
@pytest.mark.parametrize("k", [9, 15, 23, 31])
def test_codec_matches_reference(k, n, lib_mode):
    codes = np.random.default_rng(k + n).integers(0, 4, n + k - 1).astype(np.uint8)
    windows = ref_kmer.kmers_from_codes(codes, k)
    np.testing.assert_array_equal(
        kmer.reverse_complement(windows, k),
        ref_kmer.reverse_complement(windows, k),
    )
    np.testing.assert_array_equal(
        kmer.canonical(windows, k), ref_kmer.canonical(windows, k)
    )
    np.testing.assert_array_equal(
        kmer.codes_from_kmer(windows[:50], k),
        ref_kmer.codes_from_kmer(windows[:50], k),
    )
    assert kmer.canonical(int(windows[0]), k) == ref_kmer.canonical(int(windows[0]), k)
    for c in (0, 3, np.arange(4)):  # the one-base extensions of the graph
        np.testing.assert_array_equal(kmer.next_kmer(windows[:4], k, c),
                                      ref_kmer.next_kmer(windows[:4], k, c))
        np.testing.assert_array_equal(kmer.prev_kmer(windows[:4], k, c),
                                      ref_kmer.prev_kmer(windows[:4], k, c))


# -- parsing, strings, sets -------------------------------------------------


def test_fasta_parsing_matches_reference(lib_mode):
    lines = [">a", "ACGTNNACGT", ">b", "", ">c", "GGNTTACA"]
    assert io.parse_fasta_lines(lines) == ref_io.parse_fasta_lines(lines)
    for got, want in zip(io.reads_to_codes(io.parse_fasta_lines(lines)),
                         ref_io.reads_to_codes(lines[1::2])):
        np.testing.assert_array_equal(got, want)
    for bad in ([">a"], ["a", "ACGT"], [">a", "ACGU"]):
        with pytest.raises(io.IOError_):
            io.parse_fasta_lines(bad)
    data = "\n".join(lines).encode() + b"\n"
    got, want = native.parse_fasta_bytes(data), ref_native.parse_fasta_bytes(data)
    assert (got is None) == (want is None) == (lib_mode == "numpy")
    if got is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_line_io_matches_reference(tmp_path):
    lines = ["ACGT", "", "TTTTGA"]
    io.write_lines(str(tmp_path / "a"), "", lines)
    ref_io.write_lines(str(tmp_path / "b"), "", lines)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert io.read_lines(str(tmp_path / "a")) == ref_io.read_lines(str(tmp_path / "a"))
    io.write_lines(str(tmp_path / "c.gz"), "gzip", lines)
    assert io.read_lines(str(tmp_path / "c.gz"), "gzip -d") == lines
    with pytest.raises(io.IOError_, match="failed to open"):
        io.read_file_bytes(str(tmp_path / "missing"))


@pytest.mark.parametrize("k", [9, 15])
def test_packed_strings_match_reference(k, lib_mode):
    rng = np.random.default_rng(k)
    lens = rng.integers(k, 3 * k, 40)
    codes = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    ps, ref = PackedStrings(codes, offsets), RefStrings(codes, offsets)
    blob = ps.to_lines_bytes()
    assert blob == ref.to_lines_bytes()
    _same_strings(PackedStrings.from_lines_bytes(blob), RefStrings.from_lines_bytes(blob))
    np.testing.assert_array_equal(ps.first_kmers(k), ref.first_kmers(k))
    np.testing.assert_array_equal(ps.last_kmers(k), ref.last_kmers(k))
    assert ps.size_kmers(k) == ref.size_kmers(k) and ps.weight() == ref.weight()
    two = Packed2Strings.from_packed_strings(ps)
    np.testing.assert_array_equal(two.codes2, RefPacked2.from_packed_strings(ref).codes2)
    _same_strings(two.unpack(), ps)
    assert two.size_kmers(k) == ps.size_kmers(k)
    parts = [codes[:5], codes[5:5], codes[5:9]]
    _same_strings(PackedStrings.from_code_lists(parts), RefStrings.from_code_lists(parts))


_LINES_CASES = ["empty", "one", "empty-strings", "ragged-1000", "long-2^20",
                "no-trailing-newline", "crlf-load", "non-acgt"]


def _lines_lengths(case: str, rng) -> np.ndarray:
    if case == "ragged-1000":
        return rng.integers(0, 300, 1000)
    return np.array({"empty": [], "one": [57], "empty-strings": [0, 9, 0, 0, 14, 0],
                     "long-2^20": [1 << 20]}.get(case, [7, 0, 31, 2]), np.int64)


@pytest.mark.parametrize("case", _LINES_CASES)
def test_lines_codec_matches_reference(case, lib_mode, tmp_path):
    """The dump's text codec on both routes (libkmerio's one pass each
    way, or numpy's passes): the blob equals the reference's byte for
    byte, and parsing it gives the codes and offsets back."""
    from kmerset_tpu.core.kmer_set_compact import KmerSetCompact as RefCompact
    from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact

    assert (native.get_lines_lib() is None) == (lib_mode == "numpy")
    rng = np.random.default_rng(20)
    lens = _lines_lengths(case, rng)
    codes = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    ps = PackedStrings(codes, offsets)
    blob = ps.to_lines_bytes()
    assert bytes(blob) == RefStrings(codes, offsets).to_lines_bytes()
    if case == "no-trailing-newline":
        blob = bytes(blob)[:-1]
    elif case == "crlf-load":
        path = tmp_path / "crlf.txt"
        path.write_bytes(bytes(blob).replace(b"\n", b"\r\n"))
        got = KmerSetCompact.load(15, str(path), device="cpu").spss
        _same_strings(got, RefCompact.load(15, str(path)).spss)
        _same_strings(got, ps)
        return
    elif case == "non-acgt":
        blob = bytearray(blob)
        blob[9] = ord("N")  # inside the third string
        for parse in (PackedStrings.from_lines_bytes, RefStrings.from_lines_bytes):
            with pytest.raises(ValueError, match="only A/C/G/T"):
                parse(bytes(blob))
        return
    back = PackedStrings.from_lines_bytes(blob)
    _same_strings(back, RefStrings.from_lines_bytes(bytes(blob)))
    _same_strings(back, ps)


def test_kmer_set_and_sketch_sample_match_reference(lib_mode):
    k = 15
    cfg = get_config(k)
    a, b = _canonical_set(k, 20000, 1), _canonical_set(k, 20000, 2)
    b = np.unique(np.concatenate([b, a[::3]]))
    ks, ref = KmerSet(k, a[::-1]), RefKmerSet(k, a[::-1])
    np.testing.assert_array_equal(ks.kmers, ref.kmers)
    assert ks.hash() == ref.hash() and ks.size() == ref.size()
    assert ks.equals(KmerSet(k, a)) and not ks.equals(KmerSet(k, b))
    ids = np.array([0, 5, 77, cfg.n_buckets - 1])
    np.testing.assert_array_equal(ks.sample_buckets(cfg, ids), ref.sample_buckets(cfg, ids))
    # The greedy loop's set algebra and the chunked decode's key merge.
    for x, y in ((a, b), (a[:10], b), (a, a[:0])):
        got, want = native.sorted_algebra(x, y), ref_native.sorted_algebra(x, y)
        assert (got is None) == (want is None) == (lib_mode == "numpy")
        for g, w in zip(got or (), want or ()):
            np.testing.assert_array_equal(g, w)
        got, want = native.merge_keys(x, y), ref_native.merge_keys(x, y)
        if got is not None:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_random_ints_match_reference(seed):
    """The bucket sample of the multi-set sketch: same seed, same draws."""
    for unique, sorted_ in ((True, True), (False, False)):
        got = get_random_ints(327, unique, sorted_, 0, 16383, np.random.default_rng(seed))
        want = ref_random_ints(327, unique, sorted_, 0, 16383, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)


def test_flags_parse_like_reference():
    def parser(mod):
        p = argparse.ArgumentParser()
        mod.add_common_flags(p, compressor=True)
        mod.add_bool_flag(p, "check", False, "")
        p.add_argument("file")
        return p

    for argv in (["--canonical", "f"], ["--nocanonical", "--check", "f"],
                 ["--canonical=false", "--k", "23", "--workers", "3", "f"]):
        got = vars(flags.parse_args(parser(flags), argv))
        want = vars(ref_flags.parse_args(parser(ref_flags), argv))
        assert got == want
    with pytest.raises(SystemExit):
        flags.check_k(17)


# -- the SPSS host half -----------------------------------------------------


@pytest.mark.parametrize("k", [9, 15, 23])
def test_directed_build_matches_reference(k, lib_mode):
    """get_spss (unitigs, overlap edges, matching, cycle cuts, emission),
    its side tables on the device (the CPU here), the rest on the host as
    the reference builds it."""
    A = _forward_set(k, 6000, k)
    got = spss.get_spss(KmerSet(k, A, _sorted=True), device="cpu")
    want = ref_spss.get_spss(RefKmerSet(k, A, _sorted=True))
    _same_strings(got, want)
    _same_strings(spss.get_unitigs(KmerSet(k, A, _sorted=True), device="cpu"),
                  ref_spss.get_unitigs(RefKmerSet(k, A, _sorted=True)))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("k", [9, 15, 23])
def test_path_cover_matches_reference(k, fast, lib_mode):
    """The canonical path cover of the same unitigs, fast (handshake
    matching and cycle breaking) and slow (sequential matching)."""
    A = _canonical_set(k, 8000, 100 + k)
    unitigs = ref_spss.get_unitigs_canonical(RefKmerSet(k, A, _sorted=True))
    got = spss.get_spss_canonical_from_unitigs(
        PackedStrings(unitigs.codes, unitigs.offsets), k, fast
    )
    _same_strings(got, ref_spss.get_spss_canonical_from_unitigs(unitigs, k, fast))


@pytest.mark.parametrize("k", [9, 15, 19])
def test_canonical_build_matches_reference_on_both_host_branches(k, lib_mode):
    """The device front-end's build (on the CPU) against the reference's
    host build: the walk takes the same branch on both sides with and
    without the native library, and the two branches order strings
    differently, so each must match its own reference run."""
    A = _canonical_set(k, 8000, 200 + k)
    got = spss.get_spss_canonical(KmerSet(k, A, _sorted=True), device="cpu")
    want = ref_spss.get_spss_canonical(RefKmerSet(k, A, _sorted=True))
    _same_strings(got, want)


def test_cycles_and_isolated_kmers_match_reference(lib_mode):
    """A circular sequence (a pure cycle of the graph) beside isolated
    k-mers: _walk_cycles and the isolated emission."""
    k = 11
    ring = np.random.default_rng(3).integers(0, 4, 300)
    circ = np.concatenate([ring, ring[: k - 1]]).astype(np.int64)
    A = np.unique(np.concatenate([
        ref_kmer.canonical(ref_kmer.kmers_from_codes(circ, k), k),
        _canonical_set(k, k, 9),
    ]))
    got = spss.get_spss_canonical(KmerSet(k, A, _sorted=True), device="cpu")
    _same_strings(got, ref_spss.get_spss_canonical(RefKmerSet(k, A, _sorted=True)))


# -- the host merges of the chunked paths ------------------------------------


def test_count_merges_match_reference(lib_mode):
    rng = np.random.default_rng(41)
    runs = []
    for _ in range(5):
        keys = np.unique(rng.integers(0, 4000, 1500)).astype(np.int64)
        runs.append((keys, rng.integers(1, 9, keys.size).astype(np.int64)))
    runs.append((np.empty(0, np.int64), np.empty(0, np.int64)))
    got = backend._merge_cascade(list(runs), backend._merge_count_pair)
    want = ref_backend._merge_cascade(list(runs), ref_backend._merge_count_pair)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("edition", ["partitioned", "fp", "two-pass"])
def test_overlap_join_editions_match_reference(edition, monkeypatch):
    """Each edition of the native overlap join: the cache-blocked
    partitioned one (forced small on both sides), the fp one, and the
    two-pass count+fill API that takes over when the edges overflow the
    fp edition's 8-per-unitig capacity (every unitig overlapping every
    other)."""
    if native.get_lib() is None:
        pytest.skip("libkmerio is not built here; the numpy join is tested above")
    k = 11
    if edition == "two-pass":
        n = 1500
        P = np.full(n, 1, dtype=np.int64)  # next_kmer(S, k, 1) of S = 0
        S = np.zeros(n, dtype=np.int64)
    else:
        A = _canonical_set(k, 6000, 17)
        unitigs = ref_spss.get_unitigs_canonical(RefKmerSet(k, A, _sorted=True))
        P, S = unitigs.first_kmers(k), unitigs.last_kmers(k)
        if edition == "partitioned":
            monkeypatch.setattr(native, "_OVERLAP_PART_MIN", 16)
            monkeypatch.setattr(ref_native, "_OVERLAP_PART_MIN", 16)
    got = native.overlap_edges(P, S, k)
    want = ref_native.overlap_edges(P, S, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if edition == "two-pass":
        assert got[0].size > 8 * P.size + 1024
