"""The SPSS build on a mesh of CPU shards, and kmerset-build with a
--device list, against the reference's host build; exact.

Canonical and directed SPSS strings, and the build CLI's dump with
--device cpu,cpu,cpu,cpu, byte-identical to the reference's host path
with the native library and with the numpy edition (both packages'
loaders report no library), whose walks order strings differently
(tests/test_parallel.py:835-965, 1051-1063).  Also: every mesh program's
error reaches the caller, and the reference's routing decisions (k = 31
overlap edges, 2^30 nodes and up) still route to the host path.
"""

import numpy as np
import pytest

from kmerset_tpu.core import kmer as kc
from kmerset_tpu.core import native as ref_native
from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu_torch.core import native, spss
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact
from kmerset_tpu_torch.parallel import driver
from kmerset_tpu_torch.parallel.mesh import Mesh

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _host_reference(monkeypatch):
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


@pytest.fixture(params=["libkmerio", "numpy"])
def lib_mode(request, monkeypatch):
    """The environment's native library, or none on either side."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
        monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    return request.param


def _cpu_mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n)


def _codes(n: int, seed: int, k: int) -> np.ndarray:
    """A random sequence with a repeat (branches) and a circular stretch
    (a cycle of the graph)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n)
    ring = rng.integers(0, 4, 300)
    return np.concatenate([codes, codes[500:900], ring, ring[: k - 1]]).astype(np.int64)


def _same_strings(got, want) -> None:
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.offsets, want.offsets)


@pytest.mark.parametrize("n_shards", [1, 4, 6])
@pytest.mark.parametrize("k", [11, 19, 31])
def test_canonical_spss_on_the_mesh_matches_reference(k, n_shards, lib_mode):
    A = np.unique(kc.canonical(kc.kmers_from_codes(_codes(5000, k, k), k), k))
    mesh = _cpu_mesh(n_shards)
    _same_strings(
        spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device="cpu", mesh=mesh),
        ref_spss.get_unitigs_canonical(RefKmerSet(k, A, _sorted=True)))
    _same_strings(
        spss.get_spss_canonical(KmerSet(k, A, _sorted=True), device="cpu", mesh=mesh),
        ref_spss.get_spss_canonical(RefKmerSet(k, A, _sorted=True)))


@pytest.mark.parametrize("n_shards", [1, 4])
@pytest.mark.parametrize("k", [9, 23])
def test_directed_spss_on_the_mesh_matches_reference(k, n_shards, lib_mode):
    A = np.unique(kc.kmers_from_codes(_codes(4000, 50 + k, k), k))
    mesh = _cpu_mesh(n_shards)
    _same_strings(spss.get_unitigs(KmerSet(k, A, _sorted=True), device="cpu", mesh=mesh),
                  ref_spss.get_unitigs(RefKmerSet(k, A, _sorted=True)))
    _same_strings(spss.get_spss(KmerSet(k, A, _sorted=True), device="cpu", mesh=mesh),
                  ref_spss.get_spss(RefKmerSet(k, A, _sorted=True)))


def test_cycle_heavy_input_on_the_mesh(lib_mode):
    """A circular genome at k = 9: the mesh's leader election and cycle
    emission (tests/test_parallel.py:929-947), and the path cover's cycle
    breaking (:734-755)."""
    k = 9
    rng = np.random.default_rng(137)
    base = rng.integers(0, 4, 500)
    A = np.unique(kc.canonical(kc.kmers_from_codes(
        np.concatenate([base, base[:8]]).astype(np.int64), k), k))
    mesh = _cpu_mesh(4)
    _same_strings(
        spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device="cpu", mesh=mesh),
        ref_spss.get_unitigs_canonical(RefKmerSet(k, A, _sorted=True)))
    _same_strings(
        spss.get_spss_canonical(KmerSet(k, A, _sorted=True), device="cpu", mesh=mesh),
        ref_spss.get_spss_canonical(RefKmerSet(k, A, _sorted=True)))


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.default_rng(606)
    genome = rng.integers(0, 4, 7000, dtype=np.uint8)
    genome[5000:5600] = genome[200:800]
    reads = []
    for _ in range(50):
        s = int(rng.integers(0, 6600))
        r = genome[s : s + 400]
        reads.append(3 - r[::-1] if rng.random() < 0.5 else r)
    path = tmp_path_factory.mktemp("meshcli") / "reads.fa"
    path.write_bytes(b"".join(
        b">r%d\n%s\n" % (i, _BASES[r].tobytes()) for i, r in enumerate(reads)))
    return str(path)


@pytest.mark.parametrize("k,canonical", [(15, "true"), (23, "true"),
                                         (31, "true"), (15, "false")])
def test_build_cli_on_a_device_list_matches_reference(
    fasta, tmp_path, k, canonical, lib_mode, monkeypatch
):
    """kmerset-build --device cpu,cpu,cpu,cpu --check, in this process (so
    that the numpy edition can be forced on both sides), against the
    reference's host CLI: the same dump bytes; the count, the graph
    phases and the decode all went through the mesh."""
    from kmerset_tpu.cli import kmerset_build as ref_cli
    from kmerset_tpu_torch.cli import kmerset_build as port_cli

    used = set()
    for name in ("mesh_count", "mesh_pointer_double", "mesh_matching",
                 "mesh_unitig_succ", "mesh_side_tables"):
        real = getattr(driver, name)
        monkeypatch.setattr(driver, name, lambda *a, _n=name, _r=real, **kw:
                            used.add(_n) or _r(*a, **kw))
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    common = ["--k", str(k), f"--canonical={canonical}", "--check", "--cutoff", "2"]
    port_cli.main(["--device", "cpu,cpu,cpu,cpu", *common, "--out", a, fasta])
    ref_cli.main([*common, "--out", b, fasta])
    with open(a, "rb") as fa, open(b, "rb") as fb:
        dump = fa.read()
        assert dump == fb.read()
    assert dump.count(b"\n") > 5
    if canonical == "true":
        assert {"mesh_count", "mesh_unitig_succ", "mesh_pointer_double",
                "mesh_matching"} <= used
    else:  # these reads' directed unitigs hold no overlap edge to match
        assert {"mesh_count", "mesh_side_tables", "mesh_pointer_double"} <= used


@pytest.mark.parametrize("program", [
    "sharded_count", "sharded_unitig_succ", "sharded_side_tables",
    "sharded_pointer_double", "sharded_group_by_end", "sharded_matching",
    "sharded_overlap_edges",
])
def test_an_error_in_a_mesh_program_reaches_the_caller(program, monkeypatch):
    """No mesh path falls back in silence: the reference's routers catch
    every exception and take the host path (parallel/driver.py:250-254
    and its siblings); the port's raise."""
    def boom(*a, **kw):
        raise RuntimeError(f"injected failure in {program}")

    monkeypatch.setattr(driver, program, boom)
    k = 11
    codes = _codes(3000, 3, k)
    canonical = program != "sharded_side_tables"
    A = np.unique(kc.kmers_from_codes(codes, k))
    if canonical:
        A = np.unique(kc.canonical(A, k))
    mesh = _cpu_mesh(3)
    with pytest.raises(RuntimeError, match="injected failure"):
        c = KmerSetCompact.from_kmer_set(KmerSet(k, A, _sorted=True), canonical,
                                         device="cpu", mesh=mesh)
        KmerSetCompact(k, c.spss, device="cpu", mesh=mesh).kmers(canonical)


def test_k31_overlap_edges_stay_on_the_host_join(monkeypatch):
    """A routing decision, not a fallback: at k = 31 the path cover's
    overlap edges take the host join, and the rest stays on the mesh,
    where an error still raises."""
    k = 31
    A = np.unique(kc.canonical(kc.kmers_from_codes(_codes(4000, 8, k), k), k))
    called = []
    monkeypatch.setattr(driver, "mesh_overlap_edges", lambda *a, **kw: called.append(1))
    got = spss.get_spss_canonical(KmerSet(k, A, _sorted=True), device="cpu",
                                  mesh=_cpu_mesh(2))
    assert not called
    _same_strings(got, ref_spss.get_spss_canonical(RefKmerSet(k, A, _sorted=True)))

    def boom(*a, **kw):
        raise RuntimeError("injected matching failure")

    monkeypatch.setattr(driver, "sharded_matching", boom)
    with pytest.raises(RuntimeError, match="injected matching failure"):
        spss.get_spss_canonical(KmerSet(k, A, _sorted=True), device="cpu",
                                mesh=_cpu_mesh(2))


def test_node_count_gate_routes_the_walk_to_the_host(monkeypatch, lib_mode):
    """A routing decision, not a fallback: an oriented successor of
    MAX_MESH_NODES nodes or more is walked on the host, cycles and path
    cover included (the reference's 2^30, core/spss.py:674-678 and its
    drivers' early returns, lowered here), while the front-end, on fewer
    entities, stays on the mesh, where an error still raises."""
    k = 11
    A = np.unique(kc.canonical(kc.kmers_from_codes(_codes(3000, 9, k), k), k))
    monkeypatch.setattr(driver, "MAX_MESH_NODES", A.size + 1)
    doubled = []
    real = driver.mesh_pointer_double
    monkeypatch.setattr(driver, "mesh_pointer_double",
                        lambda *a, **kw: doubled.append(1) or real(*a, **kw))
    got = spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device="cpu",
                                     mesh=_cpu_mesh(3))
    assert not doubled
    _same_strings(got, ref_spss.get_unitigs_canonical(RefKmerSet(k, A, _sorted=True)))

    def boom(*a, **kw):
        raise RuntimeError("injected front-end failure")

    monkeypatch.setattr(driver, "sharded_unitig_succ", boom)
    with pytest.raises(RuntimeError, match="injected front-end failure"):
        spss.get_unitigs_canonical(KmerSet(k, A, _sorted=True), device="cpu",
                                   mesh=_cpu_mesh(3))
