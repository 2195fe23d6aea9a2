"""The directed de Bruijn graph (--canonical=false) on the device, against
the reference, on the CPU; exact.

The side tables of ops/neighbors.side_tables(canonical=False) against the
reference's traced tables (kmerset_tpu.ops.neighbors.device_side_tables,
jit on the CPU) and its host _side_table_plain; the chunked device build
(ops/unitigs.device_side_tables_directed) against the port's host plain
version; get_unitigs and get_spss against the reference's host build
with and without the native library; and kmerset-build --canonical=false
--check at every CLI k against the reference CLI, dump bytes and log
lines.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmerset_tpu.core import kmer as ref_kmer
from kmerset_tpu.core import native as ref_native
from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu.ops import neighbors as ref_neighbors
from kmerset_tpu_torch.core import native, spss
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.ops import neighbors, unitigs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


def _forward_set(k: int, n: int, seed: int) -> np.ndarray:
    """The forward k-mers of a random sequence with a repeated stretch, so
    the graph branches, and a circular stretch, so it holds a cycle."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n)
    ring = rng.integers(0, 4, 200)
    codes = np.concatenate([codes, codes[100:400], ring, ring[: k - 1]])
    return np.unique(ref_kmer.kmers_from_codes(codes.astype(np.int64), k))


@pytest.mark.parametrize("k", [9, 15, 19, 23, 31])
def test_side_tables_directed_match_reference(k):
    A = _forward_set(k, 5000, k)
    got = neighbors.side_tables(torch.from_numpy(A), k, canonical=False)
    traced = ref_neighbors.device_side_tables(A, k, False)
    assert traced is not None
    for (deg, nbr, same), ref, right in zip(got, traced, (True, False)):
        hdeg, hnbr = ref_spss._side_table_plain(A, k, right=right)
        np.testing.assert_array_equal(deg.numpy(), hdeg)
        np.testing.assert_array_equal(nbr.numpy(), hnbr)
        assert not same.numpy().any()
        np.testing.assert_array_equal(deg.numpy(), ref[0])
        np.testing.assert_array_equal(same.numpy(), ref[2])
        m = hdeg > 0
        np.testing.assert_array_equal(nbr.numpy()[m], ref[1][m])
    if k == 9:  # the set branches, so the first-hit rule is exercised
        assert (got[0][0].numpy() > 1).any() and (got[1][0].numpy() > 1).any()


def test_side_tables_directed_exclude_self_loops():
    """AAAA... and a k-mer of one repeated dinucleotide are their own next
    or prev candidates: never their own neighbour, as on the host."""
    k = 11
    A = np.unique(np.array([0, 0x155555 & ((1 << 22) - 1), 0x111111, 5, 17],
                           dtype=np.int64))
    (rdeg, rnbr, _), (ldeg, lnbr, _) = neighbors.side_tables(
        torch.from_numpy(A), k, canonical=False)
    for deg, right in ((rdeg, True), (ldeg, False)):
        np.testing.assert_array_equal(
            deg.numpy(), ref_spss._side_table_plain(A, k, right=right)[0])
    assert rdeg[0] == 0 and ldeg[0] == 0  # AAAA...: next(a, A) == a


@pytest.mark.parametrize("query_chunk", [None, 1, 97])
def test_device_side_tables_directed_any_chunk(query_chunk):
    """The chunked device build equals the port's host plain version and
    the reference's native or numpy host tables, at every chunk size."""
    k = 15
    A = _forward_set(k, 4000, 7)
    got = unitigs.device_side_tables_directed(
        A, k, device="cpu", query_chunk=query_chunk)
    plain = spss._side_tables_directed(A, k)
    for g, p, right in zip(got, plain, (True, False)):
        for a, b in zip(g, p):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            g[0], ref_spss._side_table_plain(A, k, right=right)[0])
    with pytest.raises(ValueError, match="query_chunk"):
        unitigs.device_side_tables_directed(A, k, device="cpu", query_chunk=0)


def _same_strings(got, want) -> None:
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.offsets, want.offsets)


@pytest.mark.parametrize("k", [9, 15, 23, 31])
def test_directed_unitigs_and_spss_match_reference(k, lib_mode):
    """get_unitigs with its side tables on the device, and get_spss on
    top, against the reference's host build; both editions order the
    strings differently, so each must match its own reference run."""
    A = _forward_set(k, 6000, 40 + k)
    _same_strings(spss.get_unitigs(KmerSet(k, A, _sorted=True), device="cpu"),
                  ref_spss.get_unitigs(RefKmerSet(k, A, _sorted=True)))
    _same_strings(spss.get_spss(KmerSet(k, A, _sorted=True), device="cpu"),
                  ref_spss.get_spss(RefKmerSet(k, A, _sorted=True)))


# -- the build CLI ----------------------------------------------------------


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Reads of both strands of a 6 kb genome with a repeat, and a read
    with N runs."""
    rng = np.random.default_rng(99)
    genome = rng.integers(0, 4, 6000, dtype=np.uint8)
    genome[4000:4500] = genome[1000:1500]
    reads = []
    for _ in range(40):
        s = int(rng.integers(0, 5600))
        r = genome[s : s + 400]
        reads.append(3 - r[::-1] if rng.random() < 0.5 else r)
    lines = [_BASES[r].tobytes() for r in reads]
    r = _BASES[genome[:600]].copy()
    r[100:108] = ord("N")
    lines.append(r.tobytes())
    path = tmp_path_factory.mktemp("directed") / "reads.fa"
    path.write_bytes(b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(lines)))
    return str(path)


def _run(module: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("KMERSET_TPU_FORCE_BACKEND", None)
    if module.startswith("kmerset_tpu."):
        env["KMERSET_TPU_FORCE_BACKEND"] = "host"
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )


def _messages(stderr: str):
    """The log lines without their `[time] [level] [thread]` prefix."""
    return [re.sub(r"^\[[^]]*\] \[[^]]*\] \[\d+\] ", "", line)
            for line in stderr.splitlines()]


@pytest.mark.parametrize("k", [15, 19, 23, 31])
def test_build_cli_directed_matches_reference(fasta, tmp_path, k):
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    common = ["--k", str(k), "--canonical=false", "--check"]
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                *common, "--out", a, fasta)
    ref = _run("kmerset_tpu.cli.kmerset_build", *common, "--out", b, fasta)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        dump = fa.read()
        assert dump == fb.read()
    assert dump.count(b"\n") > 10
    assert _messages(port.stderr) == _messages(ref.stderr)
    assert "kmer_set_compact -> KmerSet: ok" in port.stderr
