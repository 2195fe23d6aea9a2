"""The port's kmerset-build slice as a whole, against the reference CLI.

Both CLIs run in subprocesses on the same FASTA: the port with
--device cpu (its kernels' plain versions), the reference pinned to its
host path.  Their dump files must be byte-identical and their logged
size, hash and cutoff count equal.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmerset_tpu.core.kmer_counter import KmerCounter as RefCounter
from kmerset_tpu_torch.core.kmer_counter import KmerCounter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_LOGGED = ("cutoff_count", "kmer_set.Size()", "kmer_set.Hash()",
           "kmer_set_compact.Size()")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """~3x coverage of an 8 kb genome from both strands, a read repeated
    20 times, and reads carrying runs of N."""
    rng = np.random.default_rng(2024)
    genome = rng.integers(0, 4, 8000, dtype=np.uint8)
    reads = []
    for _ in range(60):
        s = int(rng.integers(0, 7600))
        r = genome[s : s + 400]
        reads.append(3 - r[::-1] if rng.random() < 0.5 else r)
    reads += [genome[1000:1300]] * 20
    lines = [_BASES[r].tobytes() for r in reads]
    for j in range(5):
        r = _BASES[genome[1500 * j : 1500 * j + 600]].copy()
        for a in rng.integers(0, 590, 3):
            r[a : a + int(rng.integers(1, 12))] = ord("N")
        lines.append(r.tobytes())
    path = tmp_path_factory.mktemp("cli") / "reads.fa"
    path.write_bytes(
        b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(lines))
    )
    return str(path)


def _run(module: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu", KMERSET_TPU_FORCE_BACKEND="host")
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )


def _logged(stderr: str) -> dict:
    out = {}
    for key in _LOGGED:
        m = re.search(re.escape(key) + r" = (\d+)", stderr)
        if m:
            out[key] = int(m.group(1))
    return out


@pytest.mark.parametrize("cutoff", [1, 2])
def test_build_dump_byte_identical_to_reference(fasta, tmp_path, cutoff):
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    common = ["--k", "15", "--cutoff", str(cutoff), "--check"]
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                *common, "--out", a, fasta)
    ref = _run("kmerset_tpu.cli.kmerset_build", *common, "--out", b, fasta)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert _logged(port.stderr) == _logged(ref.stderr)
    assert len(_logged(port.stderr)) == len(_LOGGED)
    assert "kmer_set_compact -> KmerSet: ok" in port.stderr
    if cutoff > 1:
        assert _logged(port.stderr)["cutoff_count"] > 0


def test_stat_reads_port_dump(fasta, tmp_path):
    out = str(tmp_path / "a.txt")
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                "--k", "15", "--out", out, fasta)
    assert port.returncode == 0, port.stderr
    stat = _run("kmerset_tpu.cli.kmerset_stat", "--k", "15", out)
    assert stat.returncode == 0, stat.stderr
    _, name, size, hash_ = stat.stdout.strip().split("\t")
    logged = _logged(port.stderr)
    assert (int(size), int(hash_)) == (
        logged["kmer_set.Size()"], logged["kmer_set.Hash()"]
    )


def test_trace_writes_torch_profile(fasta, tmp_path):
    trace = tmp_path / "trace"
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                "--k", "15", "--trace", str(trace), fasta)
    assert port.returncode == 0, port.stderr
    assert (trace / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("cutoff", [1, 2])
@pytest.mark.parametrize("k", [19, 23])
def test_pair_k_dump_byte_identical_to_reference(fasta, tmp_path, k, cutoff):
    """k = 19 and 23 (kernel B2, the int64 keys) as k = 15 above."""
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    common = ["--k", str(k), "--cutoff", str(cutoff), "--check"]
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                *common, "--out", a, fasta)
    ref = _run("kmerset_tpu.cli.kmerset_build", *common, "--out", b, fasta)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert _logged(port.stderr) == _logged(ref.stderr)
    assert len(_logged(port.stderr)) == len(_LOGGED)
    assert "kmer_set_compact -> KmerSet: ok" in port.stderr
    if cutoff > 1:
        assert _logged(port.stderr)["cutoff_count"] > 0


@pytest.mark.parametrize("k", ["25", "31"])
def test_k_above_23_exits_1(fasta, k):
    """25 is no CLI k; 31 is one of the reference's, not ported."""
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                "--k", k, fasta)
    assert port.returncode == 1
    assert k in port.stderr


def test_cuda_without_a_card_exits_nonzero(fasta):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--k", "15", fasta)
    assert port.returncode != 0
    assert "cuda" in port.stderr


def test_counter_saturates_like_reference():
    """A read repeated 300 times: counts saturate at the uint8 default
    (value_max 255) on the device download, as in the reference."""
    rng = np.random.default_rng(9)
    hot = _BASES[rng.integers(0, 4, 60)].tobytes().decode()
    other = [_BASES[rng.integers(0, 4, 200)].tobytes().decode() for _ in range(5)]
    reads = [hot] * 300 + other
    port = KmerCounter.from_reads(15, reads, True, device="cpu")
    ref = RefCounter.from_reads(15, reads, True)
    np.testing.assert_array_equal(port.kmers, ref.kmers)
    np.testing.assert_array_equal(port.counts, ref.counts)
    assert port.counts.max() == 255
    for cutoff in (2, 256):
        (ps, pn), (rs, rn) = port.to_kmer_set(cutoff), ref.to_kmer_set(cutoff)
        assert pn == rn
        np.testing.assert_array_equal(ps.kmers, rs.kmers)
