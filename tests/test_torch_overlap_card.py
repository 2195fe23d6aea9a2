"""Kernel J1 on the card: the path cover's candidate overlap edges against
the plain version and the host's native join and dedup, element for
element, at the assembly cell's shape (a genome of E. coli K-12's length
as 10 kb records at k = 15) and at k = 23 and 31, and on repeated ends
(several matches a probe, mirrors in both orders); then a build of the
assembly cell's own input through kmerset-build whose dump is
byte-identical to the host route's.  Card tests (marker `card`) skip
without a CUDA device.  This file imports no JAX, so that it runs where
JAX is not installed, past tests/conftest.py:

    python -m pytest --noconftest -m card tests/test_torch_overlap_card.py -q
"""

import json
import os

import numpy as np
import pytest
import torch

from kmerset_tpu_torch.core import kmer, native, spss
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.ops import backend, overlap
from kmerset_tpu_torch.utils import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ECOLI_BP = 4_641_652
RECORD = 10_000  # bases per record, as the benchmark's assembly mix


@pytest.fixture
def card():
    """The CUDA device a card test runs on; skips without one (decided
    here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _moved(before: dict) -> dict:
    now = trace.counts()
    return {n: now.get(n, 0) - before.get(n, 0)
            for n in ("edges.device", "edges.host", "launch.J1")}


def _genome_ends(k: int, seed: int):
    """First and last k-mers of the canonical unitigs of a random genome
    of E. coli's length as 10 kb records."""
    genome = np.random.default_rng(seed).integers(0, 4, ECOLI_BP, dtype=np.uint8)
    kmers = np.concatenate([kmer.kmers_from_codes(genome[i : i + RECORD], k)
                            for i in range(0, ECOLI_BP, RECORD)])
    ks = KmerSet(k, np.unique(kmer.canonical(kmers, k)), _sorted=True)
    unitigs = spss.get_unitigs_canonical(ks, device="cuda")
    return unitigs.first_kmers(k), unitigs.last_kmers(k)


def _repeated_ends(k: int, seed: int, n: int = 20_000):
    """Ends drawn from the k-mers of one short sequence and their reverse
    complements: many matches a probe, each edge's mirror from both
    sides."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 4, k + 40)
    pool = kmer.kmers_from_codes(src, k)
    pool = np.concatenate([pool, kmer.reverse_complement(pool, k)])
    return pool[rng.integers(0, pool.size, n)], pool[rng.integers(0, pool.size, n)]


def _check(P: np.ndarray, S: np.ndarray, k: int) -> int:
    n = P.shape[0]
    a, b = native.overlap_edges(P, S, k)
    want = spss._dedup_port_edges(a, b, n)
    before = trace.counts()
    got = overlap.edges(torch.from_numpy(P).cuda(), torch.from_numpy(S).cuda(), k)
    torch.cuda.synchronize()
    assert _moved(before)["launch.J1"] == 2
    plain = overlap.edges_plain(torch.from_numpy(P), torch.from_numpy(S), k)
    assert torch.equal(got.cpu(), plain)
    np.testing.assert_array_equal(got[0].cpu().numpy(), want[0])
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1])
    return want[0].shape[0]


@pytest.mark.card
@pytest.mark.parametrize("k", [15, 23, 31])
def test_j1_equals_the_plain_version_and_the_native_join(card, k):
    P, S = _genome_ends(k, seed=22 + k)
    m = _check(P, S, k)
    if k == 15:
        assert P.shape[0] > backend.EDGES_MIN_UNITIGS and m > P.shape[0]


@pytest.mark.card
@pytest.mark.parametrize("k", [15, 31])
def test_j1_on_repeated_ends(card, k):
    P, S = _repeated_ends(k, seed=k)
    assert _check(P, S, k) > 10 * P.shape[0]


@pytest.mark.card
def test_a_build_of_the_assembly_cell_equals_the_host_route(card, tmp_path, monkeypatch):
    from kmerbench import generate
    from kmerset_tpu_torch.cli import kmerset_build

    def load(name):
        with open(os.path.join(ROOT, "kmerbench", name)) as f:
            return json.load(f)

    config = load("configs/ecoli-k15.json")
    mix = load("mixes/assembly.json")
    (fasta,), _ = generate.write_fastas(config, mix, 2_718_281_828, str(tmp_path))

    def build(out: str) -> bytes:
        argv = ["--device", card, "--k", "15", "--cutoff", "1", "--out", out, fasta]
        kmerset_build.main(argv)
        with open(out, "rb") as f:
            return f.read()

    before = trace.counts()
    got = build(str(tmp_path / "device.txt"))
    assert _moved(before) == {"edges.device": 1, "edges.host": 0, "launch.J1": 2}
    monkeypatch.setattr(backend, "EDGES_MIN_UNITIGS", 1 << 62)
    before = trace.counts()
    want = build(str(tmp_path / "host.txt"))
    assert _moved(before) == {"edges.device": 0, "edges.host": 1, "launch.J1": 0}
    assert got == want and len(got) > ECOLI_BP
