"""Re-randomized SPSS fuzz of the port, the counterpart of
tests/test_fuzz.py: each process draws a fresh seed (replay one with
KMERSET_TPU_TEST_SEED) and prints it in every assertion message.  k is
drawn across every key layout (int32 keys through k = 15, int64 above,
up to 31); the canonical build, fast and sequential, and the directed
build run on one CPU device and on a CPU mesh of 3 shards, and their
strings must equal the reference's host build of the same set byte for
byte, hold each k-mer once and decode back to the set."""

import os

import numpy as np
import pytest

from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet as RefKmerSet
from kmerset_tpu.utils.random import get_random_kmer_set
from kmerset_tpu_torch.core import spss
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.parallel.mesh import Mesh

SEED = int(os.environ.get("KMERSET_TPU_TEST_SEED", "0")) or int.from_bytes(
    os.urandom(4), "little"
)
BUILDS = ("canonical fast", "canonical sequential", "directed")


@pytest.fixture(autouse=True)
def _host_reference(monkeypatch):
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")


def _draw(trial: int, build: str):
    """(k, n, rng) of one trial: odd k from 3 to 31 for the canonical
    graph (as the reference's fuzz), any k from 2 to 31 for the directed
    one; 1 to 2^12 k-mers."""
    rng = np.random.default_rng([SEED, trial, BUILDS.index(build)])
    if build == "directed":
        k = int(rng.integers(2, 32))
    else:
        k = int(rng.integers(1, 16)) * 2 + 1
    return k, int(rng.integers(1, 1 << 12)), rng


@pytest.mark.random
@pytest.mark.parametrize("shards", [0, 3])
@pytest.mark.parametrize("build", BUILDS)
@pytest.mark.parametrize("trial", range(3))
def test_port_spss_fuzz_random_seed(trial, build, shards):
    k, n, rng = _draw(trial, build)
    canonical = build != "directed"
    ref_set = get_random_kmer_set(k, n, canonical, rng)
    kmers = ref_set.kmers
    mesh = Mesh(["cpu"] * shards) if shards else None
    ks = KmerSet(k, kmers, _sorted=True)
    why = f"seed={SEED} trial={trial} {build} shards={shards} k={k} n={kmers.size}"
    if canonical:
        fast = build == "canonical fast"
        got = spss.get_spss_canonical(ks, fast, device="cpu", mesh=mesh)
        want = ref_spss.get_spss_canonical(RefKmerSet(k, kmers, _sorted=True), fast)
    else:
        got = spss.get_spss(ks, device="cpu", mesh=mesh)
        want = ref_spss.get_spss(RefKmerSet(k, kmers, _sorted=True))
    assert np.array_equal(got.codes, want.codes), why
    assert np.array_equal(got.offsets, want.offsets), why
    # Each k-mer once: the strings hold as many windows as the set.
    lengths = np.diff(got.offsets)
    assert (lengths >= k).all(), why
    assert int((lengths - k + 1).sum()) == kmers.size, why
    back = spss.get_kmer_set_from_spss(got, k, canonical, device="cpu", mesh=mesh)
    assert np.array_equal(back.kmers, kmers), why
