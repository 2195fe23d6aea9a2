"""Kernel W1 fed by the bounded front-end, on the card: at a budget whose
front-end ceiling is below the set and whose walk ceiling is not, the
canonical build walks on the device, from the rows the bounded mode kept
there, and its strings are byte-identical to the host walk's from the
same mode's downloaded rows.  Card tests (marker `card`) skip without a
CUDA device.  This file imports no JAX, so that it runs where JAX is not
installed, past tests/conftest.py:

    python -m pytest --noconftest -m card tests/test_torch_walk_card.py -q
"""

import numpy as np
import pytest
import torch

from kmerset_tpu_torch.core import kmer, spss
from kmerset_tpu_torch.core.kmer_set import KmerSet
from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.utils import trace

RECORD = 10_000  # bases per record, as the benchmark's assembly mix


@pytest.fixture
def card():
    """The CUDA device a card test runs on; skips without one (decided
    here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _kmer_set(k: int, n_bases: int, seed: int) -> KmerSet:
    """The canonical set of a random genome of n_bases as 10 kb records,
    with a one-base variant of every eighth record (bubbles, so chains
    branch) and a few circular sequences (pure cycles)."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, n_bases, dtype=np.uint8)
    seqs = [genome[i : i + RECORD] for i in range(0, n_bases, RECORD)]
    for s in seqs[::8]:
        v = s.copy()
        v[int(rng.integers(0, v.shape[0]))] ^= 1
        seqs.append(v)
    for _ in range(4):
        c = rng.integers(0, 4, int(rng.integers(40, 400)), dtype=np.uint8)
        seqs.append(np.concatenate([c, c[: k - 1]]))
    kmers = np.concatenate([kmer.kmers_from_codes(s, k) for s in seqs])
    return KmerSet(k, np.unique(kmer.canonical(kmers, k)), _sorted=True)


def _moved(before: dict) -> dict:
    now = trace.counts()
    names = ("walk.device", "walk.host", "walk.bounded", "front_end.bounded",
             "launch.W1")
    return {n: now.get(n, 0) - before.get(n, 0) for n in names}


@pytest.mark.card
@pytest.mark.parametrize("k", [15, 23])
def test_w1_from_the_bounded_front_end_equals_the_host_walk(card, monkeypatch, k):
    ks = _kmer_set(k, 1 << 21, seed=19 + k)
    n = ks.size()
    assert n >= backend.WALK_MIN_KMERS
    budget = (backend.FRONT_END_BYTES_PER_KMER + backend.WALK_BYTES_PER_KMER) * n
    assert backend.front_end_ceiling(budget) < n <= backend.walk_ceiling(budget)
    monkeypatch.setattr(backend, "memory_budget", lambda device: budget)
    before = trace.counts()
    with monkeypatch.context() as m:
        m.setattr(backend, "WALK_MIN_KMERS", n + 1)
        want = spss.get_unitigs_canonical(ks, device=card)
    assert _moved(before) == {"walk.device": 0, "walk.host": 1, "walk.bounded": 0,
                              "front_end.bounded": 1, "launch.W1": 0}
    before = trace.counts()
    got = spss.get_unitigs_canonical(ks, device=card)
    assert _moved(before) == {"walk.device": 1, "walk.host": 0, "walk.bounded": 1,
                              "front_end.bounded": 1, "launch.W1": 3}
    np.testing.assert_array_equal(got.offsets, want.offsets)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert want.offsets.size > 2 ** 21 // RECORD
