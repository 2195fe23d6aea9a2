"""Random test-data generators (reference: lib/random.h:18-134).

The port's copy of kmerset_tpu/utils/random.py:1-135, whole.  The
generators that build a KmerCounter, KmerSetCompact or KmerSetSet take a
keyword `device` (and, for the compact sets and the set of sets, an
optional `mesh`) and build it there: the SPSS builds and the joint
compression run on the device.  The draws are the reference's, in the
same order, so the same seed gives the same arrays, sets and compressed
directories; get_random_ints also draws the bucket sample of the
multi-set compressor's similarity sketch.

Unlike the original project's unseeded absl::InsecureBitGen (which makes
its tests and even its production bucket sampling nondeterministic
run-to-run, reference: lib/core/random.h:17), everything here takes an
explicit numpy Generator so failures reproduce.
"""

from __future__ import annotations

import numpy as np

from ..core import kmer as kmer_ops
from ..core.kmer_set import KmerSet


def get_random_ints(
    n: int,
    unique: bool,
    sorted_: bool,
    lo: int,
    hi: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """n random ints in [lo, hi], optionally distinct and/or sorted
    (reference: lib/core/random.h:13-41, GetRandomInts — used there for
    the multi-set compressor's bucket sampling)."""
    if unique:
        # Generator.choice accepts an int population — O(n) draw without
        # materializing the [lo, hi] range.
        out = rng.choice(hi - lo + 1, size=n, replace=False).astype(np.int64) + lo
    else:
        out = rng.integers(lo, hi + 1, size=n, dtype=np.int64)
    return np.sort(out) if sorted_ else out


def get_random_kmer(k: int, rng: np.random.Generator) -> int:
    return int(rng.integers(0, 1 << (2 * k), dtype=np.int64))


def get_random_read(k: int, rng: np.random.Generator) -> str:
    """1-100 random k-mers concatenated; 50% self-doubled to force loops
    (reference: lib/random.h:38-53)."""
    n = int(rng.integers(1, 101))
    kmers = rng.integers(0, 1 << (2 * k), size=n, dtype=np.int64)
    codes = kmer_ops.codes_from_kmer(kmers, k).reshape(-1)
    s = kmer_ops.codes_to_string(codes)
    if int(rng.integers(0, 2)) == 0:
        s += s
    return s


def get_random_kmers(k: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """n distinct uniform k-mers (reference GetRandomKmers inserts into a
    set until it reaches n, lib/random.h:25-34).  Insertion-ordered
    truncation keeps the sample uniform — sorting first and truncating
    would bias the tail toward low-valued k-mers (= low buckets)."""
    out: dict[int, None] = {}
    while len(out) < n:
        for x in rng.integers(0, 1 << (2 * k), size=n, dtype=np.int64):
            out.setdefault(int(x), None)
            if len(out) == n:
                break
    return np.sort(np.fromiter(out.keys(), dtype=np.int64, count=n))


def _random_read_kmers(k: int, canonical: bool, rng: np.random.Generator):
    """The (canonical) k-mers of one random read, in read order."""
    codes = kmer_ops.string_to_codes(get_random_read(k, rng))
    kmers = kmer_ops.kmers_from_codes(codes, k)
    return kmer_ops.canonical(kmers, k) if canonical else kmers


def get_random_kmer_counter(
    k: int, n: int, canonical: bool, rng: np.random.Generator, *, device
):
    """KmerCounter on `device` fed with ~n k-mer occurrences from random
    reads (reference: lib/random.h:56-77)."""
    from ..core.kmer_counter import KmerCounter

    counter = KmerCounter(k, device=device)
    total = 0
    while total < n:
        kmers = _random_read_kmers(k, canonical, rng)
        for x in kmers[: n - total]:
            counter.add(int(x), 1)
        total += min(kmers.shape[0], n - total)
    return counter


def get_random_kmer_set_compact(
    k: int, n: int, canonical: bool, rng: np.random.Generator, *, device,
    mesh=None,
):
    """(reference: lib/random.h:105-112), built on `device` or `mesh`."""
    from ..core.kmer_set_compact import KmerSetCompact

    return KmerSetCompact.from_kmer_set(
        get_random_kmer_set(k, n, canonical, rng), canonical, device=device,
        mesh=mesh,
    )


def get_random_kmer_sets_compact(
    n: int, m: int, k: int, canonical: bool, rng: np.random.Generator, *,
    device, mesh=None,
):
    """n compact sets of ~m k-mers each (reference: lib/random.h:115-126)."""
    return [
        get_random_kmer_set_compact(k, m, canonical, rng, device=device, mesh=mesh)
        for _ in range(n)
    ]


def get_random_kmer_set_set(
    n: int, m: int, k: int, canonical: bool, rng: np.random.Generator,
    config=None, *, device, mesh=None,
):
    """(reference: lib/random.h:129-134), compressed on `device` or
    `mesh`."""
    from ..core.config import get_config
    from ..core.kmer_set_set import KmerSetSet

    cfg = config or get_config(k, min(10, 2 * k - 2))
    return KmerSetSet(
        get_random_kmer_sets_compact(
            n, m, k, canonical, rng, device=device, mesh=mesh
        ),
        canonical, cfg, device=device, mesh=mesh,
    )


def get_random_kmer_set(
    k: int, n: int, canonical: bool, rng: np.random.Generator
) -> KmerSet:
    """Builds a KmerSet of ~n k-mers from random reads so the de Bruijn
    graph has real paths and loops (reference: lib/random.h:80-102)."""
    collected: list[np.ndarray] = []
    total = 0
    while total < n:
        kmers = _random_read_kmers(k, canonical, rng)
        collected.append(kmers)
        total += kmers.shape[0]
    allk = np.unique(np.concatenate(collected))
    return KmerSet(k, allk[: n if n < allk.shape[0] else allk.shape[0]], _sorted=True)
