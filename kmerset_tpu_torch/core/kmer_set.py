"""KmerSet: a set of k-mers as a sorted, deduplicated int64 array.

The port's copy of kmerset_tpu/core/kmer_set.py:14-151, with what the
port reaches: construction, size, equality, the XOR hash and the bucket
view of the sketch sampling.  Left out: the single-set algebra and
queries (add_kmers .. diff_count, :64-114) and intersection_size
(:154-180), which no part of the port calls (its sketch weights come
from ops/sketch.py), and the `device` slot of the reference's resident
handle (ops/resident.py, ROADMAP A.9).

The reference stores k-mers in 1<<N hash-set buckets keyed by the low
2K-N bits (reference: lib/core/kmer_set.h:45-60).  Here a set is a single
sorted array of packed k-mers: because the bucket id is the *high* N
bits, a sorted array is automatically grouped by bucket, and every bucket
is a contiguous slice (no hash tables, no locks).
"""

from __future__ import annotations

import numpy as np

from .arrays import sorted_unique
from .config import KConfig


class KmerSet:
    """Immutable-ish sorted-unique set of packed k-mers (reference:
    lib/core/kmer_set.h:57-244: Size, Equals, Hash over sorted arrays)."""

    __slots__ = ("k", "kmers")

    def __init__(self, k: int, kmers: np.ndarray | None = None, *, _sorted: bool = False):
        self.k = k
        if kmers is None:
            kmers = np.empty(0, dtype=np.int64)
        kmers = np.asarray(kmers, dtype=np.int64)
        if not _sorted:
            kmers = sorted_unique(kmers)
        self.kmers = kmers

    def size(self) -> int:
        return int(self.kmers.shape[0])

    def equals(self, other: "KmerSet") -> bool:
        return self.size() == other.size() and bool(np.array_equal(self.kmers, other.kmers))

    def hash(self) -> int:
        """Order-independent XOR hash over packed bits, identical to the
        reference's value (reference: lib/core/kmer_set.h:221-244 XORs
        kmer.Bits() over all elements).  Returned as unsigned."""
        h = int(np.bitwise_xor.reduce(self.kmers)) if self.kmers.size else 0
        return h & ((1 << 64) - 1)

    # -- bucket view (the shard axis) --------------------------------------

    def bucket_slices(self, config: KConfig) -> np.ndarray:
        """Start offsets of each bucket's contiguous slice; shape
        (n_buckets + 1,).  Bucket b occupies kmers[starts[b]:starts[b+1]].

        This replaces the reference's per-bucket hash sets
        (reference: lib/core/kmer_set.h:246-251) with slice bounds."""
        bounds = np.arange(config.n_buckets + 1, dtype=np.int64) << config.key_bits
        return np.searchsorted(self.kmers, bounds)

    def sample_buckets(self, config: KConfig, bucket_ids: np.ndarray) -> np.ndarray:
        """All k-mers whose bucket id is in bucket_ids, as one sorted array
        (the reference's sampled-bucket similarity sketch, reference:
        lib/core/kmer_set_compact.h:120-203): buckets are contiguous
        slices of the sorted array, so sampling is pure slicing."""
        starts = self.bucket_slices(config)
        bucket_ids = np.asarray(bucket_ids, dtype=np.int64)
        parts = [self.kmers[starts[b] : starts[b + 1]] for b in bucket_ids]
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(parts)

    def __repr__(self) -> str:
        return f"KmerSet(k={self.k}, size={self.size()})"
