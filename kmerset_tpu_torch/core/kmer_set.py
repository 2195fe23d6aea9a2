"""KmerSet: a set of k-mers as a sorted, deduplicated int64 array.

The port's copy of kmerset_tpu/core/kmer_set.py:14-180: construction,
the queries and the set algebra (host numpy and native merges, as in the
reference, which has no device route for one set's algebra), equality,
the XOR hash, the bucket view of the sketch sampling, and
intersection_size, and the `device` slot (:43-49): the set's resident
handle (ops/resident.DeviceKmers), set by the count, never passed on
through set algebra.

The reference stores k-mers in 1<<N hash-set buckets keyed by the low
2K-N bits (reference: lib/core/kmer_set.h:45-60).  Here a set is a single
sorted array of packed k-mers: because the bucket id is the *high* N
bits, a sorted array is automatically grouped by bucket, and every bucket
is a contiguous slice (no hash tables, no locks).  Set algebra becomes
sorted-array merging, membership becomes vectorized binary search.
"""

from __future__ import annotations

import numpy as np

from ..utils import trace
from .arrays import sorted_unique
from .config import KConfig


class KmerSet:
    """Immutable-ish sorted-unique set of packed k-mers.

    Mirrors the API surface of the reference KmerSet
    (reference: lib/core/kmer_set.h:57-244): Size, Add, Remove, Contains,
    Find, Add(set), Sub(set), Diff, Equals, Hash — re-expressed functionally
    over sorted arrays.
    """

    __slots__ = ("k", "kmers", "device")

    def __init__(self, k: int, kmers: np.ndarray | None = None, *, _sorted: bool = False):
        self.k = k
        if kmers is None:
            kmers = np.empty(0, dtype=np.int64)
        kmers = np.asarray(kmers, dtype=np.int64)
        if not _sorted:
            kmers = sorted_unique(kmers)
        self.kmers = kmers
        # The resident handle (ops/resident.DeviceKmers) the count sets: a
        # hint that consumers validate (valid_for, on); the host array
        # stays authoritative.  New sets start without one.
        self.device = None

    # -- construction ------------------------------------------------------

    @classmethod
    def from_kmers(cls, k: int, kmers: np.ndarray) -> "KmerSet":
        return cls(k, kmers)

    # -- basic queries (reference: lib/core/kmer_set.h:64-105) -------------

    def size(self) -> int:
        return int(self.kmers.shape[0])

    def __len__(self) -> int:
        return self.size()

    def contains(self, queries: np.ndarray) -> np.ndarray:
        """Vectorized membership: replaces per-kmer hash lookups
        (reference: lib/core/kmer_set.h:98-105) with binary search."""
        queries = np.asarray(queries, dtype=np.int64)
        if self.kmers.size == 0:
            return np.zeros(queries.shape, dtype=bool)
        idx = np.searchsorted(self.kmers, queries)
        idx = np.minimum(idx, self.kmers.shape[0] - 1)
        return self.kmers[idx] == queries

    def contains_one(self, kmer: int) -> bool:
        return bool(self.contains(np.array([kmer], dtype=np.int64))[0])

    def add_kmers(self, kmers: np.ndarray) -> "KmerSet":
        """Returns a new set with the k-mers added (reference Add,
        lib/core/kmer_set.h:81-87)."""
        merged = np.union1d(self.kmers, np.asarray(kmers, dtype=np.int64))
        return KmerSet(self.k, merged, _sorted=True)

    def remove_kmers(self, kmers: np.ndarray) -> "KmerSet":
        """Returns a new set with the k-mers removed (reference Remove,
        lib/core/kmer_set.h:89-96)."""
        keep = ~np.isin(self.kmers, np.asarray(kmers, dtype=np.int64))
        return KmerSet(self.k, self.kmers[keep], _sorted=True)

    def find(self, pred=None) -> np.ndarray:
        """All k-mers, optionally filtered by a vectorized predicate
        (reference: lib/core/kmer_set.h:114-161)."""
        if pred is None:
            return self.kmers.copy()
        return self.kmers[pred(self.kmers)]

    # -- set algebra (reference: lib/core/kmer_set.h:164-219,285-305) ------

    def union(self, other: "KmerSet") -> "KmerSet":
        return KmerSet(self.k, np.union1d(self.kmers, other.kmers), _sorted=True)

    def subtract(self, other: "KmerSet") -> "KmerSet":
        keep = ~_isin_sorted(self.kmers, other.kmers)
        return KmerSet(self.k, self.kmers[keep], _sorted=True)

    def intersection(self, other: "KmerSet") -> "KmerSet":
        common = self.kmers[_isin_sorted(self.kmers, other.kmers)]
        return KmerSet(self.k, common, _sorted=True)

    def diff_count(self, other: "KmerSet") -> int:
        """Number of k-mers in exactly one of the two sets
        (reference: lib/core/kmer_set.h:189-214)."""
        inter = int(np.count_nonzero(_isin_sorted(self.kmers, other.kmers)))
        return self.size() + other.size() - 2 * inter

    def equals(self, other: "KmerSet") -> bool:
        return self.size() == other.size() and bool(np.array_equal(self.kmers, other.kmers))

    def hash(self) -> int:
        """Order-independent XOR hash over packed bits, identical to the
        reference's value (reference: lib/core/kmer_set.h:221-244 XORs
        kmer.Bits() over all elements).  Returned as unsigned.  The span
        "set.hash"."""
        with trace.span("set.hash"):
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


def _isin_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Membership of sorted-unique a in sorted-unique b, via binary search."""
    if b.size == 0:
        return np.zeros(a.shape, dtype=bool)
    idx = np.searchsorted(b, a)
    idx = np.minimum(idx, b.shape[0] - 1)
    return b[idx] == a


def intersection_size(a: np.ndarray, b: np.ndarray) -> int:
    """|a ∩ b| for sorted-unique arrays — the similarity-sketch kernel
    (reference: lib/core/kmer_set_set.h:158-184 sorted-merge loop).

    The native one-pass merge wins when the sizes are comparable (the
    sketch case: same sampled buckets of related sets); binary search
    wins when one side is much smaller (O(m log n) beats O(m + n))."""
    if a.size == 0 or b.size == 0:
        return 0
    if a.size > b.size:
        a, b = b, a
    if b.size <= 32 * a.size:
        from . import native

        got = native.intersect_size(a, b)
        if got is not None:
            return got
    return int(np.count_nonzero(_isin_sorted(a, b)))
