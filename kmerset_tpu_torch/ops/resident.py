"""The counted k-mer set kept resident on its device, from the count to the
SPSS build.

The port's copy of kmerset_tpu/ops/resident.py: DeviceKmers with the
reference's slots and methods (:97-264), less the side-code prefetch
(below).  The count's device outputs become a handle before their
download (ops/backend.device_count); the handle rides KmerCounter ->
KmerSet -> KmerSetCompact, and the graph front-end (ops/unitigs.py)
takes its tensor instead of uploading the host array again.  It is a
hint, never a source of truth: the host array stays authoritative, and a
consumer uses the handle only after valid_for (k, length and both
endpoint values against the host array) and `on` (the front-end's
device); otherwise it uploads the host array, as it would without one.

What differs from the reference's, by design:
- `arr` is the count's key output trimmed to n, as int64 at every k: the
  layout the port's front-end takes.  There is no power-of-two padding
  and no PAD32 tail (the reference's _build_shrink, :41-69, serves XLA's
  shape cache and its int32 lanes);
- filtered compacts the kept keys with kernel B3 (ops/compact.py) where
  min(count, value_max) >= cutoff; the reference sorts them to the front
  behind a fill value (:72-90).  Both give the same sorted prefix;
- the handle is the counted set alone: the reference's side-code
  prefetch and the start of its download (:122-152), which launch the
  slow link's side codes from the count so that their download overlaps
  it, are left out.  The count does not decide the graph front-end's
  route: on a slow link the front-end builds its side codes in the SPSS
  phase, on this handle's tensor without an upload
  (ops/unitigs.device_unitig_sides);
- an error raises: the reference's handle returns None and logs a
  fallback.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import backend
from .compact import compact_select


class DeviceKmers:
    """Sorted unique k-mers resident on a device.

    arr: (n,) int64 tensor; counts: aligned int32 counts (None once
    filtered); first/last: the host array's endpoint values for valid_for
    (None until stamped)."""

    __slots__ = ("arr", "counts", "n", "k", "canonical", "first", "last")

    def __init__(self, arr, counts, n, k, canonical, first, last):
        self.arr = arr
        self.counts = counts
        self.n = int(n)
        self.k = k
        self.canonical = canonical
        self.first = first
        self.last = last

    @classmethod
    def from_count_outputs(
        cls, keys: torch.Tensor, counts: torch.Tensor, n: int, k: int,
        canonical: bool,
    ) -> Optional["DeviceKmers"]:
        """The handle of the count's device outputs (ops/count.
        count_kmers_frag: keys int32 or int64, int32 counts, n of them), or
        None for an empty set.  The keys are copied into their own int64
        tensor, so the count's larger output buffer is freed.  valid_for
        refuses the handle until with_endpoints stamps it (the
        reference's `uniq_host` argument, which stamps it here, has no
        caller in the port)."""
        if n <= 0:
            return None
        arr = keys[:n].to(torch.int64, copy=True)
        return cls(arr, counts[:n], n, k, canonical, None, None)

    def valid_for(self, kmers: np.ndarray, k: int) -> bool:
        """True iff this handle mirrors the host array: same k, same
        length, same endpoint values."""
        n = kmers.shape[0]
        return (
            self.k == k
            and self.n == n
            and n > 0
            and self.first is not None
            and self.first == int(kmers[0])
            and self.last == int(kmers[-1])
        )

    def on(self, device) -> bool:
        """Whether the handle's tensor lies on `device`."""
        return self.arr.device == backend.canonical_device(device)

    def filtered(self, cutoff: int, value_max: int) -> Optional["DeviceKmers"]:
        """A new handle of the k-mers whose saturated count min(count,
        value_max) reaches `cutoff`, compacted in order by kernel B3 (the
        device half of KmerCounter.to_kmer_set; reference
        kmer_counter.h:211-243).  None once filtered (no counts).  The
        caller stamps its endpoints with with_verified_endpoints."""
        if self.counts is None:
            return None
        keep = torch.clamp(self.counts, max=value_max) >= cutoff
        (kept,), n_kept = compact_select([self.arr], keep)
        n = int(backend.download("n_kept", n_kept))
        return DeviceKmers(kept[:n], None, n, self.k, self.canonical, None, None)

    def with_endpoints(self, kmers: np.ndarray) -> Optional["DeviceKmers"]:
        """Stamps the endpoints of the host array that was downloaded from
        this handle's tensor (the count's own download); None when the
        lengths differ.  For a host array derived on its own (the host
        cutoff filter) use with_verified_endpoints."""
        if self.n != kmers.shape[0] or self.n == 0:
            return None
        self.first = int(kmers[0])
        self.last = int(kmers[-1])
        return self

    def with_verified_endpoints(self, kmers: np.ndarray) -> Optional["DeviceKmers"]:
        """Reads back both endpoints and 14 evenly spaced positions of this
        handle's tensor and stamps the endpoints when they equal the host
        array's there; None on any difference (a filtered device copy that
        diverged from the host filter, even with the same length and
        endpoints, must not pass; reference resident.py:228-260)."""
        if self.n != kmers.shape[0] or self.n == 0:
            return None
        idx = np.unique(np.linspace(0, self.n - 1, num=min(self.n, 16), dtype=np.int64))
        at = backend.upload("sample positions", idx, self.arr.device)
        sample = backend.download("sample", self.arr[at])
        if not np.array_equal(sample, kmers[idx]):
            return None
        self.first = int(kmers[0])
        self.last = int(kmers[-1])
        return self

    def graph_input(self) -> torch.Tensor:
        """The tensor in the front-end's input layout (int64 keys)."""
        return self.arr
