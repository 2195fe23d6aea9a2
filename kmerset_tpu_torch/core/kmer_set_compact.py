"""KmerSetCompact on an explicit torch device: an immutable compressed
k-mer set, held as its SPSS strings.

The port's own class, with the reference's base class
(kmerset_tpu/core/kmer_set_compact.py:29-182) folded in.  The on-disk
format is the reference's: one ACGT string per line, optionally piped
through an external compressor (reference: kmer_set_compact.h:62-87).
In memory the strings are a PackedStrings, 2-bit packed between uses
(pack_in_memory), and the sorted decoded k-mer array is cached.

What differs from the reference's:
- the build (from_kmer_set, reference :99-120) runs the unitig graph
  front-end on the compact's device through the port's
  spss.get_spss_canonical or, directed, spss.get_spss; with a `mesh`
  (parallel/mesh.Mesh) the build and the decode run on its shards;
- a lazy build (lazy=True, the multi-set loop's deferred construction)
  stores (kmers, canonical, fast, the KmerSet's resident handle) and
  builds the same way on first use of the strings (the spss property,
  reference :42-67, 115), the handle re-attached to the set it builds
  (the front-end validates it then);
- the decode (kmers, reference :125-133) runs through the port's
  spss.decode_unique_kmers on the compact's device.
The setter, pack_in_memory, dump, load, size, weight and sampled_kmers
are the reference's.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from .. import resolve_device
from ..utils import trace
from . import io as core_io
from . import spss as spss_mod
from .config import KConfig
from .kmer_set import KmerSet
from .strings import Packed2Strings, PackedStrings

logger = logging.getLogger("kmerset")


class KmerSetCompact:
    __slots__ = (
        "k", "_spss", "_spss2", "_pending", "_kmers_cache", "_cache_canonical",
        "device", "mesh",
    )

    def __init__(
        self, k: int, spss: Optional[PackedStrings], *, device, mesh=None
    ):
        self.k = k
        self._spss = spss
        self._spss2 = None  # 2-bit packed resident form (pack_in_memory)
        self._pending = None
        self._kmers_cache: Optional[np.ndarray] = None
        self._cache_canonical: Optional[bool] = None
        self.device = resolve_device(device)
        self.mesh = mesh

    @property
    def spss(self) -> PackedStrings:
        """The SPSS strings; a lazy set builds them here on first use, the
        canonical front-end on the compact's device.  Sets packed in
        memory (pack_in_memory) unpack fresh per access — deliberately
        uncached, so resident multi-set state stays at 2 bits/base."""
        if self._spss is None and self._spss2 is not None:
            return self._spss2.unpack()
        if self._spss is None:
            kmers, canonical, fast, resident = self._pending
            ks = KmerSet(self.k, kmers, _sorted=True)
            ks.device = resident
            with trace.timed("compact.deferred_build",
                             kmers=int(kmers.shape[0])) as sp:
                if canonical:
                    built = spss_mod.get_spss_canonical(
                        ks, fast, device=self.device, mesh=self.mesh
                    )
                else:
                    built = spss_mod.get_spss(ks, device=self.device,
                                              mesh=self.mesh)
            logger.debug(
                "kmer_set_compact: deferred SPSS build %.4f s (%d k-mers)",
                sp.seconds, kmers.shape[0],
            )
            self._spss = built
            self._pending = None
        return self._spss

    @spss.setter
    def spss(self, value: PackedStrings) -> None:
        self._spss = value
        self._spss2 = None
        self._pending = None
        # The cached decode belonged to the previous strings.
        self._kmers_cache = None
        self._cache_canonical = None

    def pack_in_memory(self) -> None:
        """Converts the resident string form to 2 bits/base (the
        reference's in-memory density for SPSS bits,
        lib/core/kmer_set_compact.h:339-347).  The decoded-kmers cache
        stays resident: it is the multi-set greedy loop's working set.
        Lazy (unbuilt) sets are left alone — packing would force the
        deferred SPSS build."""
        if self._spss is not None:
            self._spss2 = Packed2Strings.from_packed_strings(self._spss)
            self._spss = None

    # -- conversions (reference: kmer_set_compact.h:36-55) -----------------

    @classmethod
    def from_kmer_set(
        cls, kmer_set: KmerSet, canonical: bool, fast: bool = True,
        lazy: bool = False, *, device, mesh=None,
    ) -> "KmerSetCompact":
        """Builds the SPSS (graph front-end on `device`, walk and path
        cover on the host; or all of it on `mesh`), now or, with
        lazy=True, when the strings are first used, and keeps the source
        k-mers as the decode cache, as the reference does."""
        obj = cls(kmer_set.k, None, device=device, mesh=mesh)
        obj._pending = (kmer_set.kmers, canonical, fast, kmer_set.device)
        if not lazy:
            obj.spss  # noqa: B018 - build now
        obj._kmers_cache = kmer_set.kmers
        obj._cache_canonical = canonical
        return obj

    def to_kmer_set(self, canonical: bool) -> KmerSet:
        return KmerSet(self.k, self.kmers(canonical), _sorted=True)

    def kmers(self, canonical: bool) -> np.ndarray:
        """Sorted unique decoded k-mers (cached), decoded on the device."""
        if self._kmers_cache is None or self._cache_canonical != canonical:
            self._kmers_cache = spss_mod.decode_unique_kmers(
                self.spss, self.k, canonical, device=self.device, mesh=self.mesh
            )
            self._cache_canonical = canonical
        return self._kmers_cache

    # -- persistence (reference: kmer_set_compact.h:57-87) -----------------

    def dump(self, file_name: str, compressor: str = "") -> None:
        """Writes the SPSS strings one per line (the span "io.dump"; a
        deferred build runs inside it)."""
        with trace.span("io.dump", file=file_name) as sp:
            data = self.spss.to_lines_bytes()
            sp.set(bytes=len(data))
            core_io.write_file_bytes(file_name, compressor, data)

    @classmethod
    def load(
        cls, k: int, file_name: str, decompressor: str = "", *, device,
        mesh=None,
    ) -> "KmerSetCompact":
        """A dump's lines as the SPSS, on a device (its decode on `mesh`
        where there is one): the span "io.load"."""
        with trace.span("io.load", file=file_name) as sp:
            data = core_io.read_file_bytes(file_name, decompressor)
            sp.set(bytes=len(data))
            if b"\r" in data:
                # Universal-newline parity with a text-mode reader: a CRLF
                # (or classic-Mac) dump must keep loading.
                data = data.replace(b"\r\n", b"\n").replace(b"\r", b"\n")
            strings = PackedStrings.from_lines_bytes(data)
        return cls(k, strings, device=device, mesh=mesh)

    # -- metrics (reference: kmer_set_compact.h:89-115) --------------------

    def size(self) -> int:
        """Number of stored k-mers: sum of (len - k + 1), equal to the
        distinct-k-mer count since every k-mer appears exactly once, so
        the cached decode answers without forcing a deferred build."""
        if self._spss is None and self._kmers_cache is not None:
            return int(self._kmers_cache.shape[0])
        if self._spss is None and self._spss2 is not None:
            return self._spss2.size_kmers(self.k)
        return self.spss.size_kmers(self.k)

    def weight(self) -> int:
        """Sum of string lengths (pre-compression byte estimate)."""
        if self._spss is None and self._spss2 is not None:
            return self._spss2.weight()  # offsets only; no unpack
        return self.spss.weight()

    # -- similarity sketch (reference: kmer_set_compact.h:117-203) ---------

    def sampled_kmers(
        self, config: KConfig, bucket_ids: np.ndarray, canonical: bool
    ) -> np.ndarray:
        """Sorted k-mers whose bucket id (high N bits) is in bucket_ids:
        contiguous slices of the sorted decode."""
        return self.to_kmer_set(canonical).sample_buckets(config, bucket_ids)
