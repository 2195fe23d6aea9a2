"""KmerSetCompact on an explicit torch device.

Subclass of kmerset_tpu.core.kmer_set_compact.KmerSetCompact.  Its
canonical build (from_kmer_set, reference :97-121) runs the unitig graph
front-end on its device through the port's spss.get_spss_canonical; the
directed build is the reference's host get_spss.  A lazy build
(lazy=True, the multi-set loop's deferred construction) stores
(kmers, canonical, fast) and builds the same way on first use of the
strings: the spss property is overridden, getter and setter, because the
reference's builds through the reference's own routing (:42-67).  Its
decode (kmers, :125-133) runs through the port's spss.decode_unique_kmers
on its device, and load (:144-151) makes a compact on a device.  The dump,
pack_in_memory, size, weight and sampled_kmers are the reference's.

The reference's pending tuple also carries the KmerSet's resident device
handle; the port has none (ROADMAP A.9), so its tuple carries no handle.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np

from kmerset_tpu.core import kmer_set_compact as ref
from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet
from kmerset_tpu.core.strings import PackedStrings

from .. import resolve_device
from . import spss as spss_mod

logger = logging.getLogger("kmerset")


class KmerSetCompact(ref.KmerSetCompact):
    __slots__ = ("device",)

    def __init__(self, k: int, spss: Optional[PackedStrings], *, device):
        super().__init__(k, spss)
        self.device = resolve_device(device)

    @property
    def spss(self) -> PackedStrings:
        """The SPSS strings; a lazy set builds them here on first use, the
        canonical front-end on the compact's device (reference :42-67)."""
        if self._spss is None and self._spss2 is not None:
            return self._spss2.unpack()
        if self._spss is None:
            kmers, canonical, fast = self._pending
            ks = KmerSet(self.k, kmers, _sorted=True)
            t0 = time.perf_counter()
            if canonical:
                built = spss_mod.get_spss_canonical(ks, fast, device=self.device)
            else:
                built = ref_spss.get_spss(ks)
            logger.debug(
                "kmer_set_compact: deferred SPSS build %.4f s (%d k-mers)",
                time.perf_counter() - t0, kmers.shape[0],
            )
            self._spss = built
            self._pending = None
        return self._spss

    @spss.setter
    def spss(self, value: PackedStrings) -> None:
        ref.KmerSetCompact.spss.fset(self, value)

    @classmethod
    def from_kmer_set(
        cls, kmer_set: KmerSet, canonical: bool, fast: bool = True,
        lazy: bool = False, *, device,
    ) -> "KmerSetCompact":
        """Builds the SPSS (canonical: graph front-end on `device`, walk
        and path cover on the host; directed: the reference's host build),
        now or, with lazy=True, when the strings are first used, and keeps
        the source k-mers as the decode cache, as the reference does."""
        obj = cls(kmer_set.k, None, device=device)
        obj._pending = (kmer_set.kmers, canonical, fast)
        if not lazy:
            obj.spss  # noqa: B018 - build now
        obj._kmers_cache = kmer_set.kmers
        obj._cache_canonical = canonical
        return obj

    def kmers(self, canonical: bool) -> np.ndarray:
        """Sorted unique decoded k-mers (cached), decoded on the device."""
        if self._kmers_cache is None or self._cache_canonical != canonical:
            self._kmers_cache = spss_mod.decode_unique_kmers(
                self.spss, self.k, canonical, device=self.device
            )
            self._cache_canonical = canonical
        return self._kmers_cache

    @classmethod
    def load(
        cls, k: int, file_name: str, decompressor: str = "", *, device
    ) -> "KmerSetCompact":
        """The reference's load (a dump's lines as the SPSS), on a
        device."""
        loaded = ref.KmerSetCompact.load(k, file_name, decompressor)
        return cls(k, loaded.spss, device=device)
