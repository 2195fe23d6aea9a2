"""KmerSetCompact on an explicit torch device.

Subclass of kmerset_tpu.core.kmer_set_compact.KmerSetCompact.  Its
canonical build (from_kmer_set, reference :97-121) runs the unitig graph
front-end on its device through the port's spss.get_spss_canonical; the
directed build is the reference's host get_spss.  Its decode (kmers,
:125-133) runs through the port's spss.decode_unique_kmers on its device.
The dump and metrics are the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from kmerset_tpu.core import kmer_set_compact as ref
from kmerset_tpu.core import spss as ref_spss
from kmerset_tpu.core.kmer_set import KmerSet
from kmerset_tpu.core.strings import PackedStrings

from .. import resolve_device
from . import spss as spss_mod


class KmerSetCompact(ref.KmerSetCompact):
    __slots__ = ("device",)

    def __init__(self, k: int, spss: Optional[PackedStrings], *, device):
        super().__init__(k, spss)
        self.device = resolve_device(device)

    @classmethod
    def from_kmer_set(
        cls, kmer_set: KmerSet, canonical: bool, fast: bool = True, *, device
    ) -> "KmerSetCompact":
        """Builds the SPSS (canonical: graph front-end on `device`, walk
        and path cover on the host; directed: the reference's host build)
        and keeps the source k-mers as the decode cache, as the reference
        does."""
        if canonical:
            built = spss_mod.get_spss_canonical(kmer_set, fast, device=device)
        else:
            built = ref_spss.get_spss(kmer_set)
        obj = cls(kmer_set.k, built, device=device)
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
