"""SPSS decode on an explicit torch device.

Editions of kmerset_tpu.core.spss.decode_unique_kmers (:1087-1118) and
get_kmer_set_from_spss (:1121-1124) that decode through the port's
device_unique.  The SPSS build itself is the reference's host code
(kmerset_tpu.core.spss.get_spss_canonical), called as it is.
"""

from __future__ import annotations

import numpy as np

from kmerset_tpu.core.kmer_set import KmerSet
from kmerset_tpu.core.strings import PackedStrings

from ..ops import backend


def decode_unique_kmers(
    spss: PackedStrings, k: int, canonical: bool, *, device
) -> np.ndarray:
    """Sorted distinct (canonical) k-mers of an SPSS, counted on `device`
    at cutoff 1."""
    if int(spss.codes.shape[0]) - k + 1 <= 0:
        return np.empty(0, np.int64)
    return backend.device_unique(
        spss.codes, spss.offsets, k, canonical, device=device
    )


def get_kmer_set_from_spss(
    spss: PackedStrings, k: int, canonical: bool, *, device
) -> KmerSet:
    return KmerSet(
        k, decode_unique_kmers(spss, k, canonical, device=device), _sorted=True
    )
