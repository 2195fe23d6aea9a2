"""Sorted-array utilities shared by the host containers.

The port's copy of kmerset_tpu/core/arrays.py:9-37, whole: sorted_unique
and sorted_unique_counts (the host count of extract_kmers' k-mers, which
the library's callers use; the port's own count runs on its device).

`np.unique(return_counts=True)` spends ~2x the time of an explicit
sort + boundary-flag pass at the 10M+ scales this package works at
(measured: 10.9s vs 5.7s on 30M int64); these helpers are the lean
replacements used by the counting and decode paths.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """Sorted distinct values of x (np.unique without the overhead)."""
    if x.size == 0:
        return np.asarray(x)
    s = np.sort(x)
    flags = np.empty(s.size, dtype=bool)
    flags[0] = True
    np.not_equal(s[1:], s[:-1], out=flags[1:])
    return s[flags]


def sorted_unique_counts(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted distinct values, multiplicities)."""
    if x.size == 0:
        return np.asarray(x), np.empty(0, dtype=np.int64)
    s = np.sort(x)
    flags = np.empty(s.size, dtype=bool)
    flags[0] = True
    np.not_equal(s[1:], s[:-1], out=flags[1:])
    idx = np.flatnonzero(flags)
    counts = np.diff(np.append(idx, s.size))
    return s[idx], counts
