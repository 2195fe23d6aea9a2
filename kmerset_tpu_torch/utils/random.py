"""Seeded draws of the multi-set compressor.

The port's copy of get_random_ints from kmerset_tpu/utils/random.py:17-34
(the rest of that module makes test data).  The same seed gives the same
draws as kmerset_tpu's, so the bucket sample of the similarity sketch,
and with it every compressed directory, is kmerset_tpu's byte for byte.
It takes an explicit numpy Generator where the original project's
GetRandomInts draws from an unseeded generator (reference:
lib/core/random.h:17).
"""

from __future__ import annotations

import numpy as np


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
