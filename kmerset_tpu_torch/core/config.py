"""Per-k configuration: bucket bits N and key width.

The port's copy of kmerset_tpu/core/config.py:1-61, unchanged.

Mirrors the k dispatch table used by every reference CLI
(reference: src/kmerset-build.cc:130-143):

    k=15 -> N=14, uint16 keys
    k=19 -> N=10, uint32 keys
    k=23 -> N=14, uint32 keys

k=31 (N=14, uint64-class keys) is an extension used for the large sharded
configurations; the reference itself supports only {15, 19, 23}
(reference: README.md:218).

The library is generic over k in [2, 31] (tests use k=9, N=10 like the
reference's randomized tests, reference: test/spss.cc:15-23); the CLI layer
enforces the supported set.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KConfig:
    k: int
    n: int  # number of high bits selecting a bucket

    @property
    def kmer_bits(self) -> int:
        return 2 * self.k

    @property
    def key_bits(self) -> int:
        return 2 * self.k - self.n

    @property
    def n_buckets(self) -> int:
        return 1 << self.n


# CLI-supported configurations (reference: src/kmerset-build.cc:130-143).
K_CONFIGS = {
    15: KConfig(k=15, n=14),
    19: KConfig(k=19, n=10),
    23: KConfig(k=23, n=14),
    31: KConfig(k=31, n=14),
}

CLI_SUPPORTED_K = (15, 19, 23, 31)


def get_config(k: int, n: int | None = None) -> KConfig:
    """Returns a KConfig for any k in [2, 31]; n defaults per the CLI table."""
    if not 2 <= k <= 31:
        raise ValueError(f"unsupported k value: {k}")
    if n is None:
        if k in K_CONFIGS:
            return K_CONFIGS[k]
        n = min(10, 2 * k - 2)
    return KConfig(k=k, n=n)
