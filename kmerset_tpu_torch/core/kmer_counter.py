"""KmerCounter on an explicit torch device.

Subclass of kmerset_tpu.core.kmer_counter.KmerCounter.  Its construction
editions send every non-empty input to the port's device count on the
counter's device: in one shot (ops/backend.device_count) up to the
device's one-shot ceiling (backend.window_ceiling), in halo chunks merged
on the host (backend.device_count_chunked) above it.  There is no size
threshold, mesh or host fallback.  Everything after counting
(saturating counts, the cutoff filter of to_kmer_set, queries) is the
reference's own code.
"""

from __future__ import annotations

from typing import List

import numpy as np

from kmerset_tpu.core import io as core_io
from kmerset_tpu.core import kmer_counter as ref
from kmerset_tpu.core import native

from .. import resolve_device
from ..ops import backend

DEFAULT_VALUE_MAX = ref.DEFAULT_VALUE_MAX


class KmerCounter(ref.KmerCounter):
    def __init__(
        self, k: int, kmers: np.ndarray | None = None,
        counts: np.ndarray | None = None,
        value_max: int = DEFAULT_VALUE_MAX, *, device,
    ):
        super().__init__(k, kmers, counts, value_max)
        self.device = resolve_device(device)

    @classmethod
    def from_fasta(
        cls, k: int, file_name: str, decompressor: str, canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device,
    ) -> "KmerCounter":
        """FASTA file (optionally piped through `decompressor`) -> counter.
        Raises core.io.IOError_ on unreadable or malformed input."""
        if native.get_lib() is None:
            lines = core_io.read_lines(file_name, decompressor)
            return cls.from_fasta_lines(
                k, lines, canonical, value_max, device=device
            )
        data = core_io.read_file_bytes(file_name, decompressor)
        try:
            codes, offsets = native.parse_fasta_bytes(data)
        except ValueError as e:
            raise core_io.IOError_(str(e)) from e
        return cls._from_codes(
            k, codes, offsets, canonical, value_max, device=device
        )

    @classmethod
    def from_fasta_lines(
        cls, k: int, lines: List[str], canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device,
    ) -> "KmerCounter":
        reads = core_io.parse_fasta_lines(lines)
        return cls.from_reads(k, reads, canonical, value_max, device=device)

    @classmethod
    def from_reads(
        cls, k: int, reads: List[str], canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device,
    ) -> "KmerCounter":
        codes, offsets = core_io.reads_to_codes(reads)
        return cls._from_codes(
            k, codes, offsets, canonical, value_max, device=device
        )

    @classmethod
    def _from_codes(
        cls, k: int, codes: np.ndarray, offsets: np.ndarray, canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device,
    ) -> "KmerCounter":
        device = resolve_device(device)
        n_windows = codes.shape[0] - k + 1
        if n_windows <= 0:
            return cls(k, None, None, value_max, device=device)
        if n_windows > backend.window_ceiling(k, backend.memory_budget(device)):
            # Raw merged counts; saturated below, after the merge.
            uniq, counts = backend.device_count_chunked(
                codes, offsets, k, canonical, device=device
            )
        else:
            uniq, counts = backend.device_count(
                codes, offsets, k, canonical, device=device,
                value_max=value_max,
            )
        return cls(
            k, uniq, np.minimum(counts, value_max), value_max, device=device
        )
