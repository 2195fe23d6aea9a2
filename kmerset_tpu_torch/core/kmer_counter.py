"""KmerCounter on an explicit torch device: sort-based k-mer counting.

The port's own class, with the reference's base class
(kmerset_tpu/core/kmer_counter.py:57-343) folded in as far as the port
reaches it: construction, saturating counts and the cutoff filter of
to_kmer_set (:315-343).  Its construction sends every non-empty input to
a mesh of shards where one is given and its gate takes the input
(parallel/driver.mesh_count, the reference's route at :194-200), else to
the port's device count on the counter's device: in one shot
(ops/backend.device_count) up to the device's one-shot ceiling
(backend.window_ceiling), in halo chunks merged on the host
(backend.device_count_chunked) above it.  There is no host fallback, so
none of the reference's deferred counts transfer, host recount or
resident handle (:72-137) is carried over, nor its incremental adds
(:280-313), which no CLI calls.

Counts saturate at value_max like the reference's AddWithMax with its
uint8 default ValueType (reference: lib/core/kmer_counter.h:28-38,48).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import resolve_device
from ..ops import backend
from ..parallel import driver as mesh_driver
from . import io as core_io
from . import native
from .kmer_set import KmerSet

DEFAULT_VALUE_MAX = 255  # uint8 ValueType default (reference: kmer_counter.h:48)


class KmerCounter:
    """Sorted distinct k-mers with saturating counts, counted on a
    device."""

    def __init__(
        self, k: int, kmers: np.ndarray | None = None,
        counts: np.ndarray | None = None,
        value_max: int = DEFAULT_VALUE_MAX, *, device,
    ):
        self.k = k
        self.value_max = value_max
        self.kmers = (
            np.asarray(kmers, dtype=np.int64) if kmers is not None else np.empty(0, np.int64)
        )
        self.counts = (
            np.asarray(counts, dtype=np.int64) if counts is not None else np.empty(0, np.int64)
        )
        self.device = resolve_device(device)

    @classmethod
    def from_fasta(
        cls, k: int, file_name: str, decompressor: str, canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device, mesh=None,
    ) -> "KmerCounter":
        """FASTA file (optionally piped through `decompressor`) -> counter.
        Raises core.io.IOError_ on unreadable or malformed input."""
        if native.get_lib() is None:
            lines = core_io.read_lines(file_name, decompressor)
            return cls.from_fasta_lines(
                k, lines, canonical, value_max, device=device, mesh=mesh
            )
        data = core_io.read_file_bytes(file_name, decompressor)
        try:
            codes, offsets = native.parse_fasta_bytes(data)
        except ValueError as e:
            raise core_io.IOError_(str(e)) from e
        return cls._from_codes(
            k, codes, offsets, canonical, value_max, device=device, mesh=mesh
        )

    @classmethod
    def from_fasta_lines(
        cls, k: int, lines: List[str], canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device, mesh=None,
    ) -> "KmerCounter":
        reads = core_io.parse_fasta_lines(lines)
        return cls.from_reads(
            k, reads, canonical, value_max, device=device, mesh=mesh
        )

    @classmethod
    def from_reads(
        cls, k: int, reads: List[str], canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device, mesh=None,
    ) -> "KmerCounter":
        codes, offsets = core_io.reads_to_codes(reads)
        return cls._from_codes(
            k, codes, offsets, canonical, value_max, device=device, mesh=mesh
        )

    @classmethod
    def _from_codes(
        cls, k: int, codes: np.ndarray, offsets: np.ndarray, canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device, mesh=None,
    ) -> "KmerCounter":
        device = resolve_device(device)
        n_windows = codes.shape[0] - k + 1
        if n_windows <= 0:
            return cls(k, None, None, value_max, device=device)
        if mesh_driver.should_use_mesh(mesh, n_windows):
            # Raw counts out of the mesh; saturated below.
            uniq, counts = mesh_driver.mesh_count(
                codes, offsets, k, canonical, mesh
            )
        elif n_windows > backend.window_ceiling(k, backend.memory_budget(device)):
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

    def to_kmer_set(self, cutoff: int) -> Tuple[KmerSet, int]:
        """Filters out k-mers with count < cutoff; returns (set, n_cut)
        (reference: lib/core/kmer_counter.h:211-243)."""
        if cutoff <= 1:
            # Nothing to filter: reuse the sorted array.
            return KmerSet(self.k, self.kmers, _sorted=True), 0
        keep = self.counts >= cutoff
        n_cut = int(np.count_nonzero(~keep))
        return KmerSet(self.k, self.kmers[keep], _sorted=True), n_cut
