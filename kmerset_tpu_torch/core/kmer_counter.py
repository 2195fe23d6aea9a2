"""KmerCounter on an explicit torch device: sort-based k-mer counting.

The port's own class, with the reference's base class
(kmerset_tpu/core/kmer_counter.py:57-343) folded in: construction,
saturating counts, the incremental adds (add, _flush, size, get,
:280-313) and the cutoff filter of to_kmer_set (:315-343), which flushes
pending adds first; and its copy of extract_kmers (:27-54), the host
window extraction of the library surface (PackedStrings.all_kmers, the
test-data generators).  from_fasta parses a plain file on a CUDA device
with no mesh on the device (backend.parse_route: kernel P1,
ops/parse.py), so that the codes and offsets the count takes never reach
the host; every other input the host parses.  Its construction sends
every non-empty input to a mesh of shards where one is given and its
gate takes the input
(parallel/driver.mesh_count, the reference's route at :194-200), else to
the port's device count on the counter's device: in one shot
(ops/backend.device_count) up to the device's one-shot ceiling
(backend.window_ceiling), in halo chunks merged on the host
(backend.device_count_chunked) above it.  The one-shot count keeps the
counted set resident on the device (ops/resident.DeviceKmers, in
`_device`, reference :226-246): _flush drops it, and to_kmer_set hands
it to the KmerSet, filtered on the device above cutoff 1 (:315-343), so
that the SPSS build's front-end takes it without an upload.  Left out by
design: the deferred counts transfer and its host recount (:72-137),
because the port has no host fallback and its counts are eager, so
`counts` is a plain attribute; and the reference's flag that a build
follows (:144), on which its count launches the slow link's side codes
early: the port's count does not decide the graph front-end's route,
which builds them in the SPSS phase on the resident set
(ops/unitigs.device_unitig_sides).

Counts saturate at value_max like the reference's AddWithMax with its
uint8 default ValueType (reference: lib/core/kmer_counter.h:28-38,48).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import resolve_device
from ..ops import backend
from ..parallel import driver as mesh_driver
from ..utils import trace
from . import io as core_io
from . import kmer as kmer_ops
from . import native
from .kmer_set import KmerSet

DEFAULT_VALUE_MAX = 255  # uint8 ValueType default (reference: kmer_counter.h:48)


def extract_kmers(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool
) -> np.ndarray:
    """All k-mers from concatenated fragments, canonicalized if asked.

    codes: flat 2-bit codes; offsets: fragment boundaries (windows never
    cross a fragment boundary, replicating the split-at-'N' behavior,
    reference: lib/core/kmer_counter.h:78-96).
    """
    n_pos = codes.shape[0] - k + 1
    if n_pos <= 0:
        return np.empty(0, dtype=np.int64)
    windows = kmer_ops.kmers_from_codes(codes, k)
    # Window at p is valid iff it does not straddle a fragment boundary:
    # every interior boundary b invalidates starts [b-k+1, b).  Marked via
    # a difference array + cumsum (two tiny scatters instead of two
    # n_pos-sized binary-search passes).
    bounds = offsets[1:-1] if offsets.shape[0] > 2 else np.empty(0, np.int64)
    d = np.zeros(n_pos + 1, dtype=np.int32)
    lo = np.maximum(bounds - k + 1, 0)
    hi = np.minimum(bounds, n_pos)
    np.add.at(d, lo[lo < hi], 1)
    np.add.at(d, hi[lo < hi], -1)
    invalid = np.cumsum(d[:-1]) > 0
    kmers = windows[~invalid]
    if canonical:
        kmers = kmer_ops.canonical(kmers, k)
    return kmers


def _parse_on_device(file_name: str, device, sp):
    """(codes, offsets) of the FASTA file on `device`, parsed there:
    backend.upload_file, then kernel P1 (ops/parse.parse), under the
    device's lock.  Raises core.io.IOError_ as the host route does.  The
    file's bytes are freed on return, before the count plans its
    budget."""
    from ..ops import parse

    with backend.device_lock(device):
        try:
            data = backend.upload_file(file_name, device)
        except OSError as e:
            raise core_io.IOError_(f"failed to open file: {file_name}") from e
        sp.set(bytes=int(data.shape[0]))
        try:
            codes, offsets = parse.parse(data)
        except ValueError as e:
            raise core_io.IOError_(str(e)) from e
    trace.add("parse.device")
    return codes, offsets


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
        self._pending: List[Tuple[int, int]] = []
        self._device = None  # the resident handle (ops/resident.DeviceKmers)

    @classmethod
    def from_fasta(
        cls, k: int, file_name: str, decompressor: str, canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device, mesh=None,
    ) -> "KmerCounter":
        """FASTA file (optionally piped through `decompressor`) -> counter.
        Raises core.io.IOError_ on unreadable or malformed input.  The
        span "count.construct", and in it "count.parse" (the read and the
        parse), then the count's own.  Where backend.parse_route takes the
        file (CUDA, no mesh, no decompressor), its bytes go to the device
        and kernel P1 parses them there (_parse_on_device): the codes and
        offsets stay on the device, and the count packs them there; else
        the host parses them.  Counters parse.device and parse.host count
        the parses by route."""
        with trace.span("count.construct"):
            with trace.span("count.parse", file=file_name) as sp:
                if backend.parse_route(file_name, decompressor, device, mesh):
                    codes, offsets = _parse_on_device(file_name, device, sp)
                elif native.get_lib() is None:
                    reads = core_io.parse_fasta_lines(
                        core_io.read_lines(file_name, decompressor))
                    codes, offsets = core_io.reads_to_codes(reads)
                    trace.add("parse.host")
                else:
                    data = core_io.read_file_bytes(file_name, decompressor)
                    sp.set(bytes=len(data))
                    try:
                        codes, offsets = native.parse_fasta_bytes(data)
                    except ValueError as e:
                        raise core_io.IOError_(str(e)) from e
                    del data
                    trace.add("parse.host")
                sp.set(codes=int(codes.shape[0]))
            return cls._from_codes(k, codes, offsets, canonical, value_max,
                                   device=device, mesh=mesh)

    @classmethod
    def from_fasta_lines(
        cls, k: int, lines: List[str], canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device, mesh=None,
    ) -> "KmerCounter":
        reads = core_io.parse_fasta_lines(lines)
        return cls.from_reads(k, reads, canonical, value_max, device=device,
                              mesh=mesh)

    @classmethod
    def from_reads(
        cls, k: int, reads: List[str], canonical: bool,
        value_max: int = DEFAULT_VALUE_MAX, *, device, mesh=None,
    ) -> "KmerCounter":
        codes, offsets = core_io.reads_to_codes(reads)
        return cls._from_codes(k, codes, offsets, canonical, value_max,
                               device=device, mesh=mesh)

    @classmethod
    def _from_codes(
        cls, k: int, codes, offsets, canonical: bool,
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
        elif (chunk := backend.count_plan("count", n_windows, k, device)) < n_windows:
            # Raw merged counts; saturated below, after the merge.
            uniq, counts = backend.device_count_chunked(
                codes, offsets, k, canonical, device=device, chunk_windows=chunk
            )
        else:
            uniq, counts, handle = backend.device_count(
                codes, offsets, k, canonical, device=device,
                value_max=value_max, resident=True,
            )
            counter = cls(
                k, uniq, np.minimum(counts, value_max), value_max, device=device
            )
            counter._device = handle
            return counter
        return cls(
            k, uniq, np.minimum(counts, value_max), value_max, device=device
        )

    # -- incremental adds (reference Add, lib/core/kmer_counter.h:257-264) --

    def add(self, kmer: int, v: int = 1) -> "KmerCounter":
        self._pending.append((int(kmer), int(v)))
        return self

    def _flush(self) -> None:
        """Sums the pending adds into the sorted arrays, saturating at
        value_max."""
        if not self._pending:
            return
        self._device = None  # adds leave the resident set behind
        pend = np.array(self._pending, dtype=np.int64)
        self._pending.clear()
        all_k = np.concatenate([self.kmers, pend[:, 0]])
        all_v = np.concatenate([self.counts, pend[:, 1]])
        order = np.argsort(all_k, kind="stable")
        all_k, all_v = all_k[order], all_v[order]
        uniq, start = np.unique(all_k, return_index=True)
        sums = np.add.reduceat(all_v, start)
        self.kmers = uniq
        self.counts = np.minimum(sums, self.value_max)

    # -- queries -----------------------------------------------------------

    def size(self) -> int:
        self._flush()
        return int(self.kmers.shape[0])

    def get(self, kmer: int) -> int:
        self._flush()
        idx = np.searchsorted(self.kmers, kmer)
        if idx < self.kmers.shape[0] and self.kmers[idx] == kmer:
            return int(self.counts[idx])
        return 0

    def to_kmer_set(self, cutoff: int) -> Tuple[KmerSet, int]:
        """Filters out k-mers with count < cutoff; returns (set, n_cut)
        (reference: lib/core/kmer_counter.h:211-243).  The resident
        handle goes with the set: as it is at cutoff <= 1, else filtered
        on the device and stamped where a read-back sample equals the host
        filter's array (reference kmer_counter.py:315-343).  A handle that
        valid_for refuses (one left behind by adds) is dropped; a device
        filter that disagrees with the host filter raises, where the
        reference's drops the handle.  The span "count.filter"."""
        with trace.span("count.filter", cutoff=cutoff):
            return self._to_kmer_set(cutoff)

    def _to_kmer_set(self, cutoff: int) -> Tuple[KmerSet, int]:
        self._flush()
        res = self._device
        if res is not None and not res.valid_for(self.kmers, self.k):
            res = None
        if cutoff <= 1:
            # Nothing to filter: reuse the sorted array.
            ks = KmerSet(self.k, self.kmers, _sorted=True)
            ks.device = res
            return ks, 0
        keep = self.counts >= cutoff
        n_cut = int(np.count_nonzero(~keep))
        ks = KmerSet(self.k, self.kmers[keep], _sorted=True)
        if res is not None:
            # Both filters take min(count, value_max) >= cutoff of the same
            # counts: a difference is a fault of the device filter, and it
            # raises rather than leave the host array to stand in for it.
            kept = res.filtered(cutoff, self.value_max)
            if kept is None or kept.n != ks.size():
                raise RuntimeError(
                    f"the resident handle's cutoff filter kept "
                    f"{None if kept is None else kept.n} k-mers, the host "
                    f"filter {ks.size()}")
            if kept.n:
                ks.device = kept.with_verified_endpoints(ks.kmers)
                if ks.device is None:
                    raise RuntimeError(
                        f"the resident handle's cutoff filter kept {kept.n} "
                        f"k-mers that differ from the host filter's at a "
                        f"read-back sample")
        return ks, n_cut
