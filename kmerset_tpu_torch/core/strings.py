"""PackedStrings: a ragged set of DNA strings as flat 2-bit codes + offsets.

The port's copy of kmerset_tpu/core/strings.py:10-224, whole.
all_kmers (:163-168) is the host decode of the library surface, through
core/kmer_counter.extract_kmers as in the reference; the port's own
decode of a compact set runs on its device
(core/spss.py:decode_unique_kmers).

The reference passes std::vector<std::string> of ACGT text between SPSS
phases (reference: lib/core/spss.h).  The TPU-native layout is structure-of-
arrays: one flat array of 2-bit base codes plus an offsets array, so
whole-set operations (complement, k-mer window extraction, concatenation)
are single vectorized passes instead of per-string loops.
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

from ..utils import trace
from . import kmer as kmer_ops


class PackedStrings:
    """Flat code array + offsets; string i is codes[offsets[i]:offsets[i+1]]."""

    __slots__ = ("codes", "offsets")

    def __init__(self, codes: np.ndarray, offsets: np.ndarray):
        self.codes = np.asarray(codes, dtype=np.uint8)
        self.offsets = np.asarray(offsets, dtype=np.int64)

    @classmethod
    def empty(cls) -> "PackedStrings":
        return cls(np.empty(0, np.uint8), np.zeros(1, np.int64))

    @classmethod
    def from_strings(cls, strings: Iterable[str]) -> "PackedStrings":
        strings = list(strings)
        blob = "".join(strings).encode()
        codes = kmer_ops.BASE_TO_CODE[np.frombuffer(blob, dtype=np.uint8)]
        if codes.size and (codes > 3).any():
            raise ValueError("strings must contain only A/C/G/T")
        lengths = np.fromiter((len(s) for s in strings), dtype=np.int64, count=len(strings))
        offsets = np.zeros(len(strings) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        return cls(codes, offsets)

    @classmethod
    def from_code_lists(cls, code_lists: List[np.ndarray]) -> "PackedStrings":
        if not code_lists:
            return cls.empty()
        codes = np.concatenate([np.asarray(c, dtype=np.uint8) for c in code_lists])
        lengths = np.fromiter((len(c) for c in code_lists), dtype=np.int64, count=len(code_lists))
        offsets = np.zeros(len(code_lists) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offsets[1:])
        return cls(codes, offsets)

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def n(self) -> int:
        return len(self)

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def weight(self) -> int:
        """Sum of string lengths (reference Weight,
        lib/core/kmer_set_compact.h:115)."""
        return int(self.offsets[-1])

    def size_kmers(self, k: int) -> int:
        """Sum of (len - k + 1), clamped at 0 per string (reference Size,
        lib/core/kmer_set_compact.h:90-112 — which underflows its uint32
        lengths on strings shorter than k; such strings hold no k-mers,
        so the clamp agrees with all_kmers instead)."""
        return int(np.sum(np.maximum(self.lengths() - k + 1, 0)))

    def get_codes(self, i: int) -> np.ndarray:
        return self.codes[self.offsets[i] : self.offsets[i + 1]]

    def to_strings(self) -> List[str]:
        blob = kmer_ops.CODE_TO_BASE[self.codes].tobytes().decode()
        offs = self.offsets
        return [blob[offs[i] : offs[i + 1]] for i in range(len(self))]

    def to_lines_bytes(self) -> bytes | bytearray:
        """The newline-terminated ASCII dump blob (exactly what
        write_lines produces from to_strings): the native codec's one pass
        (csrc/lines.c) into a bytearray (counter "lines.native"), else
        vectorized numpy passes ("lines.numpy")."""
        from . import native

        out = native.lines_encode(self.codes, self.offsets)
        if out is not None:
            trace.add("lines.native")
            return out
        trace.add("lines.numpy")
        n = len(self)
        total = int(self.offsets[-1])
        if n == 0:
            return b""
        out = np.empty(total + n, dtype=np.uint8)
        # Each base shifts right by the number of preceding newlines
        # (= its string index); newlines land at offsets[i+1] + i.
        row = np.repeat(np.arange(n, dtype=np.int64), self.lengths())
        idx = np.arange(total, dtype=np.int64) + row
        out[idx] = kmer_ops.CODE_TO_BASE[self.codes]
        out[self.offsets[1:] + np.arange(n, dtype=np.int64)] = ord("\n")
        return out.tobytes()

    @classmethod
    def from_lines_bytes(cls, data: bytes) -> "PackedStrings":
        """Inverse of to_lines_bytes: parses a newline-separated ACGT
        blob (with or without a trailing newline) in the native codec's
        one pass (counter "lines.native"), else in vectorized numpy
        passes ("lines.numpy").  Raises ValueError on any non-ACGT/newline
        byte — the same error the from_strings path raises for invalid
        dumps.  Callers wanting universal-newline tolerance normalize \\r
        first (see KmerSetCompact.load)."""
        from . import native

        if data in (b"", b"\n"):
            # read_lines parity: one trailing newline of an empty dump
            # strips to nothing (KmerSetCompact.load maps [""] to []).
            data = b""
        parsed = native.lines_decode(data)
        if parsed is not None:
            trace.add("lines.native")
            return cls(*parsed)
        trace.add("lines.numpy")
        if data[-1:] not in (b"", b"\n"):
            data = data + b"\n"
        raw = np.frombuffer(data, dtype=np.uint8)
        nl = raw == ord("\n")
        codes_all = kmer_ops.BASE_TO_CODE[raw]
        if (codes_all[~nl] > 3).any():
            raise ValueError("strings must contain only A/C/G/T")
        nl_pos = np.flatnonzero(nl)
        n = nl_pos.shape[0]
        # String i spans (prev_nl, nl_pos[i]); subtracting the i
        # preceding newlines from nl_pos gives the packed offsets.
        offsets = np.zeros(n + 1, dtype=np.int64)
        offsets[1:] = nl_pos - np.arange(n, dtype=np.int64)
        return cls(codes_all[~nl], offsets)

    # -- whole-set transforms ---------------------------------------------

    def _require_min_len(self, k: int) -> None:
        lens = self.lengths()
        if lens.size and int(lens.min()) < k:
            # Without this, the suffix gather would wrap Python-negative
            # indices into the tail of the codes array and return
            # well-formed-looking garbage k-mers.
            raise ValueError(
                f"every string must be >= k={k} bases (min is {int(lens.min())})"
            )

    def first_kmers(self, k: int) -> np.ndarray:
        """Packed k-prefix of every string (all lengths must be >= k)."""
        from . import native

        self._require_min_len(k)
        out = native.pack_rows(self.codes, self.offsets, k, from_end=False)
        if out is not None:
            return out
        idx = self.offsets[:-1, None] + np.arange(k)
        return _pack(self.codes, idx, k)

    def last_kmers(self, k: int) -> np.ndarray:
        """Packed k-suffix of every string (all lengths must be >= k)."""
        from . import native

        self._require_min_len(k)
        out = native.pack_rows(self.codes, self.offsets, k, from_end=True)
        if out is not None:
            return out
        idx = self.offsets[1:, None] - k + np.arange(k)
        return _pack(self.codes, idx, k)

    def all_kmers(self, k: int, canonical: bool) -> np.ndarray:
        """Every k-window of every string, with duplicates — the decode
        direction (reference GetKmerSetFromSPSS, lib/core/spss.h:1862-1941)."""
        from .kmer_counter import extract_kmers

        return extract_kmers(self.codes, self.offsets, k, canonical)


class Packed2Strings:
    """2-bit-packed resident form of a PackedStrings: 4 bases/byte plus
    the offsets array — the in-memory density of the reference's
    vector<bool> SPSS bits (reference: lib/core/kmer_set_compact.h:
    339-347, which packs 2 bits/base + streamvbyte lengths).  Multi-set
    compression keeps 100+ compact sets resident at once; storing them
    packed cuts the string RSS ~4x.  Metrics (count/weight/lengths) are
    answered from the offsets without unpacking; `unpack()` materializes
    a fresh PackedStrings per consuming phase (deliberately uncached —
    a cache would defeat the memory point)."""

    __slots__ = ("codes2", "offsets")

    def __init__(self, codes2: np.ndarray, offsets: np.ndarray):
        self.codes2 = np.asarray(codes2, dtype=np.uint8)
        self.offsets = np.asarray(offsets, dtype=np.int64)

    @classmethod
    def from_packed_strings(cls, ps: PackedStrings) -> "Packed2Strings":
        from . import native

        return cls(native.pack2(np.ascontiguousarray(ps.codes)), ps.offsets)

    def unpack(self) -> PackedStrings:
        from . import native

        n = int(self.offsets[-1])
        return PackedStrings(native.unpack2(self.codes2, n), self.offsets)

    def __len__(self) -> int:
        return self.offsets.shape[0] - 1

    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    def weight(self) -> int:
        return int(self.offsets[-1])

    def size_kmers(self, k: int) -> int:
        return int(np.sum(np.maximum(self.lengths() - k + 1, 0)))


def _pack(codes: np.ndarray, idx: np.ndarray, k: int) -> np.ndarray:
    vals = codes[idx].astype(np.int64)
    out = np.zeros(idx.shape[0], dtype=np.int64)
    for j in range(k):
        out = (out << 2) | vals[:, j]
    return out


def complement_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a code string (reference internal::Complement,
    lib/core/spss.h:43-68)."""
    return (3 - codes[::-1]).astype(np.uint8)
