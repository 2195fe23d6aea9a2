"""2-bit packed k-mer codec, vectorized over numpy arrays.

The port's copy of kmerset_tpu/core/kmer.py:17-170, whole: the tables,
reverse_complement, canonical, next/prev_kmer, first/last_code, the
bucket split and every string and window conversion.  Left out by
design: the jax.numpy branches of canonical and _widen (:74-76, 85): the
port's codec runs on numpy only; its device code has its own shifts
(ops/pack.py, ops/neighbors.py).

A k-mer of length k is packed into the low 2k bits of an int64: 'A', 'C',
'G', 'T' map to 0, 1, 2, 3 and the *first* base occupies the most
significant 2-bit lane (reference: lib/core/kmer.h:12-46).

Unlike the reference's per-base scalar loops (e.g. the reverse complement
loop, reference: lib/core/kmer.h:103-129), everything here is closed-form
bit arithmetic over whole arrays.

k <= 31 fits in a signed int64 (62 bits).  All functions accept and return
int64 arrays (or scalars).
"""

from __future__ import annotations

import numpy as np

# Lane-reversal masks (also correct for signed int64: every shift-right is
# immediately masked so sign-extension bits never survive).
_M2 = 0x3333333333333333
_M4 = 0x0F0F0F0F0F0F0F0F
_M8 = 0x00FF00FF00FF00FF
_M16 = 0x0000FFFF0000FFFF
_M32 = 0x00000000FFFFFFFF

# ASCII -> 2-bit code; 255 marks invalid, 254 marks 'N' (fragment separator).
BASE_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    BASE_TO_CODE[_b] = _i
BASE_TO_CODE[ord("N")] = 254
CODE_N = 254
CODE_INVALID = 255

CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def mask(bits: int) -> int:
    return (1 << bits) - 1


_NATIVE_MIN = 1 << 16


def reverse_complement(kmers, k: int):
    """Reverse complement of packed k-mers (reference: lib/core/kmer.h:97-129).

    Complements every 2-bit lane (b -> 3-b == ~b) and reverses lane order,
    in five shuffle rounds instead of a k-step loop.  Large host arrays
    take the single-pass native path (native/kmerio.c kmerio_revcomp).
    """
    if isinstance(kmers, np.ndarray) and kmers.size >= _NATIVE_MIN:
        from . import native

        out = native.revcomp(kmers, k)
        if out is not None:
            return out
    x = ~kmers
    x = ((x >> 2) & _M2) | ((x & _M2) << 2)
    x = ((x >> 4) & _M4) | ((x & _M4) << 4)
    x = ((x >> 8) & _M8) | ((x & _M8) << 8)
    x = ((x >> 16) & _M16) | ((x & _M16) << 16)
    x = ((x >> 32) & _M32) | ((x & _M32) << 32)
    return (x >> (64 - 2 * k)) & mask(2 * k)


def canonical(kmers, k: int):
    """min(kmer, reverse_complement(kmer)) (reference: lib/core/kmer.h:131-133)."""
    return np.minimum(kmers, reverse_complement(kmers, k))


def _widen(code):
    """Promote narrow integer codes to int64 so shifts don't overflow."""
    if isinstance(code, int):
        return code
    return np.asarray(code, dtype=np.int64)


def next_kmer(kmers, k: int, code):
    """(K-1)-suffix + new base `code` (reference: lib/core/kmer.h:135-161)."""
    return ((kmers << 2) & mask(2 * k)) | _widen(code)


def prev_kmer(kmers, k: int, code):
    """New base `code` + (K-1)-prefix (reference: lib/core/kmer.h:163-186)."""
    return (kmers >> 2) | (_widen(code) << (2 * (k - 1)))


def last_code(kmers):
    """2-bit code of the final base (reference: lib/core/kmer.h:81-95)."""
    return kmers & 3


def first_code(kmers, k: int):
    return (kmers >> (2 * (k - 1))) & 3


def bucket_and_key(kmers, key_bits: int):
    """Split into (bucket = high bits, key = low key_bits)
    (reference: lib/core/kmer_set.h:20-31)."""
    return kmers >> key_bits, kmers & mask(key_bits)


def kmer_from_bucket_and_key(bucket, key, key_bits: int):
    """Inverse of bucket_and_key (reference: lib/core/kmer_set.h:33-43)."""
    return (bucket << key_bits) | key


def kmers_from_codes(codes: np.ndarray, k: int) -> np.ndarray:
    """All length-k windows of a base-code sequence, packed.

    codes: int array of 2-bit codes (values 0..3), length L.
    Returns int64 array of length max(L - k + 1, 0).

    This is the vectorized replacement for the reference's per-window
    substring + per-base packing loop (reference: lib/core/kmer_counter.h:80-96).
    From _NATIVE_MIN windows on it takes the native rolling pack
    (native/kmerio.c kmerio_window_pack).
    """
    n = np.asarray(codes).shape[0] - k + 1
    if n <= 0:
        return np.empty(0, dtype=np.int64)
    if n >= _NATIVE_MIN:
        from . import native

        out = native.window_pack(np.asarray(codes), k)
        if out is not None:
            return out
    codes = np.asarray(codes, dtype=np.int64)
    out = np.zeros(n, dtype=np.int64)
    for j in range(k):
        out = (out << 2) | codes[j : j + n]
    return out


def codes_from_kmer(kmers: np.ndarray, k: int) -> np.ndarray:
    """Unpack k-mers to per-base codes, shape (..., k), first base first."""
    kmers = np.asarray(kmers, dtype=np.int64)
    shifts = np.arange(k - 1, -1, -1, dtype=np.int64) * 2
    return (kmers[..., None] >> shifts) & 3


def string_to_codes(s: str | bytes) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return BASE_TO_CODE[np.frombuffer(s, dtype=np.uint8)]


def codes_to_string(codes: np.ndarray) -> str:
    return CODE_TO_BASE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def string_to_kmer(s: str) -> int:
    """Pack a length-k string (reference: lib/core/kmer.h:22-46)."""
    codes = string_to_codes(s)
    if (codes > 3).any():
        raise ValueError(f"invalid k-mer string: {s!r}")
    return int(kmers_from_codes(codes, len(s))[0])


def kmer_to_string(kmer: int, k: int) -> str:
    """Unpack to a string (reference: lib/core/kmer.h:50-79)."""
    return codes_to_string(codes_from_kmer(np.int64(kmer), k))
