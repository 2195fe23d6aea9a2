"""The chip's peaks and the count kernels' least bytes.

HBM_BYTES_PER_S is one NVIDIA H100 SXM's memory rate from NVIDIA's data
sheet, which assumes the card's full 700 W power limit; a roofline share
is stated against it with the card's limit beside it.

The bytes are what the count's inputs need, each input read once and
each output written once: kernel B1 packs each valid window (0.25 B of
2-bit codes, 1 B of validity, one key), and kernel B3 compacts the
sorted windows' run heads (1 B keep, the key and an int32 position in,
both out for each distinct k-mer).  Windows and distinct k-mers come
from the benchmark's own inputs (the reference's count), never from the
program's launches, so a change that fuses or replaces a kernel is held
to the same work.
"""

HBM_BYTES_PER_S = 3.35e12


def key_bytes(k: int) -> int:
    """Width of a packed key: int32 up to k = 15, int64 above."""
    return 4 if k <= 15 else 8


def pack_bytes(k: int, windows: int) -> float:
    return windows * (0.25 + 1 + key_bytes(k))


def count_compact_bytes(k: int, windows: int, distinct: int) -> float:
    lanes = key_bytes(k) + 4
    return windows * (1 + lanes) + distinct * lanes


def count_kernels_seconds(k: int, windows: int, distinct: int) -> float:
    """The least time kernels B1 (or B2) and B3 need for one count."""
    return (pack_bytes(k, windows)
            + count_compact_bytes(k, windows, distinct)) / HBM_BYTES_PER_S
