"""Kernel P1: the FASTA parse and 2-bit pack of the count on the device
(csrc/parse.cu).

Replaces no Pallas kernel: it takes over the host's serial loops over
every byte, the parse of native/kmerio.c kmerio_parse_fasta (behind
core/native.parse_fasta_bytes) and the pack of kmerio_pack2 (behind
native.pack2), whose rules it keeps: lines alternate between a '>' header
and a sequence; an empty line or one without '>' where a header belongs,
a sequence byte other than A/C/G/T/N ('\\r' and lower case included) and
an odd number of lines are errors ("invalid FASTA file" for the first two,
whichever comes first in the file, else the lines'); a last line without
a newline counts, and a file ending in "\\n\\n" ends in an empty line.  A
fragment is cut at every N and at every line end.

parse gives what native.parse_fasta_bytes gives, on the device: the codes
(0..3, one a byte) and the fragment offsets (int64, 0 first, then each
fragment's end).  pack gives what native.pack2 gives: 4 codes a byte,
first in the low bits, the layout kernels B1 and B2 read.  The count packs
each chunk's slice of the codes (ops/backend.stage), so the codes stay
unpacked until then.

On a CUDA tensor parse is one launch of the scan (counted in launch.P1,
utils/trace.py) and one download of its four totals (codes, fragments,
malformed, the lines' parity); pack one launch of the pack pass (counted
in launch.P1.pack).  On a CPU tensor the plain PyTorch versions compute
the same.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import trace
from . import backend
from .count import pack_codes as pack_plain

INVALID = "invalid FASTA file"
ODD_LINES = "FASTA files should have an even number of lines"

TILE = 16384  # bytes a block of the scan takes (csrc/parse.cu kTile)

_NEWLINE, _GT = ord("\n"), ord(">")
_SEP, _BAD = 4, 5  # N; any other byte of a sequence line


def _classes(dev) -> torch.Tensor:
    """(256,) uint8: each byte's code 0..3 (A, C, G, T), _SEP (N), else
    _BAD."""
    lut = torch.full((256,), _BAD, dtype=torch.uint8, device=dev)
    for code, base in enumerate(b"ACGT"):
        lut[base] = code
    lut[ord("N")] = _SEP
    return lut


def parse_plain(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain P1: (codes uint8, offsets int64) of the FASTA text `buf`, on
    its device; raises ValueError as native.parse_fasta_bytes does.  Its
    peak is about 16 bytes a byte (the int64 running counts)."""
    dev = buf.device
    n = buf.shape[0]
    if n == 0:
        return (torch.empty(0, dtype=torch.uint8, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev))
    nl = buf == _NEWLINE
    lines = torch.cumsum(nl, 0).bitwise_and_(1)
    seq = torch.zeros(n, dtype=torch.bool, device=dev)  # on an odd line
    seq[1:] = lines[:-1].bool()
    del lines
    start = torch.ones(n, dtype=torch.bool, device=dev)
    start[1:] = nl[:-1]
    cls = _classes(dev)[buf.int()]
    if ((start & ~seq & (buf != _GT)).any()
            or (seq & ~nl & (cls == _BAD)).any()):
        raise ValueError(INVALID)
    if (int(nl.sum()) + int(buf[-1] != _NEWLINE)) % 2:
        raise ValueError(ODD_LINES)
    del start
    is_code = seq & (cls < _SEP)
    # An ACGT byte followed by one on its line continues its fragment.
    end = is_code.clone()
    end[:-1] &= ~is_code[1:]
    pos = torch.cumsum(is_code, 0)
    return (cls[is_code],
            torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), pos[end]]))


def _lib():
    from . import _build

    return _build.load(), _build.check


def _check_bytes(buf: torch.Tensor, what: str) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"kernel P1 takes {what} as a one-dimensional uint8 "
                         "tensor")


def parse(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes, offsets) of the FASTA text `buf` (uint8) on its device, as
    native.parse_fasta_bytes gives them: kernel P1 on CUDA, with one
    download of its totals; parse_plain on the CPU.  Raises ValueError
    with the host parser's message on malformed text.  The codes are a
    view of a buffer of len(buf) bytes."""
    _check_bytes(buf, "the FASTA text")
    if buf.device.type == "cpu":
        return parse_plain(buf)
    n = buf.shape[0]
    dev = buf.device
    if not n:
        return parse_plain(buf)
    buf = buf.contiguous()
    tiles = -(-n // TILE)
    codes = torch.empty(n, dtype=torch.uint8, device=dev)
    # Every fragment end but the file's last is followed by a byte that is
    # no base: at most (n + 1) // 2 of them, after the leading 0.
    offsets = torch.empty(1 + (n + 1) // 2, dtype=torch.int64, device=dev)
    scratch = torch.empty(1 + 3 * tiles, dtype=torch.int64, device=dev)
    info = torch.empty(4, dtype=torch.int64, device=dev)
    lib, check = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib, lib.kmerset_parse_fasta(
            buf.data_ptr(), n, codes.data_ptr(), offsets.data_ptr(),
            scratch.data_ptr(), scratch.shape[0], info.data_ptr(), stream),
            "parse kernel P1")
        trace.add("launch.P1")
    total, n_ends, bad, odd = (int(x) for x in
                               backend.download("parse totals", info))
    if bad:
        raise ValueError(INVALID)
    if odd:
        raise ValueError(ODD_LINES)
    return codes[:total], offsets[: n_ends + 1].clone()


def pack(codes: torch.Tensor) -> torch.Tensor:
    """(ceil(L / 4),) uint8 on the codes' device: the L codes (0..3, any
    alignment, a slice of parse's codes) packed 4 a byte in kmerio_pack2's
    layout, by P1's pack pass on CUDA and pack_plain
    (ops/count.pack_codes) on the CPU."""
    _check_bytes(codes, "the codes")
    if codes.device.type == "cpu":
        return pack_plain(codes)
    L = codes.shape[0]
    codes = codes.contiguous()
    out = torch.empty((L + 3) // 4, dtype=torch.uint8, device=codes.device)
    lib, check = _lib()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        check(lib, lib.kmerset_pack_codes(codes.data_ptr(), L, out.data_ptr(),
                                          stream), "pack pass of kernel P1")
        trace.add("launch.P1.pack")
    return out
