"""Plain k-mer arithmetic in PyTorch, independent of the program.

It imports neither the port nor the JAX package: it reads the FASTA
files the benchmark generated and the text the program wrote, and works
every set out again with plain tensor operations (shifts, cumsum,
torch.unique, torch.isin), in blocks, once the program's state is freed.

A k-mer packs its bases 2 bits each (A, C, G, T = 0..3), the first base
in the highest bits; its canonical form is the smaller of it and its
reverse complement.  A window that holds anything but A, C, G, T, or
crosses the end of a line, is no k-mer.
"""

from __future__ import annotations

import subprocess
from typing import Tuple

import numpy as np
import torch

BREAK = 4  # the code of every byte that is not A, C, G or T
BLOCK = 1 << 25  # bases per block of the window arithmetic

_LUT = np.full(256, BREAK, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    _LUT[_b] = _i
_TEXT_OK = np.zeros(256, dtype=bool)
for _b in b"ACGT\n":
    _TEXT_OK[_b] = True


def read_bytes(path: str, decompressor: str = "") -> np.ndarray:
    """A file's bytes, piped through the shell command `decompressor`
    (such as "gzip -dc") where one is given."""
    if not decompressor:
        return np.fromfile(path, dtype=np.uint8)
    with open(path, "rb") as f:
        out = subprocess.run(decompressor, shell=True, stdin=f,
                             capture_output=True, check=True).stdout
    return np.frombuffer(out, dtype=np.uint8)


def fasta_codes(path: str) -> np.ndarray:
    """The codes of a FASTA file's bytes, header lines and newlines as
    BREAK, so no window crosses a record."""
    data = np.fromfile(path, dtype=np.uint8)
    codes = _LUT[data]
    nl = np.flatnonzero(data == ord("\n"))
    starts = (np.concatenate(([0], nl + 1))[:-1] if data.size
              else np.empty(0, np.int64))
    heads = starts[data[starts] == ord(">")] if starts.size else starts
    if heads.size:
        ends = np.append(nl, data.size)[np.searchsorted(nl, heads)]
        mark = np.zeros(data.size + 1, dtype=np.int8)  # lines do not nest
        mark[heads] = 1
        mark[ends] -= 1
        codes[np.cumsum(mark[:-1], dtype=np.int8) > 0] = BREAK
    return codes


def text_codes(path: str, decompressor: str = "") -> Tuple[np.ndarray, int, int]:
    """(codes, malformed bytes, strings) of a dump: one string per line,
    each byte A, C, G or T; strings counts the lines that hold one."""
    data = read_bytes(path, decompressor)
    ends = np.flatnonzero(data == ord("\n"))
    starts = np.concatenate(([0], ends[:-1] + 1)) if ends.size else ends
    strings = int(np.count_nonzero(ends > starts))
    if data.size and data[-1] != ord("\n"):
        strings += 1
    return _LUT[data], int(np.count_nonzero(~_TEXT_OK[data])), strings


def window_keys(codes: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    """The keys of every valid window of one block of codes."""
    n = codes.numel() - k + 1
    if n <= 0:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    bad = torch.zeros(codes.numel() + 1, dtype=torch.int32, device=codes.device)
    bad[1:] = torch.cumsum((codes >= BREAK).to(torch.int32), 0)
    valid = (bad[k:] - bad[:n]) == 0
    fwd = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rev = torch.zeros(n, dtype=torch.int64, device=codes.device)
    for j in range(k):
        x = c[j:j + n] & 3
        fwd = (fwd << 2) | x
        if canonical:
            rev |= (3 - x) << (2 * j)
    key = torch.minimum(fwd, rev) if canonical else fwd
    return key[valid]


def _merge(u: torch.Tensor, c: torch.Tensor, u2: torch.Tensor, c2: torch.Tensor):
    if u is None:
        return u2, c2
    m, inv = torch.unique(torch.cat([u, u2]), return_inverse=True)
    return m, torch.zeros_like(m).scatter_add_(0, inv, torch.cat([c, c2]))


def count(codes: np.ndarray, k: int, canonical: bool,
          device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sorted distinct keys, their counts) of all valid windows."""
    u = c = None
    for lo in range(0, max(1, codes.size - k + 1), BLOCK):
        block = torch.from_numpy(codes[lo:lo + BLOCK + k - 1]).to(device)
        b_u, b_c = torch.unique(window_keys(block, k, canonical),
                                return_counts=True)
        u, c = _merge(u, c, b_u, b_c)
        del block
    return u, c


def kmer_set(fasta: str, k: int, cutoff: int, device, canonical: bool = True):
    """(the sorted set at the cutoff, stats) of a FASTA file: stats are
    the valid windows, the distinct k-mers and those kept."""
    u, c = count(fasta_codes(fasta), k, canonical, device)
    keep = c >= cutoff
    stats = {"windows": int(c.sum()), "distinct": int(u.numel()),
             "kept": int(keep.sum())}
    return u[keep], stats


def decode_dump(path: str, k: int, device, decompressor: str = ""):
    """(the sorted distinct canonical k-mers of a dump, how many k-mers
    it holds more than once counted once per extra copy, malformed
    bytes, strings)."""
    codes, malformed, strings = text_codes(path, decompressor)
    u, c = count(codes, k, True, device)
    return u, int((c - 1).sum()), malformed, strings


def reverse_complement(keys: torch.Tensor, k: int) -> torch.Tensor:
    """The packed reverse complement of each packed k-mer."""
    comp = keys ^ ((1 << (2 * k)) - 1)
    out = torch.zeros_like(keys)
    for j in range(k):
        out |= ((comp >> (2 * j)) & 3) << (2 * (k - 1 - j))
    return out


def _lookup(keys: torch.Tensor, q: torch.Tensor):
    """(present, index) of each of q in the sorted keys."""
    idx = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
    return keys[idx] == q, idx


def unitig_count(keys: torch.Tensor, k: int) -> int:
    """The maximal unitigs of the sorted canonical set's de Bruijn graph
    (node-centric, k-1 overlaps, both strands), cycles left out: the
    k-mers less the edges inside unitigs.  An oriented k-mer v has an
    edge to w = v's last k-1 bases + b where canon(w) is in the set; the
    edge is inside a unitig where v has one successor and w one
    predecessor, and w is neither v nor v's reverse complement.  Every
    such edge is met once from each strand, so the count is halved."""
    n = keys.numel()
    if n == 0:
        return 0
    mask = (1 << (2 * k)) - 1
    sides = (keys, reverse_complement(keys, k))  # forward, reverse strand
    outdeg, nexts = [], []
    for v in sides:
        deg = torch.zeros(n, dtype=torch.int64, device=keys.device)
        nxt = torch.zeros(n, dtype=torch.int64, device=keys.device)
        for b in range(4):
            w = ((v << 2) | b) & mask
            hit, _ = _lookup(keys, torch.minimum(w, reverse_complement(w, k)))
            deg += hit
            nxt = torch.where(hit, w, nxt)
        outdeg.append(deg)
        nexts.append(nxt)
    inside = 0
    for side in range(2):
        v, w = sides[side], nexts[side]
        cw = torch.minimum(w, reverse_complement(w, k))
        _, idx = _lookup(keys, cw)
        # w's predecessors are the successors of its reverse complement.
        indeg_w = torch.where(w == cw, outdeg[1][idx], outdeg[0][idx])
        inside += int(((outdeg[side] == 1) & (indeg_w == 1)
                       & (cw != keys)).sum())
    return n - inside // 2


def set_errors(got: torch.Tensor, want: torch.Tensor) -> int:
    """k-mers in one sorted set and not the other."""
    if got.numel() == 0 or want.numel() == 0:
        return int(got.numel() + want.numel())
    return int((~torch.isin(got, want)).sum() + (~torch.isin(want, got)).sum())


def xor_hash(keys: torch.Tensor) -> int:
    """The set's order-free hash: the XOR of its packed keys, unsigned."""
    if keys.numel() == 0:
        return 0
    return int(np.bitwise_xor.reduce(keys.cpu().numpy())) & ((1 << 64) - 1)


def to_lines(keys: torch.Tensor, k: int) -> bytes:
    """The k-mers of `keys`, one per line."""
    a = keys.cpu().numpy()
    shifts = np.arange(2 * (k - 1), -1, -2, dtype=np.int64)
    rows = np.empty((a.size, k + 1), dtype=np.uint8)
    rows[:, :k] = np.frombuffer(b"ACGT", dtype=np.uint8)[(a[:, None] >> shifts)
                                                         & 3]
    rows[:, k] = ord("\n")
    return rows.tobytes()
