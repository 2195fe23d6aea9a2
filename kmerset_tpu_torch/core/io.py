"""Line IO with optional external (de)compressor subprocesses.

The port's copy of kmerset_tpu/core/io.py:1-150, but for one change:
read_lines turns a decode error of input that is not UTF-8 into IOError_,
with the decoder's own message, which is the text the reference's CLIs log
when they catch it (kmerset_tpu/cli/kmerset_build.py:60).

Mirrors the reference's popen-based pipe trick (reference:
lib/core/io.h:20-126): when a compressor/decompressor command string is
given, data is piped through `cmd < file` / `cmd > file` run in a shell, so
`--compressor bzip2` / `--decompressor "bzip2 -d"` behave byte-identically
to the reference, including .gz/.bz2 support via external tools.
"""

from __future__ import annotations

import subprocess
from typing import List

import numpy as np

from . import kmer as kmer_ops


class IOError_(Exception):
    pass


def read_lines(file_name: str, decompressor: str = "") -> List[str]:
    """Reads lines; pipes through `decompressor < file` if non-empty
    (reference: lib/core/io.h:20-73)."""
    try:
        if not decompressor:
            # Text mode (newline translation) — the byte helper below is
            # binary; plain-file line reads keep the text-mode contract.
            try:
                with open(file_name, "r") as f:
                    data = f.read()
            except OSError as e:
                raise IOError_(f"failed to open file: {file_name}") from e
        else:
            data = read_file_bytes(file_name, decompressor).decode()
    except UnicodeDecodeError as e:
        raise IOError_(str(e)) from e
    if data.endswith("\n"):
        data = data[:-1]
    if data == "":
        return [""]
    return data.split("\n")


def read_file_bytes(file_name: str, decompressor: str = "") -> bytes:
    """Raw bytes of a (possibly piped) file — the vectorized fast path
    behind PackedStrings.from_lines_bytes; same subprocess semantics and
    error strings as read_lines."""
    if not decompressor:
        try:
            with open(file_name, "rb") as f:
                return f.read()
        except OSError as e:
            raise IOError_(f"failed to open file: {file_name}") from e
    # The command string stays user-controlled (reference parity:
    # popen(cmd), lib/core/io.h:39), but the PATH is quoted so file
    # names with spaces/metacharacters are data, not shell syntax.
    import shlex

    proc = subprocess.run(
        f"{decompressor} < {shlex.quote(file_name)}",
        shell=True,
        capture_output=True,
    )
    if proc.returncode != 0:
        raise IOError_(
            f"process failed with non-zero exit code: {proc.returncode}"
        )
    return proc.stdout


def write_file_bytes(file_name: str, compressor: str, data: bytes) -> None:
    """Byte-blob twin of write_lines (same pipe trick, same errors);
    `data` must already carry its trailing newlines."""
    if not compressor:
        try:
            with open(file_name, "wb") as f:
                f.write(data)
        except OSError as e:
            raise IOError_(f"failed to open file: {file_name}") from e
        return
    import shlex

    proc = subprocess.run(
        f"{compressor} > {shlex.quote(file_name)}",
        shell=True,
        input=data,
    )
    if proc.returncode != 0:
        raise IOError_(f"process failed with non-zero exit code: {proc.returncode}")


def write_lines(file_name: str, compressor: str, lines) -> None:
    """Writes lines; pipes through `compressor > file` if non-empty
    (reference: lib/core/io.h:75-126)."""
    write_file_bytes(
        file_name,
        compressor,
        "".join(line + "\n" for line in lines).encode(),
    )


def parse_fasta_lines(lines: List[str]) -> List[str]:
    """Validates FASTA lines and returns the reads.

    Same contract as the reference (reference: lib/core/kmer_counter.h:161-209):
    an even number of lines alternating '>' headers and sequences of
    A/C/G/T/N only.
    """
    if len(lines) % 2 != 0:
        raise IOError_("FASTA files should have an even number of lines")
    reads: List[str] = []
    valid = frozenset("ACGTN")
    for i, line in enumerate(lines):
        if i % 2 == 0:
            if not line or line[0] != ">":
                raise IOError_("invalid FASTA file")
        else:
            if not set(line) <= valid:
                raise IOError_("invalid FASTA file")
            reads.append(line)
    return reads


def reads_to_codes(reads: List[str]) -> tuple[np.ndarray, np.ndarray]:
    """Encodes reads to one flat 2-bit-code array plus fragment offsets.

    Reads are split at 'N' (reference: lib/core/kmer_counter.h:78); the
    result is (codes, offsets) where fragment f occupies
    codes[offsets[f]:offsets[f+1]] and every code is in 0..3.
    """
    blob = "\n".join(reads)
    if not blob:
        return np.empty(0, dtype=np.uint8), np.zeros(1, dtype=np.int64)
    raw = np.frombuffer(blob.encode(), dtype=np.uint8)
    codes = kmer_ops.BASE_TO_CODE[raw]
    # Separators: both 'N' (254) and '\n' (255 via lookup) break fragments.
    is_sep = codes >= 4
    sep_idx = np.flatnonzero(is_sep)
    # Cut at every separator; keep only non-empty fragments.
    cut = np.concatenate(([-1], sep_idx, [codes.size]))
    frag_starts = cut[:-1] + 1
    frag_ends = cut[1:]
    keep = frag_ends > frag_starts
    frag_starts = frag_starts[keep]
    frag_ends = frag_ends[keep]
    clean = codes[~is_sep]
    lengths = frag_ends - frag_starts
    offsets = np.zeros(lengths.size + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return clean, offsets
