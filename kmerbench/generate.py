"""The one general generator of the benchmark's inputs.

A configuration (configs/<name>.json) states the genomes: their length
and the tree of substitutions that relates them.  A traffic mix
(mixes/<name>.json) states how the genomes reach the program: as
assembly records or as sequencing reads, and what a job does with them.
Everything is drawn from the run's seed, so one seed gives the same
bytes on every machine.

FASTA files are written as the port's parser takes them: one header line
and one sequence line per record, over A, C, G, T and N.
"""

from __future__ import annotations

import os
import subprocess
from typing import List

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
READ_BLOCK = 1 << 17  # reads generated and written per block


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (any non-negative int)."""
    return np.random.default_rng([int(seed), stream])


def substitute(genome: np.ndarray, rate: float, rng) -> np.ndarray:
    """A copy of `genome` with round(rate * len) distinct positions
    changed to another base."""
    out = genome.copy()
    n = int(round(rate * genome.size))
    pos = rng.choice(genome.size, n, replace=False)
    out[pos] = (out[pos] + rng.integers(1, 4, n, dtype=np.uint8)) % 4
    return out


def genomes(config: dict, seed: int) -> List[np.ndarray]:
    """The leaves of the configuration's tree (2-bit codes, uint8): a
    random root of `genome_bp` bases; each level of `tree`, a list of
    rates, gives every genome of the level above one child per rate,
    substituted at that rate from it.  No tree: the root alone."""
    rng = rng_of(seed, 1)
    level = [rng.integers(0, 4, int(config["genome_bp"]), dtype=np.uint8)]
    for rates in config.get("tree", []):
        level = [substitute(g, float(r), rng) for g in level for r in rates]
    return level


def _fasta_rows(seqs: np.ndarray, first: int) -> bytes:
    """Records of the equal-length ASCII rows `seqs`, headers ">r<9
    digits>" numbered from `first`."""
    n, width = seqs.shape
    rows = np.empty((n, 12 + width + 1), dtype=np.uint8)
    rows[:, 0] = ord(">")
    rows[:, 1] = ord("r")
    idx = np.arange(first, first + n, dtype=np.int64)
    for p in range(9):
        rows[:, 10 - p] = ord("0") + (idx // 10 ** p) % 10
    rows[:, 11] = ord("\n")
    rows[:, 12:12 + width] = seqs
    rows[:, -1] = ord("\n")
    return rows.tobytes()


def write_records(path: str, genome: np.ndarray, mix: dict, rng) -> int:
    """The genome as `record_bp` records, plus `n_reads` records of
    `record_bp` bases from random places carrying `runs_per_read` runs of
    1 to `max_run_bp` N (as an assembly with gaps).  Returns the
    sequence bases written."""
    step = int(mix["record_bp"])
    written = 0
    with open(path, "wb") as f:
        for i, start in enumerate(range(0, genome.size, step)):
            seq = BASES[genome[start:start + step]]
            f.write(b">r%d\n" % i + seq.tobytes() + b"\n")
            written += seq.size
        for j in range(int(mix.get("n_reads", 0))):
            s = int(rng.integers(0, genome.size - step))
            read = BASES[genome[s:s + step]].copy()
            for _ in range(int(mix["runs_per_read"])):
                a = int(rng.integers(0, step))
                read[a:a + int(rng.integers(1, int(mix["max_run_bp"]) + 1))] = ord("N")
            f.write(b">n%d\n" % j + read.tobytes() + b"\n")
            written += read.size
    return written


def write_reads(path: str, genome: np.ndarray, mix: dict, rng) -> int:
    """`coverage` x the genome in reads of `read_bp` bases from uniform
    places, each from the reverse strand with probability 1/2, each base
    substituted with probability `error_rate`.  Returns the bases."""
    width = int(mix["read_bp"])
    n_reads = int(float(mix["coverage"]) * genome.size / width)
    rate = float(mix["error_rate"])
    cols = np.arange(width, dtype=np.int64)
    with open(path, "wb") as f:
        for lo in range(0, n_reads, READ_BLOCK):
            n = min(READ_BLOCK, n_reads - lo)
            starts = rng.integers(0, genome.size - width + 1, n)
            reads = genome[starts[:, None] + cols]
            rev = rng.random(n) < 0.5
            reads[rev] = 3 - reads[rev, ::-1]
            err = rng.random(reads.shape) < rate
            reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()),
                                                    dtype=np.uint8)) % 4
            f.write(_fasta_rows(BASES[reads], lo))
    return n_reads * width


def write_fastas(config: dict, mix: dict, seed: int, directory: str):
    """One FASTA per genome of the configuration, in the mix's form.
    Returns (paths, sequence bases of each)."""
    rng = rng_of(seed, 2)
    form = {"records": write_records, "reads": write_reads}[mix["input"]]
    paths, bases = [], []
    for i, g in enumerate(genomes(config, seed)):
        paths.append(os.path.join(directory, f"g{i}.fa"))
        bases.append(form(paths[-1], g, mix, rng))
    return paths, bases


def compress_inputs(paths: List[str], command: str) -> List[str]:
    """Each file piped through the shell command `command` (such as
    "gzip -c") into a file of its own; the paths themselves where the
    command is empty."""
    if not command:
        return list(paths)
    out = []
    for p in paths:
        out.append(p + ".z")
        with open(p, "rb") as src, open(out[-1], "wb") as dst:
            subprocess.run(command, shell=True, stdin=src, stdout=dst, check=True)
    return out
