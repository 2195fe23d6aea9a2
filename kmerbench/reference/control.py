"""The control: the reference put in the program's place, with one
guarantee that the configuration states broken, so that the comparison
has to find it wrong.

- build: canonical is broken: the dump holds the FASTA's forward k-mers
  at the cutoff, each alone on a line, so a k-mer met on both strands is
  stored twice;
- compress and decompress: lossless is broken: each set is stored, or
  read back, as the k-mers it shares with the other sets of its clade
  (the last level of the configuration's tree), its own k-mers dropped.

The faults: the reference put in the program's place with the work that
a cell names skipped and every guarantee kept, for the numbers that hold
that work to a limit (check.LIMITS):

- build, "one k-mer per line": the counted set dumped one canonical
  k-mer to a line, with no unitigs and no path cover;
- compress, "no sharing": every input set stored whole in a file of its
  own, with no children and no edges.
"""

from __future__ import annotations

import os
from typing import List

import torch

from . import check, kmers


def build_output(fastas: List[str], dump: str, k: int, cutoff: int, device):
    u, c = kmers.count(kmers.fasta_codes(fastas[0]), k, False, device)
    with open(dump, "wb") as f:
        f.write(kmers.to_lines(u[c >= cutoff], k))


def one_kmer_per_line(fastas: List[str], dump: str, k: int, cutoff: int,
                      device):
    (s,), _ = check.reference_sets(fastas, k, cutoff, device)
    with open(dump, "wb") as f:
        f.write(kmers.to_lines(s, k))


def write_directory(directory: str, dot: str, k: int, files, adj) -> None:
    """A directory in the program's format: meta's children lists `adj`
    and the number of files, file j holding the k-mers files[j], and the
    DOT file of the same edges."""
    os.makedirs(directory, exist_ok=True)
    parts = [str(len(adj))]
    for key in sorted(adj):
        parts += [str(key), str(len(adj[key]))] + [str(v) for v in adj[key]]
    with open(os.path.join(directory, "meta.txt"), "w") as f:
        f.write(" ".join(parts) + "\n" + str(len(files)) + "\n")
    for j, keys in enumerate(files):
        with open(os.path.join(directory, f"{j}.txt"), "wb") as f:
            f.write(kmers.to_lines(keys, k))
    with open(dot, "w") as f:
        f.write("digraph G {\n" + "".join(f"v{a} -> v{b}\n" for a in sorted(adj)
                                          for b in adj[a]) + "}\n")


def no_sharing(fastas, directory: str, dot: str, k: int, cutoff: int, device):
    sets, _ = check.reference_sets(fastas, k, cutoff, device)
    write_directory(directory, dot, k, sets, {i: [] for i in range(len(sets))})


def clade_cores(fastas, k: int, cutoff: int, clade: int, device):
    sets, _ = check.reference_sets(fastas, k, cutoff, device)
    cores = []
    for lo in range(0, len(sets), clade):
        core = sets[lo]
        for s in sets[lo + 1:lo + clade]:
            core = core[torch.isin(core, s)]
        cores.append(core)
    return cores


def compress_output(fastas, directory: str, dot: str, k: int, cutoff: int,
                    clade: int, device):
    """Set i's own file empty, one shared child per clade holding the
    clade's core."""
    cores = clade_cores(fastas, k, cutoff, clade, device)
    n = len(fastas)
    empty = torch.empty(0, dtype=torch.int64)
    write_directory(directory, dot, k, [empty] * n + cores,
                    {i: [n + i // clade] for i in range(n)})


def decompress_lines(fastas, k: int, cutoff: int, clade: int, device):
    """Log lines as a decompress job logs them, of each set read back as
    its clade's core."""
    cores = clade_cores(fastas, k, cutoff, clade, device)
    lines = []
    for i in range(len(fastas)):
        core = cores[i // clade]
        lines += [(0.0, f"kmer_set.Hash() = {kmers.xor_hash(core)}"),
                  (0.0, f"kmer_set.Size() = {int(core.numel())}")]
    return lines
