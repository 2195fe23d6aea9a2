"""The comparisons that decide `correct`, one per kind of job.

Each returns (parts, numbers, stats).  parts counts what the program's
output got wrong, by kind; its sum is the number compared as `errors`,
whose limit is 0 (an exact comparison).  numbers are the further
numbers compared, each against its limit in LIMITS, which hold the
program to the work a cell names and not only to a lossless answer.
stats are the reference's counts of the inputs.

- build: the dump decodes to the FASTA's canonical k-mers at the cutoff,
  each k-mer once, every byte A, C, G, T or a newline; and it is a
  spectrum-preserving string set: its strings over the maximal unitigs
  that the reference finds in the same set (`strings_per_unitig`);
- compress: every input set is the union of the directory's files that
  its node reaches in meta's children lists, each file holds each k-mer
  once, and the DOT file draws meta's edges; and the directory shares:
  the k-mers its files store over the union of the input sets
  (`stored_per_union`);
- decompress: each set's logged size and hash are those of the
  reference's read of the directory, whose input sets are the FASTAs'.

A reading of a number above its limit fails the run.  The limits were
set from the program's sound runs and from planted faults on the chip
(PERF.md, section 6).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List

import torch

from . import kmers

# strings_per_unitig: every SPSS made of whole unitigs has at most one
# string per maximal unitig; stored_per_union: above the program's
# readings (1.73) and below a directory that shares nothing (7.63).
LIMITS = {"errors": 0, "strings_per_unitig": 1.0, "stored_per_union": 4.0}

_HASH_SIZE = re.compile(r"kmer_set\.(Hash|Size)\(\) = (\d+)")
_EDGE = re.compile(r"v(\d+) -> v(\d+)")


def compared(parts: dict, numbers: dict) -> dict:
    """Each number compared, with its limit: `errors`, the sum of parts,
    first."""
    out = {"errors": {"value": int(sum(parts.values())),
                      "limit": LIMITS["errors"]}}
    for name, value in numbers.items():
        out[name] = {"value": value, "limit": LIMITS[name]}
    return out


def within(numbers: dict) -> bool:
    """Whether every number compared is at or under its limit."""
    return all(c["value"] <= c["limit"] for c in numbers.values())


def reference_sets(fastas: List[str], k: int, cutoff: int, device):
    sets, stats = [], []
    for path in fastas:
        s, st = kmers.kmer_set(path, k, cutoff, device)
        sets.append(s)
        stats.append(st)
    total = {key: sum(st[key] for st in stats) for key in stats[0]}
    total["sizes"] = [int(s.numel()) for s in sets]
    return sets, total


def check_build(fastas, dump: str, k: int, cutoff: int, device,
                decompressor: str = ""):
    (want,), stats = reference_sets(fastas, k, cutoff, device)
    stats["unitigs"] = kmers.unitig_count(want, k)
    if not os.path.exists(dump):
        return ({"missing output": int(want.numel())},
                {"strings_per_unitig": 0.0}, stats)
    got, doubled, malformed, strings = kmers.decode_dump(dump, k, device,
                                                          decompressor)
    stats["strings"] = strings
    return ({"k-mers wrong": kmers.set_errors(got, want),
             "k-mers doubled": doubled, "bytes malformed": malformed},
            {"strings_per_unitig": strings / max(1, stats["unitigs"])}, stats)


def _children(line: str) -> Dict[int, List[int]]:
    """meta's first line: "size key count children ..." (the reference's
    adjacency-list format)."""
    tok = iter(int(x) for x in line.split())
    adj = {}
    for _ in range(next(tok)):
        key, n = next(tok), next(tok)
        adj[key] = [next(tok) for _ in range(n)]
    return adj


def _reach(adj, i: int) -> List[int]:
    seen, todo = {i}, [i]
    while todo:
        for j in adj.get(todo.pop(), []):
            if j not in seen:
                seen.add(j)
                todo.append(j)
    return sorted(seen)


def read_directory(directory: str, k: int, device, decompressor: str = ""):
    """(children lists, the union that each node reaches, k-mers held
    twice in a file, malformed bytes, k-mers stored over all files) of a
    compressed directory; None where its meta does not parse."""
    try:
        with open(os.path.join(directory, "meta.txt")) as f:
            meta = f.read().split("\n")
        adj, n = _children(meta[0]), int(meta[1])
    except (OSError, ValueError, IndexError, StopIteration):
        return None
    files, doubled, malformed, stored = {}, 0, 0, 0
    empty = torch.empty(0, dtype=torch.int64, device=device)
    for j in range(n):
        path = os.path.join(directory, f"{j}.txt")
        if os.path.exists(path):
            files[j], d, m, _ = kmers.decode_dump(path, k, device, decompressor)
            doubled, malformed = doubled + d, malformed + m
            stored += int(files[j].numel()) + d
    unions = []
    for i in range(n):
        ids = [j for j in _reach(adj, i) if j in files]
        unions.append(torch.unique(torch.cat([files[j] for j in ids]))
                      if ids else empty)
    return adj, unions, doubled, malformed, stored


def _node(unions, i: int) -> torch.Tensor:
    return unions[i] if i < len(unions) else torch.empty(0, dtype=torch.int64)


def check_compress(fastas, directory: str, dot: str, k: int, cutoff: int,
                   device, decompressor: str = ""):
    wants, stats = reference_sets(fastas, k, cutoff, device)
    stats["union"] = int(torch.unique(torch.cat(wants)).numel())
    got = read_directory(directory, k, device, decompressor)
    if got is None:
        return ({"missing output": sum(int(w.numel()) for w in wants)},
                {"stored_per_union": 0.0}, stats)
    adj, unions, doubled, malformed, stored = got
    stats["nodes"], stats["stored"] = len(unions), stored
    wrong = sum(kmers.set_errors(_node(unions, i), w)
                for i, w in enumerate(wants))
    edges = {(a, b) for a, bs in adj.items() for b in bs}
    try:
        with open(dot) as f:
            drawn = {(int(a), int(b)) for a, b in _EDGE.findall(f.read())}
    except OSError:
        drawn = set()
    return ({"k-mers wrong": wrong, "k-mers doubled": doubled,
             "bytes malformed": malformed, "edges wrong": len(edges ^ drawn)},
            {"stored_per_union": stored / max(1, stats["union"])}, stats)


def logged_sets(lines) -> List[tuple]:
    """(hash, size) of each set a decompress job logged, in order."""
    out, cur = [], {}
    for _, msg in lines:
        m = _HASH_SIZE.search(msg)
        if m:
            cur[m.group(1)] = int(m.group(2))
            if len(cur) == 2:
                out.append((cur["Hash"], cur["Size"]))
                cur = {}
    return out


def check_decompress(fastas, directory: str, logged: List[tuple], k: int,
                     cutoff: int, device, decompressor: str = ""):
    """Every set the reader yields (the inputs first, then each shared
    child's reach) against the reference's read of the same directory,
    whose input sets must be the FASTA's."""
    wants, stats = reference_sets(fastas, k, cutoff, device)
    got = read_directory(directory, k, device, decompressor)
    if got is None:
        raise RuntimeError(f"set-up wrote no readable directory: {directory}")
    _, unions, doubled, malformed, _ = got
    want = [(kmers.xor_hash(u), int(u.numel())) for u in unions]
    stats["sizes"] = [s for _, s in want]
    inputs_wrong = sum(kmers.set_errors(_node(unions, i), w) > 0
                       for i, w in enumerate(wants)) + doubled + malformed
    wrong = sum(i >= len(logged) or logged[i] != w for i, w in enumerate(want))
    return ({"sets wrong": wrong + max(0, len(logged) - len(want)),
             "directory wrong": inputs_wrong}, {}, stats)
