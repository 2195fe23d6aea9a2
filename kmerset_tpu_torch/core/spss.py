"""SPSS build and decode on an explicit torch device.

Editions of kmerset_tpu.core.spss:
- get_unitigs_canonical (:559-730): the front half (side tables, terminal
  tests, oriented successor, :580-652) is one call of the port's device
  front-end (ops/unitigs.device_unitig_succ); the chain walk and string
  emission half (:653-730) is written inline in the reference, so it is
  repeated here line for line with the reference's own helpers, without
  the mesh branch (:667-684).  The native walk and its numpy fallback
  stay in the reference's order, so the port takes the same branch as
  the reference in the same environment (group order differs between
  the two, spss.py:200-202).
- get_spss_canonical (:1082-1084), which then calls the reference's
  get_spss_canonical_from_unitigs as it is;
- decode_unique_kmers (:1087-1118) and get_kmer_set_from_spss
  (:1121-1124), which decode through the port's device_unique, or in
  halo chunks (device_unique_chunked) above the device's one-shot
  ceiling.
The directed build (get_spss) stays the reference's host code.
"""

from __future__ import annotations

from typing import List

import numpy as np

from kmerset_tpu.core import kmer as kmer_ops
from kmerset_tpu.core import native
from kmerset_tpu.core.kmer_set import KmerSet
from kmerset_tpu.core.spss import (
    _chains_grouped,
    _concat_packed,
    _emit_kmer_chains,
    _filter_groups,
    _group_endpoints,
    _keep_rule,
    _phase,
    _walk_cycles,
    get_spss_canonical_from_unitigs,
)
from kmerset_tpu.core.strings import PackedStrings

from ..ops import backend
from ..ops.unitigs import device_unitig_succ


def get_unitigs_canonical(kmer_set: KmerSet, *, device) -> PackedStrings:
    """Maximal non-branching paths of the bidirected de Bruijn graph
    (reference: lib/core/spss.h:231-615), with the graph front-end on
    `device`.  Requires odd k, as the reference does."""
    A = kmer_set.kmers
    k = kmer_set.k
    if k % 2 == 0:
        raise ValueError(
            "canonical SPSS construction requires odd k (palindromic "
            f"k-mers exist for even k); got k={k}"
        )
    n = A.shape[0]
    if n == 0:
        return PackedStrings.empty()

    with _phase("unitigs: device front-end"):
        succ, term_l, term_r, both = device_unitig_succ(A, k, device=device)
    with _phase("unitigs: chain walk"):
        starts_r_exit = np.flatnonzero(term_l & ~term_r) * 2
        starts_l_exit = np.flatnonzero(term_r & ~term_l) * 2 + 1
        starts = np.concatenate([starts_r_exit, starts_l_exit])

        # Each chain exists once per orientation; keep the one whose start
        # k-mer is >= its end k-mer (reference skip rule,
        # lib/core/spss.h:511,555).  Native fast path: measure all chains,
        # apply the rule, emit only winners; fallback: walk everything and
        # filter.
        kept = native.chain_walk_kept(
            succ, starts, lambda s, e: _keep_rule(A, s, e)
        )
        if kept is not None:
            nodes_kept, groups_kept = kept
            nodes = nodes_kept  # kept chains cover the same entities
        else:
            nodes, groups = _chains_grouped(succ, starts, oriented=True)
            firsts, lasts, nonempty = _group_endpoints(nodes, groups)
            keep = nonempty & _keep_rule(A, firsts, lasts)
            nodes_kept, groups_kept = _filter_groups(nodes, groups, keep)
    with _phase("unitigs: emission + cycles"):
        chains = _emit_kmer_chains(A, k, nodes_kept, groups_kept, oriented=True)

        parts: List[PackedStrings] = [chains]

        # Isolated k-mers (terminals on both sides), one string each
        # (reference: lib/core/spss.h:459-493).
        both_idx = np.flatnonzero(both)
        if both_idx.size:
            res = native.emit_kmer_chains(
                A,
                k,
                2 * both_idx,
                np.arange(both_idx.size + 1, dtype=np.int64),
                oriented=True,
            )
            if res is not None:
                parts.append(PackedStrings(res[0], res[1]))
            else:
                codes = kmer_ops.codes_from_kmer(A[both_idx], k).astype(np.uint8)
                offsets = np.arange(both_idx.size + 1, dtype=np.int64) * k
                parts.append(PackedStrings(codes.ravel(), offsets))

        # Non-branching loops (reference: lib/core/spss.h:583-612).  Every
        # entity on any walked chain is covered by a kept chain (kept chains
        # and their dropped mirrors visit the same k-mers).
        visited = np.zeros(n, dtype=bool)
        visited[nodes >> 1] = True
        visited[both_idx] = True
        parts.append(_walk_cycles(A, k, succ, visited, oriented=True))

    return _concat_packed(parts)


def get_spss_canonical(
    kmer_set: KmerSet, fast: bool = True, *, device
) -> PackedStrings:
    unitigs = get_unitigs_canonical(kmer_set, device=device)
    with _phase("spss: path cover"):
        return get_spss_canonical_from_unitigs(unitigs, kmer_set.k, fast)


def decode_unique_kmers(
    spss: PackedStrings, k: int, canonical: bool, *, device
) -> np.ndarray:
    """Sorted distinct (canonical) k-mers of an SPSS, counted on `device`
    at cutoff 1."""
    n_windows = int(spss.codes.shape[0]) - k + 1
    if n_windows <= 0:
        return np.empty(0, np.int64)
    if n_windows > backend.window_ceiling(k, backend.memory_budget(device)):
        return backend.device_unique_chunked(
            spss.codes, spss.offsets, k, canonical, device=device
        )
    return backend.device_unique(
        spss.codes, spss.offsets, k, canonical, device=device
    )


def get_kmer_set_from_spss(
    spss: PackedStrings, k: int, canonical: bool, *, device
) -> KmerSet:
    return KmerSet(
        k, decode_unique_kmers(spss, k, canonical, device=device), _sorted=True
    )
