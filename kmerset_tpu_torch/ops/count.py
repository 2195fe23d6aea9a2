"""Device k-mer counting pipeline, k <= 31.

Counterpart of kmerset_tpu/ops/count.py, on torch tensors:

    unpack + pack windows + canonical min + validity sentinel
    (kernel B1 for k <= 15, B2 above) -> sort -> run heads
    -> [cutoff test] -> compaction (kernel B3)

Counts come out as differences between compacted run-head positions, as
in the reference's compaction-kernel branches (count.py:356-368,
451-457).  The sort is torch.sort, as the reference's is XLA's sort
outside any Pallas kernel.  Outputs are the reference's trimmed to their
live prefix: int32 keys for k <= 15 (2k <= 30 bits), int64 keys above
(2k <= 62 bits: up to k = 23 the reference's pair lanes combined,
count.py:174-182, and above it the reference's own int64 layout,
count.py:284-294), int32 counts, and the prefix length as a Python int
(reading it is the pipeline's one host sync).  Where the reference sorts
the pair lanes with lax.sort(num_keys=2) (count.py:271), the port sorts
one int64 key: the same order.

Not carried over, because they exist for the TPU only: good_sort_size
(sort-friendly padding), _use_pallas (backend probing), _compact_runs
(a flag-fused second sort standing in for slow TPU scatters) and
jax_enable_x64.
"""

from __future__ import annotations

import torch

from .compact import compact_select
from .pack import MAX_K, SINGLE_MAX_K, canonical_windows, key_sentinel

# Cutoffs up to this stay shifted compares (_run_reaches); above it the
# scan-based run lengths (reference count.py:434).
_MAX_SHIFT_CUTOFF = 8


def _frag_window_validity(bounds: torch.Tensor, total: int, L: int, k: int):
    """(L,) bool: a window starting at s is valid iff no fragment boundary
    lies in (s, s+k-1] and it starts inside the unpadded input
    (reference count.py:402-415).

    The reference finds the next boundary after every s with a reverse
    running min, because TPU scatters are slow.  On the GPU torch's
    cummin scan took 44 ms at 2^24 positions (H100), so this marks the
    k-1 starts before each boundary invalid with one scatter of
    (k-1) * len(bounds) indices instead."""
    dev = bounds.device
    valid = torch.ones(L + 1, dtype=torch.bool, device=dev)
    valid[total:] = False
    band = bounds.long()[:, None] - torch.arange(1, k, device=dev)
    valid[torch.where(band >= 0, band, L)] = False  # slot L absorbs s < 0
    return valid[:L]


def _no_mark(step: str) -> None:
    pass


def sorted_window_keys(packed, bounds, total: int, L: int, k: int,
                       canonical: bool, mark=_no_mark) -> torch.Tensor:
    """The window keys of the staged codes (kernel B1 for k <= 15, B2
    above), sorted; invalid windows hold the sentinel and sort last."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the port counts k <= {MAX_K}")
    n_keys = L - (k - 1)
    valid = _frag_window_validity(bounds, total, L, k)[:n_keys].contiguous()
    mark("validity")
    key = canonical_windows(packed, L, k, canonical, valid)
    mark("B1 pack" if k <= SINGLE_MAX_K else "B2 pack")
    s = torch.sort(key).values
    mark("sort")
    return s


def _sorted_runs(packed, bounds, total: int, L: int, k: int, canonical: bool,
                 mark=_no_mark):
    """Sorted window keys (int32 for k <= 15, int64 above; invalid windows
    hold the sentinel and sort last) with their live and run-head masks
    (reference count.py:253-282, the single-lane and pair branches)."""
    s = sorted_window_keys(packed, bounds, total, L, k, canonical, mark)
    prev = torch.cat([s.new_full((1,), -1), s[:-1]])
    live = s != key_sentinel(k)
    boundary = live & (s != prev)
    mark("run heads")
    return s, live, boundary


def _run_lengths(boundary: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Length of the run starting at each boundary position (reference
    count.py:185-196): a reverse running min of run-end indices."""
    n = boundary.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=boundary.device)
    term = torch.where(boundary | ~live, idx, torch.full_like(idx, n))
    rc = torch.cummin(term.flip(0), 0).values.flip(0)
    nb_excl = torch.cat([rc[1:], rc.new_full((1,), n)])
    return nb_excl - idx


def _run_reaches(s: torch.Tensor, live: torch.Tensor, c: int):
    """True at run heads of the sorted keys `s` whose run has >= c keys:
    position i+c-1 is live and holds the same key (reference
    count.py:298-316, on one key lane of either width)."""
    n = live.shape[0]
    if c <= 1:
        return torch.ones_like(live)
    if c - 1 >= n:
        return torch.zeros_like(live)
    shifted = torch.cat([s[c - 1 :], s.new_full((c - 1,), -1)])
    shifted_live = torch.cat([live[c - 1 :], live.new_zeros(c - 1)])
    return (shifted == s) & shifted_live


def count_kmers_frag(packed, bounds, total: int, L: int, k: int,
                     canonical: bool, mark=_no_mark):
    """Counts the canonical (or forward) k-mers of the L codes in
    `packed` (2-bit, kmerio_pack2 layout) split at the fragment
    boundaries `bounds` (int32: offsets[1:], possibly padded by repeating
    `total`).  Returns (keys, counts, n_unique): the sorted distinct keys
    and their counts, (n_unique,) keys (int32 for k <= 15, int64 above)
    and int32 counts (reference count.py:418-429, trimmed).  `mark(step)`
    is called after each step; the profiling tool
    (tools/profile_count.py) records a CUDA event there."""
    s, live, boundary = _sorted_runs(packed, bounds, total, L, k, canonical, mark)
    return count_runs(s, live, boundary, mark)


def count_runs(s, live, boundary, mark=_no_mark):
    """(keys, counts, n_unique) of the sorted keys `s` whose live prefix
    is `live` and whose run heads are `boundary`: the run heads and their
    positions compacted by kernel B3, and each count the distance to the
    next run head (the last: to the live count)."""
    pos = torch.arange(s.shape[0], dtype=torch.int32, device=s.device)
    (ckeys, cpos), n_sel = compact_select([s, pos], boundary)
    mark("B3 compact")
    n = int(n_sel)
    # Each run ends where the next begins; the last at the live count.
    ends = torch.cat([cpos[1:n], live.sum(dtype=torch.int32).view(1)])[:n]
    counts = ends - cpos[:n]
    mark("counts")
    return ckeys[:n], counts, n


def count_to_set_frag(
    packed, bounds, total: int, L: int, k: int, canonical: bool, cutoff: int
):
    """The cutoff-filtered distinct k-mers of the same input as
    count_kmers_frag (reference count.py:437-471, the compaction-kernel
    branch).  Returns (keys, n_kept, n_cut): keys (n_kept,), int32 for
    k <= 15 and int64 above."""
    s, live, boundary = _sorted_runs(packed, bounds, total, L, k, canonical)
    if cutoff <= _MAX_SHIFT_CUTOFF:
        keep = boundary & _run_reaches(s, live, cutoff)
    else:
        keep = boundary & (_run_lengths(boundary, live) >= cutoff)
    (ckeys,), n_kept = compact_select([s], keep)
    m = int(n_kept)
    return ckeys[:m], m, int(boundary.sum()) - m
