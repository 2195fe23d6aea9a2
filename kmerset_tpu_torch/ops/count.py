"""Device k-mer counting pipeline, k <= 31.

Counterpart of kmerset_tpu/ops/count.py, on torch tensors:

    [pack codes] + pack windows + canonical min + validity sentinel
    (kernel B1 for k <= 15, B2 above) -> sort -> run heads
    -> [cutoff test] -> compaction (kernel B3)

Two input forms, as in the reference.  The 2-bit staged form of the
port's own counts (count_kmers_frag, count_to_set_frag: the packed upload
and its fragment bounds, reference count.py:418-471) computes the window
validity on the device.  The unpacked-code form of the library surface
(count_kmers, count_to_set, canonical_windows: one 2-bit code per base
and the caller's window validity, reference count.py:174-182, 375-387,
437-461, with the host helper window_validity, :474-500) packs the codes
on their device first.  Both run the same kernels and steps.

Counts come out as differences between compacted run-head positions, as
in the reference's compaction-kernel branches (count.py:356-368,
451-457).  The sort is torch.sort, as the reference's is XLA's sort
outside any Pallas kernel.  Outputs are the reference's trimmed to their
live prefix, with int32 counts and the prefix length as a Python int
(reading it is the pipeline's one host sync).  Keys are 2k-bit numbers:
the *_frag entries keep the kernels' int32 keys for k <= 15 (2k <= 30
bits) and int64 above (up to k = 23 the reference's pair lanes combined,
count.py:174-182, and above it the reference's own int64 layout,
count.py:284-294); the unpacked-code entries return int64 keys at every
k, as the reference's do (to64, count.py:263-264).  Where the reference
sorts the pair lanes with lax.sort(num_keys=2) (count.py:271), the port
sorts one int64 key: the same order.

Not carried over, by design, because they exist for the TPU only:
good_sort_size and pad_to (sort-friendly padding), _use_pallas (backend
probing), _compact_runs (a flag-fused second sort standing in for slow
TPU scatters) and jax_enable_x64.
"""

from __future__ import annotations

import numpy as np
import torch

from . import backend
from .compact import compact_select
from .pack import MAX_K, key_sentinel
from .pack import canonical_windows as pack_windows

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


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k={k}: the port counts k <= {MAX_K}")


def _sort_windows(packed, L: int, k: int, canonical: bool,
                  valid) -> torch.Tensor:
    """The window keys of the L packed codes (kernel B1 for k <= 15, B2
    above), the sentinel where `valid` is False, sorted."""
    return torch.sort(pack_windows(packed, L, k, canonical, valid)).values


def sorted_window_keys(packed, bounds, total: int, L: int, k: int,
                       canonical: bool) -> torch.Tensor:
    """The window keys of the staged codes (kernel B1 for k <= 15, B2
    above), sorted; invalid windows hold the sentinel and sort last."""
    _check_k(k)
    n_keys = L - (k - 1)
    valid = _frag_window_validity(bounds, total, L, k)[:n_keys].contiguous()
    return _sort_windows(packed, L, k, canonical, valid)


def _run_heads(s: torch.Tensor, k: int):
    """The sorted keys `s` (invalid windows hold the sentinel and sort
    last) with their live and run-head masks (reference count.py:253-282,
    the single-lane and pair branches)."""
    prev = torch.cat([s.new_full((1,), -1), s[:-1]])
    live = s != key_sentinel(k)
    boundary = live & (s != prev)
    return s, live, boundary


def _sorted_runs(packed, bounds, total: int, L: int, k: int, canonical: bool):
    """Sorted window keys of the staged codes (int32 for k <= 15, int64
    above) with their live and run-head masks."""
    return _run_heads(sorted_window_keys(packed, bounds, total, L, k, canonical), k)


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
                     canonical: bool):
    """Counts the canonical (or forward) k-mers of the L codes in
    `packed` (2-bit, kmerio_pack2 layout) split at the fragment
    boundaries `bounds` (int32: offsets[1:], possibly padded by repeating
    `total`).  Returns (keys, counts, n_unique): the sorted distinct keys
    and their counts, (n_unique,) keys (int32 for k <= 15, int64 above)
    and int32 counts (reference count.py:418-429, trimmed)."""
    return count_runs(*_sorted_runs(packed, bounds, total, L, k, canonical))


def count_runs(s, live, boundary):
    """(keys, counts, n_unique) of the sorted keys `s` whose live prefix
    is `live` and whose run heads are `boundary`: the run heads and their
    positions compacted by kernel B3, and each count the distance to the
    next run head (the last: to the live count)."""
    pos = torch.arange(s.shape[0], dtype=torch.int32, device=s.device)
    (ckeys, cpos), n_sel = compact_select([s, pos], boundary)
    n = int(backend.download("n_unique", n_sel))
    # Each run ends where the next begins; the last at the live count.
    ends = torch.cat([cpos[1:n], live.sum(dtype=torch.int32).view(1)])[:n]
    counts = ends - cpos[:n]
    return ckeys[:n], counts, n


def _cutoff_runs(s, live, boundary, cutoff: int):
    """(keys, n_kept, n_cut): the run heads of the sorted keys `s` whose
    run has >= cutoff keys, compacted by kernel B3 (reference
    count.py:437-471, the compaction-kernel branch)."""
    if cutoff <= _MAX_SHIFT_CUTOFF:
        keep = boundary & _run_reaches(s, live, cutoff)
    else:
        keep = boundary & (_run_lengths(boundary, live) >= cutoff)
    (ckeys,), n_kept = compact_select([s], keep)
    m = int(backend.download("n_kept", n_kept))
    return ckeys[:m], m, int(backend.download("n_runs", boundary.sum())) - m


def count_to_set_frag(
    packed, bounds, total: int, L: int, k: int, canonical: bool, cutoff: int
):
    """The cutoff-filtered distinct k-mers of the same input as
    count_kmers_frag.  Returns (keys, n_kept, n_cut): keys (n_kept,),
    int32 for k <= 15 and int64 above."""
    return _cutoff_runs(
        *_sorted_runs(packed, bounds, total, L, k, canonical), cutoff
    )


# -- the unpacked-code entries (reference count.py:174-182, 376-461) -------


def pack_codes(codes: torch.Tensor) -> torch.Tensor:
    """(L,) 2-bit base codes -> (ceil(L/4),) uint8 on their device, 4
    codes per byte, low bits first (the native kmerio_pack2 layout that
    kernels B1 and B2 read).  Each code is masked to its low 2 bits
    first, so that a code above 3 (some readers code N as 4) cannot bleed
    into its neighbours' lanes: a window over it is invalid anyway."""
    L = codes.shape[0]
    c = (codes & 3).to(torch.uint8)
    if L % 4:
        c = torch.cat([c, c.new_zeros(4 - L % 4)])
    c = c.view(-1, 4)
    return c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)


def _stage_codes(codes: torch.Tensor, valid: torch.Tensor, k: int):
    """(packed codes, window validity (L - k + 1,), L) of the caller's
    codes and (L,) validity, on their device; None when no window fits.
    The validity is sliced to the window starts and copied into a fresh
    tensor where the slice is not 16-byte aligned, as B1/B2 read it with
    16-byte copies."""
    _check_k(k)
    if not isinstance(codes, torch.Tensor) or not isinstance(valid, torch.Tensor):
        raise TypeError("codes and valid must be torch tensors")
    L = codes.shape[0]
    if codes.dim() != 1 or valid.shape != (L,):
        raise ValueError(f"codes must be 1-D and valid ({L},)")
    if valid.device != codes.device:
        raise ValueError("codes and valid must be on one device")
    n = L - k + 1
    if n <= 0:
        return None
    v = valid[:n].to(torch.bool)
    if not v.is_contiguous() or v.data_ptr() % 16:
        v = v.clone(memory_format=torch.contiguous_format)
    return pack_codes(codes), v, L


def _code_runs(codes, valid, k: int, canonical: bool):
    """The sorted window keys of the caller's codes with their live and
    run-head masks (as _sorted_runs), or None when no window fits."""
    st = _stage_codes(codes, valid, k)
    if st is None:
        return None
    packed, v, L = st
    return _run_heads(_sort_windows(packed, L, k, canonical, v), k)


def canonical_windows(codes: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    """(L - k + 1,) int64 window keys of the (L,) codes, canonical or
    forward, on their device (kernel B1 for k <= 15, B2 above).  The
    reference returns (L,) keys whose last k - 1 wrap around the end
    (count.py:174-182); the port returns the windows that fit."""
    _check_k(k)
    L = codes.shape[0]
    if L < k:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    return pack_windows(pack_codes(codes), L, k, canonical).long()


def count_kmers(codes: torch.Tensor, valid: torch.Tensor, k: int,
                canonical: bool):
    """Counts the (canonical) k-mers of the (L,) uint8/int32 codes whose
    window start is True in the (L,) bool `valid`, on the codes' device.
    Returns (keys, counts, n_unique): (n_unique,) sorted distinct int64
    keys and their int32 counts (reference count.py:376-387, trimmed)."""
    runs = _code_runs(codes, valid, k, canonical)
    if runs is None:
        return (torch.empty(0, dtype=torch.int64, device=codes.device),
                torch.empty(0, dtype=torch.int32, device=codes.device), 0)
    keys, counts, n = count_runs(*runs)
    return keys.long(), counts, n


def count_to_set(codes: torch.Tensor, valid: torch.Tensor, k: int,
                 canonical: bool, cutoff: int):
    """The distinct (canonical) k-mers of count_kmers' input whose count
    reaches `cutoff` (reference count.py:437-461, trimmed).  Returns
    (keys, n_kept, n_cut): (n_kept,) sorted int64 keys."""
    runs = _code_runs(codes, valid, k, canonical)
    if runs is None:
        return torch.empty(0, dtype=torch.int64, device=codes.device), 0, 0
    keys, m, n_cut = _cutoff_runs(*runs, cutoff)
    return keys.long(), m, n_cut


def window_validity(offsets: np.ndarray, total: int, k: int) -> np.ndarray:
    """Host helper: windows fully inside one fragment are valid
    (split-at-'N' semantics, reference: lib/core/kmer_counter.h:78).

    A window starting at s is invalid iff some fragment boundary o
    (interior or the terminal `total`) lies in (s, s + k - 1] — i.e.
    s in [o - k + 1, o).  Only those (k-1)-wide bands are materialized
    (<= (k-1) * n_fragments indices), instead of several full-length
    int64 temporaries."""
    valid = np.ones(total, dtype=bool)
    if total == 0 or k <= 1:
        return valid
    from ..core.graph import expand_ranges

    o = np.asarray(offsets, dtype=np.int64)[1:]
    lo = np.maximum(o - (k - 1), 0)
    _, idx = expand_ranges(lo, np.minimum(o, total))
    valid[idx] = False
    return valid
