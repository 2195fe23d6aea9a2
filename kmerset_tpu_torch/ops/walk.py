"""Kernel W1: the canonical unitig walk and emission on the device
(csrc/walk.cu).

Replaces no Pallas kernel: it takes over the host C walk of the canonical
SPSS build (core/spss.py:get_unitigs_canonical through
core/native.chain_walk_kept and emit_kmer_chains), fed by the graph
front-end's arrays (ops/unitigs.unitig_succ: succ, term_l, term_r, both)
where they lie, so that only the finished strings cross the link.  The
strings are those of the host walk with the native library, in its order:
chains in the completion order of kmerio_chain_pairs' 64-lane batches,
each mirror pair once in the orientation of the reference's skip rule,
then the isolated k-mers in entity order.  Pure cycles are left to the
host (covered says which entities the strings hold).

Three stages, each a kernel launch on a CUDA tensor (counted in
launch.W1, utils/trace.py) and its plain PyTorch version on a CPU tensor,
with one contract:
- measure: (end, length) of the chain of every start;
- rank: the mirror pairs, each recorded once with its kept start, ranked
  within its batch of LANES starts by (length, lane), with the bytes of
  the strings ranked before it, and the batch's chain count and bytes;
- emit: the strings of the recorded chains at their offsets, then the
  isolated k-mers, and the covered entities.
Each stage raises a flag (`bad`, one int32) where the host walk would
refuse the successor array (a cycle reached from a start, mirrors that
do not pair, a walk that does not stop where it was measured); the
callers then return None, and the build raises (core/spss.py: the
front-end's own arrays keep the chain contract).  chain_walk and
emit_strings put the stages together, each ending in one small download
that waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..utils import trace
from . import backend

LANES = 64  # starts per batch: kmerio_chain_pairs' interleave width


class Chains(NamedTuple):
    """The recorded chains of one set, per start (rank -1: not recorded)
    and per batch (exclusive scans), with their totals."""

    starts: torch.Tensor  # (ns,) int64: right exits, then left exits
    lens: torch.Tensor  # (ns,) int64 nodes per chain
    rank: torch.Tensor  # (ns,) int32 rank in the batch, or -1
    kept: torch.Tensor  # (ns,) int64 kept start where rank >= 0
    before: torch.Tensor  # (ns,) int64 bytes of the batch's strings ranked before
    batch_first: torch.Tensor  # (nb,) int64 chains of the batches before
    batch_at: torch.Tensor  # (nb,) int64 bytes of the batches before
    n_chains: int
    chain_bytes: int


class Emitted(NamedTuple):
    codes: torch.Tensor  # uint8: the chains' strings, then the isolated k-mers
    offsets: torch.Tensor  # int64, one more than strings
    covered: torch.Tensor  # (n,) uint8: 1 where a string holds the entity
    n_covered: int


def starts_of(term_l: torch.Tensor, term_r: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(starts, n_right): the nodes that leave a k-mer terminal on one side
    only by its other side, as the host walk takes them (right exits 2i of
    the k-mers terminal on the left, ascending; then left exits 2i + 1 of
    those terminal on the right, ascending), and how many are right
    exits."""
    right = torch.nonzero(term_l & ~term_r).squeeze(1) * 2
    left = torch.nonzero(term_r & ~term_l).squeeze(1) * 2 + 1
    return torch.cat([right, left]), int(right.shape[0])


def _lib():
    from . import _build

    return _build.load(), _build.check


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def measure_plain(succ, starts, bad):
    """Plain measure: (ends, lens) of the chains of `starts`, walked all
    at once, one step a round; sets `bad` on a walk past len(succ) + 1
    nodes or to a node out of range."""
    n = succ.shape[0]
    ends = starts.clone()
    lens = torch.zeros_like(starts)
    cur = starts.clone()
    live = torch.arange(starts.shape[0], device=starts.device)
    steps = 0
    while live.numel():
        u = cur[live]
        if steps > n or bool((u >= n).any()):
            bad.fill_(1)
            break
        ends[live] = u
        lens[live] += 1
        nxt = succ[u]
        cur[live] = nxt
        live = live[nxt >= 0]
        steps += 1
    return ends, lens


def measure(succ, starts, bad):
    """(ends, lens) (ns,) int64 of the chain of every start: kernel W1's
    walk_measure on CUDA, measure_plain on the CPU."""
    if succ.device.type == "cpu":
        return measure_plain(succ, starts, bad)
    ends = torch.empty_like(starts)
    lens = torch.empty_like(starts)
    if not starts.numel():
        return ends, lens
    lib, check = _lib()
    with torch.cuda.device(succ.device):
        check(lib, lib.kmerset_walk_measure(
            succ.data_ptr(), succ.shape[0], starts.data_ptr(), starts.shape[0],
            ends.data_ptr(), lens.data_ptr(), bad.data_ptr(), _stream()),
            "walk kernel W1 (measure)")
    trace.add("launch.W1")
    return ends, lens


def _mirror_positions(starts, n_right, ends):
    """Position in `starts` of each chain's mirror start ends ^ 1, or -1."""
    m = ends ^ 1
    pm = torch.full_like(m, -1)
    for lo, hi, odd in ((0, n_right, 0), (n_right, starts.shape[0], 1)):
        seg = starts[lo:hi]
        sel = (m & 1) == odd
        if not seg.numel() or not bool(sel.any()):
            continue
        q = m[sel]
        i = torch.searchsorted(seg, q)
        hit = (i < seg.numel()) & (seg[i.clamp(max=seg.numel() - 1)] == q)
        pm[sel] = torch.where(hit, i + lo, -1)
    return pm


def _exclusive(x):
    return torch.cumsum(x, 0) - x


def rank_plain(A, starts, n_right, ends, lens, k, bad):
    """Plain rank: (rank, kept, before, batch_count, batch_bytes), as
    walk_rank computes them; sets `bad` where a chain's mirror start does
    not walk back to its own start's mirror in as many nodes."""
    ns = starts.shape[0]
    dev = starts.device
    p = torch.arange(ns, device=dev)
    pm = _mirror_positions(starts, n_right, ends)
    has = pm >= 0
    pmc = pm.clamp(min=0)
    if bool((has & ((ends[pmc] != (starts ^ 1)) | (lens[pmc] != lens))).any()):
        bad.fill_(1)
    rec = ~has | (p <= pm)
    kept = torch.where(A[starts >> 1] >= A[ends >> 1], starts, ends ^ 1)
    idx = torch.nonzero(rec).squeeze(1)
    idx = idx[torch.sort(lens[idx] * LANES + (idx & (LANES - 1)), stable=True).indices]
    idx = idx[torch.sort(idx // LANES, stable=True).indices]
    batch = idx // LANES
    nb = -(-ns // LANES)
    size = lens[idx] + k - 1
    batch_count = torch.zeros(nb, dtype=torch.int64, device=dev)
    batch_count.scatter_add_(0, batch, torch.ones_like(batch))
    batch_bytes = torch.zeros(nb, dtype=torch.int64, device=dev)
    batch_bytes.scatter_add_(0, batch, size)
    rank = torch.full((ns,), -1, dtype=torch.int32, device=dev)
    rank[idx] = (torch.arange(idx.shape[0], device=dev)
                 - _exclusive(batch_count)[batch]).to(torch.int32)
    before = torch.zeros(ns, dtype=torch.int64, device=dev)
    before[idx] = _exclusive(size) - _exclusive(batch_bytes)[batch]
    return rank, kept, before, batch_count, batch_bytes


def rank(A, starts, n_right, ends, lens, k, bad):
    """(rank (ns,) int32, kept, before (ns,) int64, batch_count,
    batch_bytes (ceil(ns / LANES),) int64): kernel W1's walk_rank on
    CUDA, rank_plain on the CPU.  kept is defined where rank >= 0."""
    if A.device.type == "cpu":
        return rank_plain(A, starts, n_right, ends, lens, k, bad)
    ns = starts.shape[0]
    nb = -(-ns // LANES)
    rk = torch.empty(ns, dtype=torch.int32, device=A.device)
    kept = torch.empty_like(starts)
    before = torch.empty_like(starts)
    batch_count = torch.empty(nb, dtype=torch.int64, device=A.device)
    batch_bytes = torch.empty_like(batch_count)
    if not ns:
        return rk, kept, before, batch_count, batch_bytes
    lib, check = _lib()
    with torch.cuda.device(A.device):
        check(lib, lib.kmerset_walk_rank(
            A.data_ptr(), starts.data_ptr(), ns, n_right, ends.data_ptr(),
            lens.data_ptr(), k, bad.data_ptr(), rk.data_ptr(), kept.data_ptr(),
            before.data_ptr(), batch_count.data_ptr(), batch_bytes.data_ptr(),
            _stream()), "walk kernel W1 (rank)")
    trace.add("launch.W1")
    return rk, kept, before, batch_count, batch_bytes


def _kmer_codes(v, k, flip):
    """(m, k) codes of the k-mers v, read as their reverse complements
    where flip is set."""
    j = torch.arange(k, device=v.device)
    fw = (v[:, None] >> (2 * (k - 1 - j))) & 3
    rc = 3 - ((v[:, None] >> (2 * j)) & 3)
    return torch.where(flip[:, None], rc, fw).to(torch.uint8)


def emit_plain(A, succ, k, ch: Chains, iso, codes, offsets, covered, bad):
    """Plain emit: writes the strings, offsets and covered entities as
    walk_emit does; sets `bad` where a kept walk does not stop at its
    measured length."""
    n = succ.shape[0]
    dev = succ.device
    idx = torch.nonzero(ch.rank >= 0).squeeze(1)
    batch = idx // LANES
    at = ch.batch_at[batch] + ch.before[idx]
    lens = ch.lens[idx]
    u = ch.kept[idx].clone()
    j = torch.arange(k, device=dev)
    offsets[0] = 0
    codes[(at[:, None] + j).reshape(-1)] = _kmer_codes(
        A[u >> 1], k, (u & 1).bool()).reshape(-1)
    covered[u >> 1] = 1
    live = torch.arange(idx.shape[0], device=dev)
    t = 1
    while True:
        live = live[lens[live] > t]
        if not live.numel():
            break
        nxt = succ[u[live]]
        if bool(((nxt < 0) | (nxt >= n)).any()):
            bad.fill_(1)
            return
        u[live] = nxt
        v = A[nxt >> 1]
        codes[at[live] + k - 1 + t] = torch.where(
            (nxt & 1).bool(), 3 - ((v >> (2 * (k - 1))) & 3), v & 3).to(torch.uint8)
        covered[nxt >> 1] = 1
        t += 1
    if idx.numel() and bool((succ[u] >= 0).any()):
        bad.fill_(1)
    offsets[ch.batch_first[batch] + ch.rank[idx].long() + 1] = at + lens + k - 1
    jj = torch.arange(iso.shape[0], device=dev)
    base = ch.chain_bytes
    codes[(base + jj[:, None] * k + j).reshape(-1)] = _kmer_codes(
        A[iso], k, torch.zeros_like(iso, dtype=torch.bool)).reshape(-1)
    covered[iso] = 1
    offsets[ch.n_chains + jj + 1] = base + (jj + 1) * k


def emit(A, succ, k, ch: Chains, iso, codes, offsets, covered, bad) -> None:
    """Writes the strings of the recorded chains and of the isolated
    k-mers `iso` into codes and offsets, and marks covered: kernel W1's
    walk_emit on CUDA, emit_plain on the CPU."""
    if succ.device.type == "cpu":
        emit_plain(A, succ, k, ch, iso, codes, offsets, covered, bad)
        return
    lib, check = _lib()
    with torch.cuda.device(succ.device):
        check(lib, lib.kmerset_walk_emit(
            A.data_ptr(), succ.data_ptr(), succ.shape[0], k,
            ch.starts.shape[0], ch.rank.data_ptr(), ch.kept.data_ptr(),
            ch.lens.data_ptr(), ch.before.data_ptr(), ch.batch_first.data_ptr(),
            ch.batch_at.data_ptr(), iso.data_ptr(), iso.shape[0], ch.n_chains,
            ch.chain_bytes, codes.data_ptr(), offsets.data_ptr(),
            covered.data_ptr(), bad.data_ptr(), _stream()),
            "walk kernel W1 (emit)")
    trace.add("launch.W1")


def chain_walk(succ, term_l, term_r, A, k) -> Optional[Chains]:
    """The recorded chains of the canonical graph whose front-end arrays
    are succ, term_l and term_r, over the set A (int64, on their device):
    measure and rank, the per-batch scans, and one download of the flag
    and the totals.  None where the host walk would refuse succ."""
    starts, n_right = starts_of(term_l, term_r)
    bad = torch.zeros(1, dtype=torch.int32, device=succ.device)
    ends, lens = measure(succ, starts, bad)
    rk, kept, before, batch_count, batch_bytes = rank(
        A, starts, n_right, ends, lens, k, bad)
    totals = backend.download("walk totals", torch.stack([
        bad[0].to(torch.int64), batch_count.sum(), batch_bytes.sum()]))
    if totals[0]:
        return None
    return Chains(starts, lens, rk, kept, before, _exclusive(batch_count),
                  _exclusive(batch_bytes), int(totals[1]), int(totals[2]))


def emit_strings(ch: Chains, succ, both, A, k) -> Optional[Emitted]:
    """The strings of the chains `ch` and of the isolated k-mers (`both`),
    on the device, with the covered entities and their count (one
    download of the flag and the count).  None where a kept walk does not
    stop at its measured length."""
    dev = succ.device
    iso = torch.nonzero(both).squeeze(1)
    n_iso = iso.shape[0]
    codes = torch.empty(ch.chain_bytes + n_iso * k, dtype=torch.uint8, device=dev)
    offsets = torch.empty(ch.n_chains + n_iso + 1, dtype=torch.int64, device=dev)
    covered = torch.zeros(both.shape[0], dtype=torch.uint8, device=dev)
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    emit(A, succ, k, ch, iso, codes, offsets, covered, bad)
    totals = backend.download("walk totals", torch.stack([
        bad[0].to(torch.int64), covered.sum()]))
    if totals[0]:
        return None
    return Emitted(codes, offsets, covered, int(totals[1]))
