"""Device unitig front-end: side tables -> terminal tests -> oriented
successor.

Counterpart of kmerset_tpu/ops/unitigs.py:_build's unitig_succ (:33-56)
and device_unitig_succ (:150-186), whose host form is the front half of
kmerset_tpu/core/spss.py:get_unitigs_canonical (:628-652).  Its memory
plan is the port's own (device_unitig_succ): the whole-set arrays on the
device up to a ceiling of the memory budget, and above it a bounded mode
that keeps only the set and its degrees there.  Orientation
convention of core/spss.py: node u = (entity << 1) | o, o = 0 exits the
right side, o = 1 the left; mirror(u) = u ^ 1.  The chain walk and the
string emission take exactly these arrays: on the device (kernel W1,
ops/walk.py) where device_unitig_succ keeps them there, in either mode,
else on the host (core/spss.py).  The directed graph's side tables
(device_side_tables_directed) are built on the device the same way, in
query chunks, for the host's start and end tests.

The side codes (dispatch_sides, device_unitig_sides: the reference's
unitig_sides, :61-144) are the front-end's link format for a slow link:
one byte per k-mer, which core/native.succ_from_sides turns back into
the successor on the host.  Every entry point takes a resident handle
(ops/resident.DeviceKmers, validated by its caller), whose tensor it uses
in place of uploading A.
"""

from __future__ import annotations

import logging
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils import trace
from . import backend
from .neighbors import side_tables

logger = logging.getLogger("kmerset")


def _tables(A: torch.Tensor, k: int, canonical: bool = True, lo: int = 0,
            hi: Optional[int] = None, with_base: bool = False):
    """side_tables of A[lo:hi], counted in front_end.query_chunks: every
    side-table build of the front-end goes through here."""
    trace.add("front_end.query_chunks")
    return side_tables(A, k, canonical, lo, hi, with_base=with_base)


def _chunked_side_tables(A: torch.Tensor, k: int, query_chunk: int):
    """side_tables of all of A, built over ranges A[lo:lo + query_chunk]
    each joined against the whole of A, into whole per-k-mer arrays
    (~26 B per k-mer)."""
    n = A.shape[0]
    if query_chunk >= n:
        return _tables(A, k)
    out = []
    for _ in range(2):
        out.append((torch.empty(n, dtype=torch.int32, device=A.device),
                    torch.empty(n, dtype=torch.int64, device=A.device),
                    torch.empty(n, dtype=torch.bool, device=A.device)))
    for lo in range(0, n, query_chunk):
        hi = min(lo + query_chunk, n)
        for whole, part in zip(out, _tables(A, k, True, lo, hi)):
            for w, p in zip(whole, part):
                w[lo:hi] = p
    return out[0], out[1]


def _terminals(rows, rdeg: torch.Tensor, ldeg: torch.Tensor):
    """(term_l, term_r) (m,) bool of the m k-mers whose side tables are
    `rows` (with or without the base), with rdeg and ldeg the degrees of
    the whole set (any integer dtype)."""
    (rd, rnbr, rsame, *_), (ld, lnbr, lsame, *_) = rows
    # Terminal tests (reference: lib/core/spss.h:276-313): a side is
    # terminal unless its unique mate's corresponding side also has a
    # unique back-edge.
    mate_r = torch.where(rsame, rdeg[rnbr], ldeg[rnbr])
    term_r = (rd != 1) | (mate_r != 1)
    del mate_r
    mate_l = torch.where(lsame, ldeg[lnbr], rdeg[lnbr])
    term_l = (ld != 1) | (mate_l != 1)
    return term_l, term_r


def _exits(rows, rdeg: torch.Tensor, ldeg: torch.Tensor):
    """(succ (2m,) int64 with -1 at terminal exits, term_l, term_r (m,)
    bool) of the m k-mers whose side tables are `rows`, with rdeg and
    ldeg the degrees of the whole set (any integer dtype)."""
    (rd, rnbr, rsame), (ld, lnbr, lsame) = rows
    term_l, term_r = _terminals(rows, rdeg, ldeg)
    # After a same-side step the orientation flips (reference FindPath,
    # lib/core/spss.h:394-423).
    succ = torch.empty(2 * rd.shape[0], dtype=torch.int64, device=rd.device)
    succ[0::2] = torch.where(term_r, -1, 2 * rnbr + rsame)
    succ[1::2] = torch.where(term_l, -1, 2 * lnbr + (~lsame).to(torch.int64))
    return succ, term_l, term_r


def unitig_succ(
    A: torch.Tensor, k: int, query_chunk: Optional[int] = None
) -> Tuple[torch.Tensor, ...]:
    """(succ (2n,) int64 with -1 at terminal exits, term_l, term_r, both
    (n,) bool) of the sorted unique canonical k-mers A on A's device.  The
    side tables are built over query ranges of `query_chunk` k-mers (all
    of A in one range by default); the result is the same at every
    chunk size."""
    if query_chunk is not None and query_chunk < 1:
        raise ValueError(f"query_chunk must be >= 1, got {query_chunk}")
    rows = _chunked_side_tables(
        A, k, A.shape[0] if query_chunk is None else query_chunk
    )
    succ, term_l, term_r = _exits(rows, rows[0][0], rows[1][0])
    return succ, term_l, term_r, term_l & term_r


def bounded_unitig_succ(A: torch.Tensor, k: int, query_chunk: int,
                        keep: bool = False):
    """unitig_succ of A as host arrays, with only A and the two sides'
    degrees (uint8, at most 4) on the device for the whole set: ~10 bytes
    per k-mer beside one query chunk, where unitig_succ keeps ~80.  One
    pass over the query chunks takes the degrees (span
    "front_end.degrees"); a second (span "front_end.rows") builds each
    chunk's side tables again, takes its terminal tests and successor
    rows with the whole set's degrees, and downloads them (spans
    "front_end.download").  With `keep` (the device walk's plan) the rows
    are written into whole-set tensors on A's device instead (~29 bytes
    per k-mer with A and the degrees), and nothing is downloaded.  Both
    pass spans carry `chunks` (the query chunks of a pass) and end on a
    sync, so that they time the device's work.  Returns ((succ, term_l,
    term_r, both), seconds spent downloading).  device_unitig_succ takes
    it above backend.front_end_ceiling."""
    if query_chunk < 1:
        raise ValueError(f"query_chunk must be >= 1, got {query_chunk}")
    n = A.shape[0]
    chunks = -(-n // query_chunk)
    with trace.span("front_end.degrees", chunks=chunks):
        rdeg, ldeg = _degrees(A, k, query_chunk)
        backend.sync(A.device)
    if keep:
        succ = torch.empty(2 * n, dtype=torch.int64, device=A.device)
        term_l = torch.empty(n, dtype=torch.bool, device=A.device)
        term_r = torch.empty_like(term_l)
    else:
        succ = np.empty(2 * n, dtype=np.int64)
        term_l = np.empty(n, dtype=bool)
        term_r = np.empty(n, dtype=bool)
    download_s = 0.0
    with trace.span("front_end.rows", chunks=chunks):
        for lo in range(0, n, query_chunk):
            hi = min(lo + query_chunk, n)
            rows = _exits(_tables(A, k, True, lo, hi), rdeg, ldeg)
            whole = (succ[2 * lo : 2 * hi], term_l[lo:hi], term_r[lo:hi])
            if keep:
                for w, part in zip(whole, rows):
                    w.copy_(part)
                continue
            backend.sync(A.device)
            with trace.timed("front_end.download") as sp:
                for host, part, what in zip(whole, rows,
                                            ("succ", "term_l", "term_r")):
                    host[:] = backend.download(what, part)
            download_s += sp.seconds
        both = term_l & term_r
        backend.sync(A.device)
    return (succ, term_l, term_r, both), download_s


def _degrees(A: torch.Tensor, k: int, query_chunk: int):
    """(rdeg, ldeg) (n,) uint8 of the canonical graph of A, built over
    query ranges of `query_chunk` k-mers."""
    n = A.shape[0]
    rdeg = torch.empty(n, dtype=torch.uint8, device=A.device)
    ldeg = torch.empty_like(rdeg)
    for lo in range(0, n, query_chunk):
        hi = min(lo + query_chunk, n)
        (rd, _, _), (ld, _, _) = _tables(A, k, True, lo, hi)
        rdeg[lo:hi] = rd
        ldeg[lo:hi] = ld
    return rdeg, ldeg


def _side_codes(rows, rdeg: torch.Tensor, ldeg: torch.Tensor) -> torch.Tensor:
    """(m,) uint8 side codes of the m k-mers whose side tables with the
    base are `rows` (reference unitig_sides, unitigs.py:68-94): bit 0
    term_r, bits 1-2 base_r, bit 3 same_r, bit 4 term_l, bits 5-6 base_l,
    bit 7 same_l, the base and same bits zeroed on terminal sides."""
    (_, _, rsame, rbase), (_, _, lsame, lbase) = rows
    term_l, term_r = _terminals(rows, rdeg, ldeg)
    r = torch.where(term_r, 1, (rbase << 1) | (rsame.to(torch.int32) << 3))
    left = torch.where(term_l, 16, (lbase << 5) | (lsame.to(torch.int32) << 7))
    return (r | left).to(torch.uint8)


def dispatch_sides(arr: torch.Tensor, k: int, query_chunk: Optional[int] = None):
    """(n,) uint8 side codes of the sorted unique canonical k-mers `arr`
    (int64) on its device, launched on the current stream and not waited
    for (reference dispatch_sides, unitigs.py:102-110).  The side tables
    are built in query chunks of `query_chunk` k-mers, by default
    backend.front_end_plan's for the device's memory budget, as
    device_unitig_succ's; below n the degrees of the whole set are built
    first (a uint8 each per side), as in bounded_unitig_succ.  The result
    is the same at every chunk size."""
    n = arr.shape[0]
    if query_chunk is None:
        query_chunk = backend.front_end_plan(n, backend.memory_budget(arr.device))[1]
    if query_chunk < 1:
        raise ValueError(f"query_chunk must be >= 1, got {query_chunk}")
    if query_chunk >= n:
        rows = _tables(arr, k, with_base=True)
        return _side_codes(rows, rows[0][0], rows[1][0])
    rdeg, ldeg = _degrees(arr, k, query_chunk)
    out = torch.empty(n, dtype=torch.uint8, device=arr.device)
    for lo in range(0, n, query_chunk):
        hi = min(lo + query_chunk, n)
        out[lo:hi] = _side_codes(_tables(arr, k, True, lo, hi, with_base=True),
                                 rdeg, ldeg)
    return out


def _set_on_device(A: np.ndarray, dev: torch.device, resident):
    """(the set as an int64 tensor on dev, upload seconds): the resident
    handle's tensor, or A uploaded (the span "front_end.upload").  A
    handle of another length or on another device raises: the caller
    validates it first (DeviceKmers.valid_for, DeviceKmers.on)."""
    if resident is not None:
        if resident.n != A.shape[0] or not resident.on(dev):
            raise ValueError(
                f"resident handle of {resident.n} k-mers on {resident.arr.device} "
                f"for a set of {A.shape[0]} on {dev}"
            )
        return resident.graph_input(), 0.0
    with trace.timed("front_end.upload") as sp:
        At = backend.upload("set", np.ascontiguousarray(A, dtype=np.int64), dev)
        backend.sync(dev)
    return At, sp.seconds


def device_unitig_sides(A: np.ndarray, k: int, *, device, resident=None) -> np.ndarray:
    """The (n,) uint8 side codes of the host array A (sorted unique
    canonical int64 k-mers), built on `device`, on the host (reference
    device_unitig_sides, unitigs.py:113-144): the 1 B/k-mer link format
    that core/native.succ_from_sides rebuilds the successor from, built
    on a resident handle's tensor, or on A uploaded.  The reference also
    collects codes that the count prefetched (:121-126); the port's count
    prefetches none (ops/resident.py).  Logs the upload, device and
    download seconds at debug level."""
    n = int(A.shape[0])
    dev = resolve_device(device)
    with backend.device_lock(dev):
        At, up_s = _set_on_device(A, dev, resident)
        with trace.timed("front_end.device") as dv:
            sides = dispatch_sides(At, k)
            backend.sync(dev)
        with trace.timed("front_end.download") as dl:
            out = backend.download("side codes", sides)
    logger.debug(
        "unitigs: side codes upload %.4f s, device %.4f s, download %.4f s "
        "(%d k-mers, %d B, %s)", up_s, dv.seconds, dl.seconds, n, out.nbytes,
        "resident" if resident is not None else "uploaded",
    )
    return out


def device_unitig_succ(
    A: np.ndarray, k: int, *, device, query_chunk: Optional[int] = None,
    resident=None, keep: bool = False,
) -> tuple:
    """unitig_succ of the host array A (sorted unique canonical int64
    k-mers) on `device`, as host arrays: (succ int64, term_l, term_r,
    both bool).  The plan comes from the device's backend.memory_budget
    (backend.front_end_plan): up to backend.front_end_ceiling k-mers the
    whole-set arrays stay on the device (unitig_succ), above it only A
    and the degrees do (bounded_unitig_succ).  Either way the set is on
    the device once (the resident handle's tensor, else A uploaded) and
    its side tables are built in query chunks of `query_chunk` k-mers, by
    default what the budget leaves beside the mode's whole-set arrays;
    the result is the same in every plan.  `keep` is the caller's plan of
    the device walk (backend.walk_route): in either mode nothing is
    downloaded, and the four arrays come back as tensors on the device,
    with the set's tensor fifth (ops/walk.py's input).  The span
    "front_end.plan" holds the plan (kmers, ceiling, budget, mode, walk,
    query_chunk: k-mers a query chunk, query_chunks: chunks a pass, 1 in
    one shot unless its query chunk is smaller than the set); in the
    bounded mode the spans "front_end.degrees" and "front_end.rows" time
    its two passes (bounded_unitig_succ).  The counter front_end.bounded
    counts the bounded calls, walk.bounded those with `keep`, whose sets
    W1 walks, and front_end.query_chunks the side-table builds of every
    pass (2 * query_chunks bounded).  Logs the plan (mode, query chunk,
    ceiling and budget), then the upload, device and download times and
    bytes, the chunk count and the mode at debug level."""
    n = int(A.shape[0])
    dev = resolve_device(device)
    with backend.device_lock(dev):
        with trace.span("front_end.plan") as sp:
            budget = backend.memory_budget(dev)
            ceiling = backend.front_end_ceiling(budget)
            bounded, planned = backend.front_end_plan(n, budget, keep)
            if query_chunk is None:
                query_chunk = planned
            sp.set(kmers=n, ceiling=ceiling, budget=budget,
                   mode="bounded" if bounded else "one-shot",
                   walk="device" if keep else "host", query_chunk=query_chunk,
                   query_chunks=-(-n // max(1, query_chunk)))
        logger.debug("unitigs: %s, query chunk %d of %d k-mers (ceiling %d, "
                     "budget %d)", "bounded" if bounded else "one-shot",
                     query_chunk, n, ceiling, budget)
        At, up_s = _set_on_device(A, dev, resident)
        if bounded:
            trace.add("front_end.bounded")
            if keep:
                trace.add("walk.bounded")
            with trace.timed("front_end.device", bounded=True) as dv:
                out, download_s = bounded_unitig_succ(At, k, query_chunk, keep)
            device_s = dv.seconds - download_s
            # `both` is made on the host where the rows are downloaded.
            down_b = 0 if keep else sum(x.nbytes for x in out[:3])
        else:
            with trace.timed("front_end.device") as dv:
                out = unitig_succ(At, k, query_chunk)
                backend.sync(dev)
            device_s, download_s, down_b = dv.seconds, 0.0, 0
            if not keep:
                with trace.timed("front_end.download") as dl:
                    out = tuple(backend.download(what, x) for what, x in
                                zip(("succ", "term_l", "term_r", "both"), out))
                download_s = dl.seconds
                down_b = sum(x.nbytes for x in out)
    logger.debug(
        "unitigs: device front-end upload %.4f s, device %.4f s, "
        "download %.4f s of %d B (%d k-mers, %d query chunks, %s%s)", up_s,
        device_s, download_s, down_b, n,
        -(-n // max(1, query_chunk)), "bounded" if bounded else "one shot",
        ", resident" if resident is not None else "",
    )
    return (*out, At) if keep else out


def device_side_tables_directed(
    A: np.ndarray, k: int, *, device, query_chunk: Optional[int] = None,
    resident=None,
):
    """((outdeg, next), (indeg, prev)) of the directed graph of the host
    array A (sorted unique forward int64 k-mers), built on `device` as
    host int64 arrays: the device form of the reference's directed side
    tables (kmerset_tpu/core/spss.py:_side_tables with canonical=False,
    :122-167, whose device arm is ops/neighbors.device_side_tables).  The
    set is on the device once (the resident handle's tensor, else A
    uploaded) and its rows are built and downloaded in query chunks of
    `query_chunk` k-mers, by default backend.front_end_plan's for the
    device's memory budget; the result is the same at every chunk size.
    Logs the upload, device and download times at debug level."""
    if query_chunk is not None and query_chunk < 1:
        raise ValueError(f"query_chunk must be >= 1, got {query_chunk}")
    n = int(A.shape[0])
    out = tuple((np.empty(n, np.int64), np.empty(n, np.int64)) for _ in range(2))
    dev = resolve_device(device)
    with backend.device_lock(dev):
        if query_chunk is None:
            query_chunk = backend.front_end_plan(n, backend.memory_budget(dev))[1]
        At, up_s = _set_on_device(A, dev, resident)
        download_s = 0.0
        with trace.timed("front_end.device", directed=True) as dv:
            for lo in range(0, n, query_chunk):
                hi = min(lo + query_chunk, n)
                rows = _tables(At, k, False, lo, hi)
                backend.sync(dev)
                with trace.timed("front_end.download") as dl:
                    for host, (deg, nbr, _), side in zip(out, rows, ("out", "in")):
                        host[0][lo:hi] = backend.download(f"{side} degree", deg)
                        host[1][lo:hi] = backend.download(f"{side} neighbor", nbr)
                download_s += dl.seconds
    logger.debug(
        "unitigs: device side tables upload %.4f s, device %.4f s, "
        "download %.4f s (%d k-mers, %d query chunks, directed%s)", up_s,
        dv.seconds - download_s, download_s, n, -(-n // query_chunk),
        ", resident" if resident is not None else "",
    )
    return out
