"""Host <-> device staging for the port's counting pipeline.

Counterpart of the single-device paths of kmerset_tpu/ops/backend.py:
device_count (:694-820), device_unique (:499-519), the staging they share
(_staged_windows_u8, :460-496), and the out-of-core chunked paths
device_count_chunked and device_unique_chunked (:630-688).  The
reference's host state is the (codes uint8, offsets int64) pair that the
native FASTA parser (core/native.parse_fasta_bytes) and
core/io.reads_to_codes produce; `stage` turns it into the tensors that
ops/count.py takes, and the fetches turn the device outputs back into the
reference's numpy layout.  The same pair can come from the FASTA parse on
the device (parse_route, upload_file, then kernel P1 of ops/parse.py) as
tensors there: `stage` then packs it there, and the chunked paths cut its
chunks there (device_chunk_slices).

The one-shot ceiling is a function of the key width and the memory the
device has left (window_ceiling, memory_budget), not the reference's
MAX_DEVICE_WINDOWS, which was sized for a 16 GB TPU.  Above it the count
and the decode run in halo chunks of at most that many windows and merge
the sorted runs on the host: the port's copies of the reference's
_merge_count_pair and _merge_cascade (backend.py:522-567), and its own
keys-only _merge_key_pair.  count_plan makes the one-shot-or-chunked
decision of a count or decode from one read of the budget, logs it at
debug level and holds it in the span "<what>.plan" (windows, chunks,
chunk, ceiling and budget); the chunked paths log the seconds of their
host merge, whose span "<what>.merge" holds the chunks and the keys in
and out.

The link formats (reference backend.py:141-200, 694-820): `_slow_link`
says whether the host-device link is slow (KMERSET_TPU_LINK=fast|slow, or
one 8 MB round trip on a CUDA device under 1 GiB/s; the CPU is fast).  On
a slow link device_count downloads its sorted keys gap-encoded
(ops/deltas.py) from DELTA_MIN_KEYS keys on.  It leaves out the
reference's side-code prefetch (:755-765): the count does not decide the
graph front-end's route (side_code_route), which builds its side codes
in the SPSS phase.  With resident=True device_count also returns the set
resident on the device (ops/resident.py), which the front-end takes
without an upload.  The
reference's on-disk cache of the probe's verdict (_link_cache_path) and
its backend liveness probe (_backend_alive) amortised a TPU backend dial
across processes; a CUDA probe costs milliseconds, so the port probes once
per process and device instead.

There is no host fallback: on CUDA an error raises.  The mesh (parallel/)
stages its shards with `stage` and plans them with `window_ceiling` and
`query_chunk_kmers`.  No pow2 padding either (good_sort_size exists for
the TPU sort).
"""

from __future__ import annotations

import collections
import concurrent.futures
import logging
import os
import stat
import threading
import time
from typing import Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core import native
from ..core.arrays import sorted_unique
from ..utils import trace
from . import count as count_ops
from . import deltas
from .pack import SINGLE_MAX_K

logger = logging.getLogger("kmerset")

# The kernels index windows and keys with int32 (the position lane of the
# compaction carries run-head positions as int32): the bound of one shot,
# and so of one chunk.
MAX_WINDOWS = (1 << 31) - 1

# Peak device bytes per window of one one-shot count (staging included),
# by key width: int32 keys for k <= 15, int64 above.  Measured on one
# H100 with torch.cuda.max_memory_allocated over count_kmers_frag at 2^24
# windows (PERF.md section 5), rounded up.
COUNT_BYTES_PER_WINDOW = {4: 48, 8: 72}
# Peak device bytes per queried k-mer of one side-table chunk of the
# graph front-end (ops/neighbors.side_tables), measured the same way.
FRONT_END_BYTES_PER_QUERY = 320
# Peak device bytes per k-mer of the front-end's whole-set arrays in its
# one-shot mode (ops/unitigs.unitig_succ): the set (8), both sides' deg,
# nbr and same (26), the oriented successor (16), the masks and the
# terminal tests' gathers; 71.12 measured on one H100 (chip_smoke.py
# phase 9, PERF.md), rounded up.
FRONT_END_BYTES_PER_KMER = 80
# The same in the bounded mode (ops/unitigs.bounded_unitig_succ), which
# keeps the set and the two sides' uint8 degrees (8 + 2) on the device
# and every other row on the host; 9.42 measured the same way.
BOUNDED_BYTES_PER_KMER = 10
# Peak device bytes per k-mer of the device walk's whole-set arrays: the
# set (8), the oriented successor (16) and the three masks (3), beside
# the bounded front-end's degrees while it builds them (27.28 measured),
# or beside kernel W1's own buffers while it walks them (ops/walk.py:
# 37.01 measured); on one H100 the same way (chip_smoke.py phase 9,
# PERF.md), rounded up.
WALK_BYTES_PER_KMER = 40
# The share of what the CUDA allocator can still obtain that one step may
# plan to use; the rest covers the arrays that outlive the step and
# fragmentation.
DEVICE_MEMORY_SHARE = 0.5
# Planning budget on the CPU, where a run shares the host's memory.
HOST_BUDGET = 2 << 30

# Fewest k-mers from which the canonical build on a CUDA device walks its
# chains and emits its strings there (kernel W1, ops/walk.py) instead of
# downloading the front-end's successor for the host walk.  W1 costs the
# longest chain's dependent loads, and below it, on sets of 10 kb records
# whose chains are the records, the host walk with the download took less
# time (65k k-mers: 0.67-0.75x; 131k: 0.93-1.48x; 262k: 1.3-2.5x; one
# H100, kmerset_tpu_torch/tools/time_walk.py, PERF.md section 6).
WALK_MIN_KMERS = 1 << 17

# Fewest unitigs from which the canonical path cover on a CUDA device
# finds its candidate overlap edges there (kernel J1, ops/overlap.py)
# instead of the host's hash join and dedup.  Below it the upload, the
# sorts, the launches and the two waits cost more than the host's probes
# (genomes as 10 kb records at k = 15, host over device: 458 unitigs
# 0.43x, 1,783 1.04x, 6,873 2.5x, 108,526 7.9x; one H100,
# kmerset_tpu_torch/tools/time_edges.py, PERF.md section 6).
EDGES_MIN_UNITIGS = 1 << 11
# Peak device bytes per unitig of J1 beside its output: P and S (16),
# their sorted copies and ids (32), the 12 probes' counts (96) and the
# sorts' scratch; 144.01 measured on one H100 at the assembly cell's
# shape (chip_smoke.py phase 4j, PERF.md section 6), rounded up.
EDGES_BYTES_PER_UNITIG = 192

# The device parse's FASTA read (upload_file): pieces of this many bytes,
# read by this many threads into a ring of this many pinned host buffers.
# With the uploads, P1 and its download, one thread took 358 ms over the
# dmel cell's 1.56 GB on the card's host, four 131 ms (PERF.md section 6).
# The staged download (copy_staged) takes the same pieces, ring and
# threads: 2 GiB of int64 came down at 7.1-10.7 GB/s into the pool's
# recycled pages and at 4.1 into fresh ones (faulted in on four threads),
# against 1.8-2.3 GB/s through t.cpu() into fresh pages and, through one
# copy_, 2.5 into fresh pages and 5.1-8.7 into recycled ones; the pinned
# DMA alone ran at 51.4-55.1 (one H100,
# kmerset_tpu_torch/tools/time_download.py, PERF.md section 6).
READ_PIECE_BYTES = 8 << 20
READ_THREADS = 4
READ_RING = 8
# Bytes from which download() brings a CUDA tensor down through the ring
# into an array of np.empty (copy_staged) instead of t.cpu(), whose
# destination above glibc's 32 MiB mmap ceiling is fresh pages faulted in
# inside the copy.
STAGED_MIN_BYTES = 32 << 20
# Peak device bytes per FASTA byte of the device parse (ops/parse.parse):
# the bytes (1), the codes (1) and the room for the fragment ends (8 B for
# at most every other byte).
PARSE_BYTES_PER_BYTE = 6

# Keys from which device_count downloads its keys gap-encoded on a slow
# link (reference backend.py:691).
DELTA_MIN_KEYS = 1 << 20
# A round trip below this rate makes a link slow (reference backend.py:186),
# measured over _PROBE_BYTES each way.
SLOW_LINK_BYTES_PER_S = 1 << 30
_PROBE_BYTES = 8 << 20

_locks: dict = {}
_locks_guard = threading.Lock()
# The probe's verdict per device (a torch.device key), and its lock.
_link_slow: dict = {}
_link_guard = threading.Lock()


def canonical_device(device) -> torch.device:
    """`device` as a torch.device with the index of a bare "cuda" filled
    in, so that two names of one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def device_lock(device) -> threading.Lock:
    """The lock that serializes device sections on `device`.  Deferred
    SPSS builds and decodes of the multi-set path run in thread pools; the
    device steps (count, decode, graph front-end) take this lock, so at
    most one of them runs on a device at a time and the kernels' launch
    counters see no concurrent increments.  The host work between them
    (chain walk, path cover, merges, file I/O) still runs in parallel.
    No device section calls another, so the lock is not reentrant."""
    dev = canonical_device(device)
    with _locks_guard:
        return _locks.setdefault(dev, threading.Lock())


def sync(dev: torch.device) -> None:
    """Waits for the work queued on `dev` (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _slow_link(device) -> bool:
    """Whether the link between the host and `device` is slow, so that the
    link formats pay (reference backend.py:141-200).  KMERSET_TPU_LINK=fast
    or slow decides, read at every call; otherwise the CPU is fast, and a
    CUDA device is slow when one round trip of _PROBE_BYTES (upload, an
    add, download) runs below SLOW_LINK_BYTES_PER_S, probed once per
    process and device."""
    env = os.environ.get("KMERSET_TPU_LINK", "")
    if env in ("fast", "slow"):
        return env == "slow"
    dev = canonical_device(device)
    if dev.type != "cuda":
        return False
    with _link_guard:
        if dev not in _link_slow:
            x = torch.zeros(_PROBE_BYTES // 4, dtype=torch.int32)
            (x.to(dev) + 1).cpu()  # first use of the device and the op
            sync(dev)
            t0 = time.perf_counter()
            (x.to(dev) + 1).cpu()
            rate = 2 * x.nbytes / max(time.perf_counter() - t0, 1e-9)
            _link_slow[dev] = rate < SLOW_LINK_BYTES_PER_S
            logger.debug("backend: link to %s %.3g B/s round trip: %s", dev,
                         rate, "slow" if _link_slow[dev] else "fast")
        return _link_slow[dev]


def side_code_route(n: int, device) -> bool:
    """Whether the canonical front-end of n k-mers on `device` downloads
    side codes (1 B per k-mer, ops/unitigs.device_unitig_sides) and
    rebuilds the successor on the host (core/native.succ_from_sides): on a
    slow link, with the native library loaded, up to the rebuild's
    native.MAX_SIDES_KMERS (reference core/spss.py:604)."""
    return (0 < n <= native.MAX_SIDES_KMERS and _slow_link(device)
            and host_library_loaded())


def walk_route(n: int, device) -> bool:
    """Whether the canonical build of n k-mers on `device` walks its
    chains on the device (kernel W1, ops/walk.py): on CUDA, from
    WALK_MIN_KMERS k-mers, with the native library loaded (W1 reproduces
    its walk's order, and its cycle walk finishes a set that has pure
    cycles), up to walk_ceiling of the device's memory budget, so that
    the front-end's arrays stay whole on the device for W1 in either of
    its modes (front_end_plan with keep)."""
    return (torch.device(device).type == "cuda" and n >= WALK_MIN_KMERS
            and host_library_loaded()
            and n <= walk_ceiling(memory_budget(device)))


def edges_route(n: int, device) -> bool:
    """Whether the canonical path cover of n unitigs on `device` finds its
    candidate overlap edges on the device (kernel J1, ops/overlap.py): on
    CUDA, from EDGES_MIN_UNITIGS unitigs, with the native library loaded
    (its first and last k-mers are packed on the host, as the host join
    takes them), up to edges_ceiling of the device's memory budget."""
    return (torch.device(device).type == "cuda" and n >= EDGES_MIN_UNITIGS
            and host_library_loaded()
            and n <= edges_ceiling(memory_budget(device)))


def memory_budget(device) -> int:
    """Bytes one device step may plan to use on `device`: on CUDA,
    DEVICE_MEMORY_SHARE of the card's free memory plus the blocks the
    caching allocator holds free; on the CPU, HOST_BUDGET."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return HOST_BUDGET
    free, _ = torch.cuda.mem_get_info(dev)
    cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    return int((free + cached) * DEVICE_MEMORY_SHARE)


def count_bytes_per_window(k: int) -> int:
    return COUNT_BYTES_PER_WINDOW[4 if k <= SINGLE_MAX_K else 8]


def window_ceiling(k: int, budget: int) -> int:
    """The most windows one count (or decode) at k takes in one shot
    within `budget` bytes, and at most MAX_WINDOWS; at least 1."""
    return max(1, min(MAX_WINDOWS, budget // count_bytes_per_window(k)))


def query_chunk_kmers(budget: int) -> int:
    """The most k-mers one side-table chunk of the front-end queries
    within `budget` bytes; at least 1."""
    return max(1, budget // FRONT_END_BYTES_PER_QUERY)


def front_end_ceiling(budget: int) -> int:
    """The most k-mers the front-end's one-shot mode takes within `budget`
    bytes: its whole-set arrays take at most half of it, so that a query
    chunk of at least a quarter of the set fits beside them; at least 1.
    A larger set takes the bounded mode."""
    return max(1, budget // (2 * FRONT_END_BYTES_PER_KMER))


def walk_ceiling(budget: int) -> int:
    """The most k-mers the device walk takes within `budget` bytes: the
    arrays it keeps whole (WALK_BYTES_PER_KMER) take at most half of it,
    as the front-end's one-shot arrays do, so that the bounded
    front-end's query chunk fits beside them; at least 1."""
    return max(1, budget // (2 * WALK_BYTES_PER_KMER))


def edges_ceiling(budget: int) -> int:
    """The most unitigs kernel J1 takes within `budget` bytes: its arrays
    (EDGES_BYTES_PER_UNITIG) take at most half of it, so that the kept
    edges fit beside them, and fewer than 2^30, so that a port fits
    int32; at least 1."""
    return max(1, min((1 << 30) - 1, budget // (2 * EDGES_BYTES_PER_UNITIG)))


def front_end_plan(n: int, budget: int, keep: bool = False) -> Tuple[bool, int]:
    """(bounded, query_chunk) of the front-end on n k-mers within
    `budget` bytes, its whole-set arrays and one query chunk together:
    the mode by front_end_ceiling, and a query chunk of what the mode's
    whole-set arrays leave of the budget, at most n and at least 1.  With
    `keep` (the device walk's plan) the bounded mode keeps its rows on
    the device too: WALK_BYTES_PER_KMER per k-mer in place of
    BOUNDED_BYTES_PER_KMER."""
    bounded = n > front_end_ceiling(budget)
    if not bounded:
        held = FRONT_END_BYTES_PER_KMER * n
    else:
        held = (WALK_BYTES_PER_KMER if keep else BOUNDED_BYTES_PER_KMER) * n
    return bounded, max(1, min(n, query_chunk_kmers(budget - held)))


class Staged(NamedTuple):
    packed: torch.Tensor  # (ceil(L/4),) uint8, kmerio_pack2 layout
    bounds: torch.Tensor  # (n_fragments,) int32 fragment ends (offsets[1:])
    total: int  # number of codes
    L: int  # codes in `packed` (== total: no padding)


def upload(what: str, array, device, dtype=None, out=None) -> torch.Tensor:
    """The host array (numpy or a CPU tensor) on `device`, in `dtype` if
    given: every host-to-device copy of the main path goes through here,
    a span "copy.h2d" with its `what` and bytes, counted in h2d_bytes and
    h2d_copies (on the CPU device too, where no copy crosses a link).
    With `out` (a tensor on `device` of the array's size) the copy goes
    there, queued without a wait (a pinned source copies while the host
    runs on: the span then times the queueing), and `out` is returned."""
    t = torch.from_numpy(array) if isinstance(array, np.ndarray) else array
    nbytes = t.numel() * t.element_size()
    with trace.span("copy.h2d", what=what, bytes=nbytes):
        trace.add("h2d_bytes", nbytes)
        trace.add("h2d_copies")
        if out is not None:
            return out.copy_(t, non_blocking=True)
        return t.to(device, dtype)


def upload_file(file_name: str, device) -> torch.Tensor:
    """The bytes of the file `file_name` on `device` (uint8): read in
    pieces of READ_PIECE_BYTES by READ_THREADS threads (os.preadv) into a
    ring of READ_RING host buffers (pinned on CUDA), each piece's upload
    queued through `upload`, in order, as soon as it is read, so that the
    link overlaps the reads; a buffer is read into again once its last
    upload is done.  Raises OSError where the file cannot be read whole."""
    dev = canonical_device(device)
    cuda = dev.type == "cuda"
    with open(file_name, "rb") as f, \
            concurrent.futures.ThreadPoolExecutor(READ_THREADS) as pool:
        fd = f.fileno()
        size = os.fstat(fd).st_size
        out = torch.empty(size, dtype=torch.uint8, device=dev)
        piece = max(1, min(READ_PIECE_BYTES, size))
        starts = range(0, size, piece)
        ring = [torch.empty(piece, dtype=torch.uint8, pin_memory=cuda)
                for _ in range(min(READ_RING, len(starts)))]
        done = [None] * len(ring)

        def read(buf: torch.Tensor, at: int) -> None:
            view, got = memoryview(buf.numpy()), 0
            while got < len(view):
                n = os.preadv(fd, [view[got:]], at + got)
                if not n:
                    raise OSError(f"{file_name}: read {at + got} of {size} bytes")
                got += n

        def queue(slot: int, at: int, buf: torch.Tensor, reading) -> None:
            reading.result()
            upload("fasta bytes", buf, dev, out=out[at : at + buf.shape[0]])
            if cuda:
                done[slot] = torch.cuda.Event()
                done[slot].record(torch.cuda.current_stream(dev))

        pending = collections.deque()
        for i, at in enumerate(starts):
            if len(pending) == len(ring):
                queue(*pending.popleft())
            slot = i % len(ring)
            if done[slot] is not None:
                done[slot].synchronize()
            buf = ring[slot][: min(piece, size - at)]
            pending.append((slot, at, buf, pool.submit(read, buf, at)))
        while pending:
            queue(*pending.popleft())
        if os.pread(fd, 1, size):
            raise OSError(f"{file_name}: grew past {size} bytes while read")
    return out


def parse_route(file_name: str, decompressor: str, device, mesh) -> bool:
    """Whether a count's FASTA parse runs on `device` (kernel P1,
    ops/parse.py, on the bytes of upload_file): on CUDA with no mesh, for
    a regular file read as it is (no decompressor) whose parse fits the
    memory budget (PARSE_BYTES_PER_BYTE).  Else the host parses it, and
    raises its own errors."""
    if mesh is not None or decompressor or resolve_device(device).type != "cuda":
        return False
    try:
        st = os.stat(file_name)
    except OSError:
        return False
    return (stat.S_ISREG(st.st_mode)
            and st.st_size * PARSE_BYTES_PER_BYTE <= memory_budget(device))


def staged_route(t: torch.Tensor) -> bool:
    """Whether download() copies `t` through the pinned ring (copy_staged):
    a contiguous CUDA tensor of at least STAGED_MIN_BYTES.  Scalars, small
    tensors, views that are not contiguous and the CPU device take
    t.cpu()."""
    return (t.device.type == "cuda" and t.is_contiguous()
            and t.numel() * t.element_size() >= STAGED_MIN_BYTES)


def copy_staged(src: torch.Tensor, out: np.ndarray,
                piece: int = READ_PIECE_BYTES, ring: int = READ_RING,
                threads: int = READ_THREADS) -> np.ndarray:
    """Copies the bytes of the contiguous tensor `src` into `out`, a
    C-contiguous array of as many bytes, through `ring` host buffers of
    `piece` bytes (pinned for a CUDA tensor), and returns `out`.  Each piece's
    copy into a free buffer is queued on src's stream (an event marks its
    end on CUDA); one of `threads` threads waits for it and copies the
    buffer into `out` (np.copyto, without the GIL, so that out's pages
    fault in on several threads); a buffer takes its next piece once its
    host copy is done, so that one piece's DMA overlaps the host copies of
    those before it.  Takes no device memory."""
    src_bytes = src.reshape(-1).view(torch.uint8)
    dst = out.reshape(-1).view(np.uint8)
    n = dst.shape[0]
    if n != src_bytes.shape[0]:
        raise ValueError(f"copy_staged: {src_bytes.shape[0]} bytes into {n}")
    if not n:
        return out
    piece = min(piece, n)
    starts = range(0, n, piece)
    slots = [torch.empty(piece, dtype=torch.uint8, pin_memory=src.is_cuda)
             for _ in range(min(ring, len(starts)))]
    stream = torch.cuda.current_stream(src.device) if src.is_cuda else None

    def drain(done, buf: torch.Tensor, lo: int) -> None:
        if done is not None:
            done.synchronize()
        np.copyto(dst[lo : lo + buf.shape[0]], buf.numpy())

    with concurrent.futures.ThreadPoolExecutor(threads) as pool:
        busy = [None] * len(slots)
        for i, lo in enumerate(starts):
            slot = i % len(slots)
            if busy[slot] is not None:
                busy[slot].result()
            buf = slots[slot][: min(piece, n - lo)]
            buf.copy_(src_bytes[lo : lo + buf.shape[0]], non_blocking=True)
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
            busy[slot] = pool.submit(drain, done, buf, lo)
        for f in busy:
            f.result()
    return out


def download(what: str, t: torch.Tensor, logged: bool = False) -> np.ndarray:
    """The tensor on the host as numpy, after the work queued on its
    device: every device-to-host copy of the main path goes through here,
    scalar reads too (int(download(...))), a span "copy.d2h" with its
    `what` and bytes, counted in d2h_bytes and d2h_copies (on the CPU
    device too, where no copy crosses a link).  A tensor on the staged
    route (staged_route) comes down through the pinned ring into an array
    of np.empty (copy_staged: the pooling allocator's recycled pages where
    it holds a block of the size, else fresh ones, faulted in on the
    ring's threads), counted in d2h.staged; any other as
    t.cpu().numpy().  With `logged`, the count's line "count: WHAT
    download N B in S s" states its bytes and seconds at debug level
    (timed from when the work queued before it is done)."""
    sync(t.device)
    nbytes = t.numel() * t.element_size()
    with trace.timed("copy.d2h", what=what, bytes=nbytes) as s:
        trace.add("d2h_bytes", nbytes)
        trace.add("d2h_copies")
        if staged_route(t):
            trace.add("d2h.staged")
            dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            out = copy_staged(t, np.empty(tuple(t.shape), dtype))
        else:
            out = t.cpu().numpy()
    if logged:
        logger.debug("count: %s download %d B in %.4f s", what, out.nbytes,
                     s.seconds)
    return out


def stage(
    codes, offsets, k: int, device, what: str = "count"
) -> Optional[Staged]:
    """Packs the codes 2 bits each and puts them and the int32 fragment
    bounds on `device`: the span "<what>.stage".  Host arrays (numpy) are
    packed on the host (native.pack2) and uploaded; a stream the device
    parse left there (tensors: ops/parse.parse, or a chunk of it) is
    packed on its device by P1's pack pass (ops/parse.pack), waited for,
    so that the span times it.  Returns None for inputs that hold no
    window."""
    total = int(codes.shape[0])
    if total < k:
        return None
    if total - (k - 1) > MAX_WINDOWS:
        raise ValueError(
            f"{total - (k - 1)} windows exceed the int32 position lane of "
            f"the port's kernels ({MAX_WINDOWS}) in one shot; count in "
            "chunks (device_count_chunked)"
        )
    with trace.span(f"{what}.stage", codes=total):
        if isinstance(codes, torch.Tensor):
            from . import parse  # parse imports this module

            packed = parse.pack(codes)
            sync(packed.device)
            return Staged(packed, offsets[1:].to(torch.int32), total, total)
        packed = native.pack2(np.ascontiguousarray(codes, dtype=np.uint8))
        bounds = np.asarray(offsets, dtype=np.int64)[1:].astype(np.int32)
        return Staged(
            upload("packed codes", packed, device),
            upload("fragment bounds", bounds, device),
            total,
            total,
        )


def host_library_loaded() -> bool:
    """Whether a native host library (native/kmerio.c: the checkout's
    native/libkmerio.so or the port's serial edition, core/native.edition)
    is loaded.  Without one the FASTA parse, the 2-bit pack and the SPSS
    build run on their numpy fallbacks."""
    return native.get_lib() is not None


def _counts_fetch(counts, value_max: int) -> np.ndarray:
    """The counts on the host.  With value_max > 0 they are saturated on
    the device and, up to 255, downloaded as uint8 (reference
    backend.py:776-789)."""
    if value_max:
        counts = torch.clamp(counts, max=value_max)
        if value_max <= 255:
            return download("counts", counts.to(torch.uint8), logged=True)
    return download("counts", counts, logged=True).astype(np.int64)


def count_plan(what: str, n_windows: int, k: int, device) -> int:
    """The chunk size of a count or decode (`what`) of n_windows windows
    at k on `device`: all of them in one shot up to the one-shot ceiling
    of the budget read now, else halo chunks of the ceiling.  Logs "W
    windows in C chunk(s) of at most X (ceiling Y, budget B)" at debug
    level, and the span "<what>.plan" holds the same numbers (windows,
    chunks, chunk, ceiling, budget).  The caller runs one shot where the
    size is n_windows, else the chunked path with chunk_windows set to
    it."""
    with trace.span(f"{what}.plan") as sp:
        budget = memory_budget(device)
        ceiling = window_ceiling(k, budget)
        chunk = n_windows if n_windows <= ceiling else ceiling
        chunks = -(-n_windows // max(1, chunk))
        sp.set(windows=n_windows, chunks=chunks, chunk=chunk, ceiling=ceiling,
               budget=budget)
    logger.debug("%s: %d windows in %d chunk(s) of at most %d (ceiling %d, "
                 "budget %d)", what, n_windows, chunks, chunk, ceiling, budget)
    return chunk


def device_count(
    codes, offsets, k: int, canonical: bool, *,
    device, value_max: int = 0, resident: bool = False,
) -> Tuple:
    """Sorted distinct (canonical) k-mers of the fragment stream and their
    counts, counted on `device` in one shot: (keys int64, counts), and
    with resident=True a third element, the set kept on the device
    (ops/resident.DeviceKmers, None for an empty set), its endpoints
    stamped from the downloaded keys.

    The reference's order (backend.py:694-820): on a slow link
    (_slow_link) and from DELTA_MIN_KEYS keys on, the gap encode of the
    keys is launched first (ops/deltas.py); then the handle is made from
    the count's device outputs; then the keys are downloaded (gap-encoded
    where the format takes them, else in their device dtype: int32 for
    k <= 15, int64 above), then the counts; last the handle's endpoints
    are stamped.
    The span "count.stage" covers the pack (and the upload of host
    arrays: `stage` takes either form), "count.device" the launches to
    the counts' fetch."""
    with device_lock(device):
        staged = stage(codes, offsets, k, device)
        if staged is None:
            empty = np.empty(0, np.int64), np.empty(0, np.int64)
            return (*empty, None) if resident else empty
        with trace.span("count.device") as sp:
            keys, counts, n = count_ops.count_kmers_frag(*staged, k, canonical)
            sp.set(kmers=n)
            pending = None
            # The size first: a small count never probes the link.
            if n >= DELTA_MIN_KEYS and _slow_link(device):
                pending = deltas.dispatch_delta(keys, n, k, canonical)
            handle = None
            if resident:
                from .resident import DeviceKmers  # resident imports this module

                handle = DeviceKmers.from_count_outputs(keys, counts, n, k,
                                                        canonical)
            uniq = (deltas.fetch_delta(pending, n) if pending is not None
                    else None)
            if uniq is None:
                uniq = download("keys", keys, logged=True).astype(np.int64,
                                                              copy=False)
            counts_h = _counts_fetch(counts, value_max)
        if handle is not None:
            handle.with_endpoints(uniq)
        return (uniq, counts_h, handle) if resident else (uniq, counts_h)


def device_unique(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool, *, device
) -> np.ndarray:
    """Sorted distinct (canonical) k-mers of the fragment stream: the
    decode direction, the counting pipeline at cutoff 1 without counts."""
    with device_lock(device):
        staged = stage(codes, offsets, k, device, "decode")
        if staged is None:
            return np.empty(0, np.int64)
        with trace.span("decode.device"):
            keys, _, _ = count_ops.count_to_set_frag(*staged, k, canonical, 1)
            return download("keys", keys).astype(np.int64, copy=False)


def chunk_slices(
    codes: np.ndarray, offsets: np.ndarray, k: int, chunk_windows: int
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yields (codes_slice, offsets_slice) per chunk of `chunk_windows`
    windows, each with its k-1 code halo, so that the windows starting in
    [lo, hi) see their true fragment cover and per-chunk validity equals
    the global validity (reference _chunk_slices, backend.py:574-592, with
    the chunk size as a parameter)."""
    if chunk_windows < 1:
        raise ValueError(f"chunk_windows must be >= 1, got {chunk_windows}")
    n_windows = codes.shape[0] - (k - 1)
    lo = 0
    while lo < n_windows:
        hi = min(lo + chunk_windows, n_windows)
        hi_code = hi + k - 1
        a = np.searchsorted(offsets, lo, side="right")
        b = np.searchsorted(offsets, hi_code, side="left")
        offs_c = np.unique(
            np.concatenate([[0], offsets[a:b] - lo, [hi_code - lo]])
        )
        yield codes[lo:hi_code], offs_c
        lo = hi


def device_chunk_slices(
    codes: torch.Tensor, offsets: torch.Tensor, k: int, chunk_windows: int
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """chunk_slices of a stream on the device (ops/parse.parse's codes
    and offsets): the same chunks, halos and offsets, as views and
    tensors on its device.  Every chunk's fragment offsets are searched
    on the device at once, and their indices come down in one download.
    chunk_slices' np.unique changes nothing there: offsets rise strictly
    (each fragment holds a code), so those inside a chunk lie strictly
    between its 0 and its end."""
    if chunk_windows < 1:
        raise ValueError(f"chunk_windows must be >= 1, got {chunk_windows}")
    n_windows = codes.shape[0] - (k - 1)
    if n_windows <= 0:
        return
    los = np.arange(0, n_windows, chunk_windows, dtype=np.int64)
    his = np.minimum(los + chunk_windows, n_windows) + (k - 1)
    cuts = upload("chunk bounds", np.concatenate([los, his]), offsets.device)
    a = torch.searchsorted(offsets, cuts[: los.shape[0]], right=True)
    b = torch.searchsorted(offsets, cuts[los.shape[0]:])
    ab = download("chunk fragment bounds", torch.stack([a, b]))
    for lo, hi_code, i, j in zip(los.tolist(), his.tolist(), *ab.tolist()):
        yield codes[lo:hi_code], torch.cat([
            offsets.new_zeros(1), offsets[i:j] - lo,
            offsets.new_full((1,), hi_code - lo)])


def _chunks(codes, offsets, k: int, device, chunk_windows: Optional[int]):
    if chunk_windows is None:
        chunk_windows = window_ceiling(k, memory_budget(device))
    slices = (device_chunk_slices if isinstance(codes, torch.Tensor)
              else chunk_slices)
    return slices(codes, offsets, k, min(chunk_windows, MAX_WINDOWS))


def device_count_chunked(
    codes, offsets, k: int, canonical: bool, *,
    device, chunk_windows: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Out-of-core count on one device: every halo chunk of at most
    `chunk_windows` windows (default: the device's one-shot ceiling)
    through the one-shot count, and the sorted (keys, raw int64 counts)
    runs merged on the host.  Counts stay raw: the caller saturates them
    after the merge, or cross-chunk sums would saturate early
    (reference backend.py:705-710).  chunk_windows: by default the
    one-shot ceiling of the budget now (count_plan's chunk size).  The
    span "count.chunked" (chunks) holds the chunks' counts."""
    if codes.shape[0] - (k - 1) <= 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    with trace.span("count.chunked") as sp:
        parts = [
            device_count(c, o, k, canonical, device=device)
            for c, o in _chunks(codes, offsets, k, device, chunk_windows)
        ]
        sp.set(chunks=len(parts))
    return _merge_logged("count", parts, _merge_count_pair)


def _merge_count_pair(ak, ac, bk, bc):
    """One merge of two sorted-unique (keys, counts) runs, summing counts
    of shared keys (native one-pass merge; numpy stable-sort fallback):
    the reference's, backend.py:522-540."""
    m = native.merge_counts(ak, ac, bk, bc)
    if m is None:
        keys = np.concatenate([ak, bk])
        cnts = np.concatenate([ac, bc])
        if keys.size == 0:
            return keys, cnts
        order = np.argsort(keys, kind="stable")
        keys, cnts = keys[order], cnts[order]
        boundary = np.empty(keys.shape[0], dtype=bool)
        boundary[0] = True
        np.not_equal(keys[1:], keys[:-1], out=boundary[1:])
        idx = np.flatnonzero(boundary)
        m = keys[idx], np.add.reduceat(cnts, idx)
    return m


def _merge_cascade(parts: list, merge_pair):
    """Balanced pairwise merge of sorted runs down to one (the
    reference's, backend.py:554-567)."""
    while len(parts) > 1:
        nxt = []
        for i in range(0, len(parts) - 1, 2):
            a, b = parts[i], parts[i + 1]
            if isinstance(a, tuple):
                nxt.append(merge_pair(a[0], a[1], b[0], b[1]))
            else:
                nxt.append(merge_pair(a, b))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def _merge_logged(what: str, parts: list, merge_pair):
    """_merge_cascade of the chunks' runs (the span "<what>.merge": the
    chunks, keys_in summed over the runs and keys_out merged), its
    seconds and the merged key count logged at debug level."""
    keys_in = sum(_n_keys(p) for p in parts)
    with trace.timed(f"{what}.merge", chunks=len(parts), keys_in=keys_in) as s:
        out = _merge_cascade(parts, merge_pair)
        s.set(keys_out=_n_keys(out))
    logger.debug("%s: merged %d chunk(s) on the host in %.4f s (%d keys)",
                 what, len(parts), s.seconds, _n_keys(out))
    return out


def _n_keys(run) -> int:
    """The keys of a (keys, counts) or keys-only sorted run."""
    return int((run[0] if isinstance(run, tuple) else run).shape[0])


def _merge_key_pair(ak: np.ndarray, bk: np.ndarray) -> np.ndarray:
    """Sorted union of two sorted-unique key runs: the native one-pass
    merge, else the reference's sorted_unique of the concatenation.  The
    reference's own fallback here (np.union1d, backend.py:543-551) goes
    through np.unique: with it, the chunked decode of a 16.8M-window dump
    in 5 chunks took 82.1 s on the host of an H100 machine, and 1.7 s with
    sorted_unique (PERF.md)."""
    m = native.merge_keys(ak, bk)
    return m if m is not None else sorted_unique(np.concatenate([ak, bk]))


def device_unique_chunked(
    codes: np.ndarray, offsets: np.ndarray, k: int, canonical: bool, *,
    device, chunk_windows: Optional[int] = None,
) -> np.ndarray:
    """Out-of-core decode on one device: halo chunks through the cutoff-1
    pipeline, combined by keys-only sorted-union merges."""
    if codes.shape[0] - (k - 1) <= 0:
        return np.empty(0, np.int64)
    parts = [
        device_unique(c, o, k, canonical, device=device)
        for c, o in _chunks(codes, offsets, k, device, chunk_windows)
    ]
    return _merge_logged("decode", parts, _merge_key_pair)
