"""ctypes bindings for the native kmerio data loader (native/kmerio.c).

Falls back silently to the NumPy paths when the shared library has not
been built (`make -C native`); every caller treats this module as an
optional accelerator, never a requirement.

The port's copy of kmerset_tpu/core/native.py: the loader (:17-84),
set_threads (:87-100), the FASTA parse and 2-bit pack (:103-166), the
chain walks (:169-308), the greedy matching (:311-341), revcomp and
window_pack (:344-391), the k-mer chain emission (:394-437), the
directed side tables (:448-621), seq_match and walk_cycles (:624-701),
the edge dedup, count_hash and the overlap join (:755-785, 893-978,
981-1158), sorted_algebra, intersect_size and the merges (:1161-1284),
gather_ranges, pack_rows, emit_string_chains and cycle_leaders
(:1287-1319, 1362-1465), and the two host halves of the link formats:
succ_from_sides (:788-890), the successor rebuilt from the device's side
codes, with its routing to the partitioned edition, and delta_decode
(:1468-1516), the decoder of ops/deltas.py's key format.  Left out by
design: canonical_windows32, side_tables and unitig_succ_from_tables
(:704-752, 448-621 canonical, 1322-1359), the host count and canonical
graph paths, which the port runs on its torch device.

Every binding is declared once, when the library loads (_SIGNATURES).
The reference also binds each function at its first use and keeps
older editions for a library built from an older kmerio.c (the hash and
merge side tables, the capacity-only overlap join, the two-pass kept
walk, the numpy sort after the partitioned join).  Both packages load
the same library, native/libkmerio.so at the root of the checkout, built
from that checkout's kmerio.c on first use (the port's copy of the build
step, kmerset_tpu_torch/_nativebuild.py), so here a library that lacks
any of the functions counts as absent.  When that library is missing,
does not load or fails the ABI check, the port loads its serial edition
of the same source (_nativebuild.build_serial: no OpenMP, so --workers
does nothing); edition() says which one is loaded.  Only when neither
loads does every caller take its numpy path.
Also left out: the partitioned side-table edition, which serves
canonical sets only (the port builds those on its device), and the
KMERSET_TPU_NO_PART switch of the partitioned overlap join and succ
rebuild (their output is bit-identical to the fp edition's either way).

The port's own: lines_encode and lines_decode, the dump's text codec
behind PackedStrings.to_lines_bytes and from_lines_bytes, which the
reference runs in numpy.  They live in a library of their own
(kmerset_tpu_torch/csrc/lines.c, compiled on first use by
_nativebuild.build_lines and loaded by get_lines_lib), so that
libkmerio's source and ABI stay the ones the reference loads; where it
cannot be built, they return None and the callers take numpy.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import NamedTuple, Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


class Edition(NamedTuple):
    """The loaded library: its path, whether it is the port's serial
    edition, and the seconds this process spent compiling it (None when
    it found it built)."""

    path: str
    serial: bool
    build_s: Optional[float]


_EDITION: Optional[Edition] = None

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_long, _int = ctypes.c_long, ctypes.c_int

# name: (restype, argtypes), as native/kmerio.c declares them.
_SIGNATURES = {
    "kmerio_abi_version": (_long, []),
    "kmerio_set_threads": (None, [_int]),
    "kmerio_parse_fasta": (_long, [ctypes.c_char_p, _long, _u8p, _i64p]),
    "kmerio_pack2": (None, [_u8p, _long, _u8p]),
    "kmerio_unpack2": (None, [_u8p, _long, _u8p]),
    "kmerio_chain_walk": (_long, [_i64p, _long, _i64p, _long, _i64p, _i64p, _u8p]),
    "kmerio_chain_pairs": (
        _long, [_i64p, _long, _i64p, _long, _u8p, _i64p, _i64p, _i64p]
    ),
    "kmerio_chain_emit": (_long, [_i64p, _long, _i64p, _long, _i64p, _i64p, _i64p]),
    "kmerio_greedy_match": (None, [_i64p, _i64p, _long, _i64p]),
    "kmerio_revcomp": (None, [_i64p, _long, _int, _i64p]),
    "kmerio_window_pack": (None, [_u8p, _long, _int, _i64p]),
    "kmerio_emit_kmer_chains": (
        None, [_i64p, _int, _i64p, _i64p, _long, _int, _i64p, _u8p]
    ),
    "kmerio_side_tables_fp": (
        _long,
        [_i64p, _long, _int, _int, _u64p, _int,
         _i32p, _i32p, _u8p, _i32p, _i32p, _u8p],
    ),
    "kmerio_seq_match": (_long, [_i64p, _i64p, _long, _long, _i64p]),
    "kmerio_walk_cycles": (
        _long, [_i64p, _i64p, _long, _int, _int, _u8p, _u8p, _i64p]
    ),
    "kmerio_dedup_edges": (_long, [_i64p, _i64p, _long, _u64p, _int, _i64p]),
    "kmerio_count_hash": (_long, [_u8p, _long, _int, _u64p, _int]),
    "kmerio_overlap_part_scratch": (_long, [_long, _int]),
    "kmerio_overlap_edges_part": (
        _long,
        [_i64p, _i64p, _long, _int, _u64p, _u64p, _int, _u8p, ctypes.c_int64,
         _long, _i64p],
    ),
    "kmerio_overlap_sort_unpack": (None, [_u64p, _long, _u64p, _i64p, _i64p]),
    "kmerio_overlap_edges_fp": (
        _long, [_i64p, _i64p, _long, _int, _u64p, _u64p, _int, _long, _i64p]
    ),
    "kmerio_overlap_edges": (
        _long, [_i64p, _i64p, _long, _int, _i64p, _i64p, _int, _int, _i64p]
    ),
    "kmerio_sorted_algebra": (
        None,
        [_i64p, _long, _i64p, _long, _i64p, _i64p, _i64p,
         ctypes.POINTER(ctypes.c_long)],
    ),
    "kmerio_merge_counts": (
        _long, [_i64p, _i64p, _long, _i64p, _i64p, _long, _i64p, _i64p]
    ),
    "kmerio_gather_ranges_u8": (None, [_u8p, _i64p, _i64p, _long, _u8p]),
    "kmerio_gather_ranges_i64": (None, [_i64p, _i64p, _i64p, _long, _i64p]),
    "kmerio_pack_rows": (None, [_u8p, _i64p, _long, _int, _int, _i64p]),
    "kmerio_emit_string_chains": (
        None, [_u8p, _i64p, _int, _i64p, _i64p, _long, _int, _i64p, _u8p]
    ),
    "kmerio_cycle_leaders": (_long, [_i64p, _long, _int, _i64p]),
    "kmerio_succ_from_sides": (_long, [_i64p, _long, _int, _u8p, _u64p, _int, _i64p]),
    "kmerio_succ_part_scratch": (_long, [_long, _int]),
    "kmerio_succ_from_sides_part": (
        _long,
        [_i64p, _long, _int, _u8p, _u64p, _int, _u8p, ctypes.c_int64, _i64p],
    ),
    "kmerio_delta_decode": (
        _long, [ctypes.c_void_p, _int, _long, _i64p, _long, _i64p]
    ),
}


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(here, "native", "libkmerio.so"),
        os.path.join(os.path.dirname(__file__), "libkmerio.so"),
    ):
        if os.path.exists(cand):
            return cand
    return None


_GET_LIB_LOCK = threading.Lock()


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _GET_LIB_LOCK:
        return _get_lib_locked()


def edition() -> Optional[Edition]:
    """Which library get_lib() loaded, or None when none loaded."""
    get_lib()
    return _EDITION


def _load(path: Optional[str]) -> Optional[ctypes.CDLL]:
    """The library at `path` with every binding declared, or None when
    it does not load or fails the ABI check."""
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        # Stale-build guard: symbol presence cannot see signature changes
        # (e.g. the side-table editions' void -> long status return), so
        # any ABI mismatch disables the lib entirely — rebuild with
        # `make -C native`.
        if lib.kmerio_abi_version() == 3:
            return lib
    except (OSError, AttributeError):  # not a library, or a stale build
        pass
    return None


def _get_lib_locked() -> Optional[ctypes.CDLL]:
    """First-use load/build under _GET_LIB_LOCK: without it, a thread
    arriving during another's in-flight `make` (up to 300 s on a fresh
    checkout) would see _TRIED=True with _LIB still None and silently
    run a whole phase on the 10-50x slower numpy fallback."""
    global _LIB, _TRIED, _EDITION
    if _TRIED:  # the thread that held the lock finished the load
        return _LIB
    _TRIED = True
    # Fresh/stale checkouts: build the library on first use rather than
    # silently running the (complete but slower) fallback paths.
    from .._nativebuild import build_serial, ensure_built

    ensure_built("libkmerio.so", ["kmerio.c"])
    path = _find_lib()
    _LIB = _load(path)
    if _LIB is not None:
        _EDITION = Edition(path, False, None)
        return _LIB
    path, secs = build_serial()
    _LIB = _load(path)
    _EDITION = Edition(path, True, secs) if _LIB is not None else None
    return _LIB


_LINES: Optional[ctypes.CDLL] = None
_LINES_TRIED = False
# name: (restype, argtypes), as csrc/lines.c declares them.
_LINES_SIGNATURES = {
    "kmerset_lines_encode": (_long, [_u8p, _i64p, _long, _u8p]),
    "kmerset_lines_decode": (_long, [_u8p, _long, _u8p, _i64p]),
}


def get_lines_lib() -> Optional[ctypes.CDLL]:
    """The text codec's library (csrc/lines.c), compiled on first use;
    None where it cannot be built or loaded."""
    global _LINES, _LINES_TRIED
    if _LINES_TRIED:
        return _LINES
    with _GET_LIB_LOCK:
        if not _LINES_TRIED:
            from .._nativebuild import build_lines

            path, _ = build_lines()
            lib = None
            try:
                if path is not None:
                    lib = ctypes.CDLL(path)
                    for name, (restype, argtypes) in _LINES_SIGNATURES.items():
                        fn = getattr(lib, name)
                        fn.restype, fn.argtypes = restype, argtypes
            except (OSError, AttributeError):  # not a library, or stale
                lib = None
            _LINES, _LINES_TRIED = lib, True
    return _LINES


def set_threads(n: int) -> bool:
    """Sizes the native OpenMP pool from the CLI --workers flag
    (reference thread-pool sizing, lib/flags.h:25-53; default 1 keeps the
    reference's single-threaded default); a no-op in the serial edition,
    which has no pool.  Returns False when the native library is
    unavailable (the NumPy fallbacks are single-threaded anyway)."""
    lib = get_lib()
    if lib is None:
        return False
    lib.kmerio_set_threads(int(n))
    return True


def parse_fasta_bytes(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One native pass: FASTA text -> (codes, fragment offsets).

    Returns None if the native library is unavailable; raises ValueError on
    malformed FASTA (same conditions as the reference,
    lib/core/kmer_counter.h:161-209)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(data)
    codes = np.empty(max(n, 1), dtype=np.uint8)
    offsets = np.zeros(n + 2, dtype=np.int64)
    rc = lib.kmerio_parse_fasta(
        data, n, codes.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p)
    )
    if rc == -1:
        raise ValueError("FASTA files should have an even number of lines")
    if rc in (-2, -3):
        raise ValueError("invalid FASTA file")
    n_frag = int(rc)
    n_codes = int(offsets[n_frag]) if n_frag else 0
    return codes[:n_codes].copy(), offsets[: n_frag + 1].copy()


def pack2(codes: np.ndarray) -> np.ndarray:
    """2-bit pack (4 bases/byte); numpy fallback when no native lib."""
    lib = get_lib()
    # Coerce like every other wrapper: the C kernel reads raw uint8
    # bytes, so a strided or wider-dtype caller array would silently
    # pack garbage.
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    out = np.zeros((n + 3) // 4, dtype=np.uint8)
    if lib is not None and n:
        lib.kmerio_pack2(codes.ctypes.data_as(_u8p), n, out.ctypes.data_as(_u8p))
        return out
    for sh in range(4):
        part = codes[sh::4]
        out[: part.shape[0]] |= part << (sh * 2)
    return out


def unpack2(packed: np.ndarray, n: int) -> np.ndarray:
    lib = get_lib()
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    if lib is not None and n:
        lib.kmerio_unpack2(packed.ctypes.data_as(_u8p), n, out.ctypes.data_as(_u8p))
        return out
    for sh in range(4):
        vals = (packed >> (sh * 2)) & 3
        out[sh::4] = vals[: out[sh::4].shape[0]]
    return out


def lines_encode(codes: np.ndarray, offsets: np.ndarray) -> Optional[bytearray]:
    """The dump text of PackedStrings (codes, offsets): each string's
    bases and a newline, written in one native pass into the bytearray
    it returns; None without the codec's library."""
    lib = get_lines_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = offsets.shape[0] - 1
    if n <= 0:
        return bytearray()
    lo, hi = int(offsets[0]), int(offsets[-1])
    if lo < 0 or hi > codes.shape[0]:
        raise ValueError("offsets must lie within the codes")
    out = bytearray(max(hi - lo, 0) + n)
    # The C pass checks that the offsets do not decrease before it writes.
    rc = lib.kmerset_lines_encode(
        codes.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p), n,
        np.frombuffer(out, dtype=np.uint8).ctypes.data_as(_u8p),
    )
    if rc < 0:
        raise ValueError("codes must lie in 0..3 and offsets must not decrease")
    return out


def lines_decode(data) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Inverse of lines_encode over a bytes-like blob, with or without a
    newline after its last string, in one native pass after a count of
    its lines: (codes, offsets); None without the codec's library.
    Raises ValueError on a byte other than A/C/G/T and newline."""
    lib = get_lines_lib()
    if lib is None:
        return None
    raw = np.frombuffer(data, dtype=np.uint8)
    m = raw.shape[0]
    src = raw.ctypes.data_as(_u8p)
    n = lib.kmerset_lines_decode(src, m, None, None)
    # Every string ends in a newline, but a last one may end the data.
    unterminated = int(m > 0 and raw[-1] != ord("\n"))
    codes = np.empty(m - n + unterminated, dtype=np.uint8)
    offsets = np.empty(n + 1, dtype=np.int64)
    if lib.kmerset_lines_decode(
        src, m, codes.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p)
    ) < 0:
        raise ValueError("strings must contain only A/C/G/T")
    return codes, offsets


def chain_walk(succ: np.ndarray, starts: np.ndarray):
    """Sequential C walk of successor chains (reference walk loops,
    lib/core/spss.h:394-423).  Returns (nodes, group_starts) with the
    chains concatenated in `starts` order, or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = succ.shape[0]
    nodes = np.empty(n, dtype=np.int64)
    groups = np.empty(starts.shape[0] + 1, dtype=np.int64)
    visited = np.zeros(n, dtype=np.uint8)
    total = lib.kmerio_chain_walk(
        succ.ctypes.data_as(_i64p), n,
        starts.ctypes.data_as(_i64p), starts.shape[0],
        nodes.ctypes.data_as(_i64p), groups.ctypes.data_as(_i64p),
        visited.ctypes.data_as(_u8p),
    )
    if total < 0:
        # succ violated the chain contract (cycle / revisits): the C walk
        # refuses rather than overrun; let the caller's fallback handle it.
        return None
    return nodes[:total], groups


def chain_walk_kept(
    succ: np.ndarray, starts: np.ndarray, keep_fn
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Canonical-dedup chain walk: pass 1 measures each mirror pair of
    chains once (n visits, not 2n), `keep_fn(starts, ends)` picks the
    orientation winners (reference skip rule, lib/core/spss.h:511,555),
    pass 2 emits only kept chains.  Returns (nodes, group_starts) over
    kept chains in `starts` order, or None without the native lib."""
    lib = get_lib()
    if lib is None:
        return None
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    n = succ.shape[0]
    ns = starts.shape[0]
    seen = np.zeros(n, dtype=np.uint8)
    s_arr = np.empty(ns, dtype=np.int64)
    e_arr = np.empty(ns, dtype=np.int64)
    l_arr = np.empty(ns, dtype=np.int64)
    nc = lib.kmerio_chain_pairs(
        succ.ctypes.data_as(_i64p), n,
        starts.ctypes.data_as(_i64p), ns,
        seen.ctypes.data_as(_u8p),
        s_arr.ctypes.data_as(_i64p), e_arr.ctypes.data_as(_i64p),
        l_arr.ctypes.data_as(_i64p),
    )
    if nc < 0:
        # A start led into a cycle (chain-contract violation):
        # dropping it would silently lose k-mers — fall back.
        return None
    s_arr, e_arr, l_arr = s_arr[:nc], e_arr[:nc], l_arr[:nc]
    keep = keep_fn(s_arr, e_arr)
    kept = np.ascontiguousarray(np.where(keep, s_arr, e_arr ^ 1))
    groups = np.zeros(kept.shape[0] + 1, dtype=np.int64)
    np.cumsum(l_arr, out=groups[1:])
    nodes = np.empty(int(groups[-1]), dtype=np.int64)
    # group_starts = groups[:-1], group_ends = groups[1:] (views into the
    # same contiguous prefix array; the C side bounds every write).
    rc = lib.kmerio_chain_emit(
        succ.ctypes.data_as(_i64p), n,
        kept.ctypes.data_as(_i64p), kept.shape[0],
        groups.ctypes.data_as(_i64p),
        groups[1:].ctypes.data_as(_i64p),
        nodes.ctypes.data_as(_i64p),
    )
    if rc < 0:
        # A kept walk violated its measured length (e.g. a succ array
        # that is not mirror-symmetric): refuse rather than emit a
        # corrupt buffer; the caller's fallback walk handles it.
        return None
    return nodes, groups


def greedy_match(
    pa: np.ndarray, pb: np.ndarray, n_ports: int
) -> Optional[np.ndarray]:
    """Priority-ordered greedy maximal matching in one O(E) C pass
    (native/kmerio.c kmerio_greedy_match) — provably identical to the
    handshake-rounds result with edge-index priorities.  Returns
    match[port] (or -1), or None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    pa = np.ascontiguousarray(pa, dtype=np.int64)
    pb = np.ascontiguousarray(pb, dtype=np.int64)
    if pb.shape[0] != pa.shape[0]:
        return None  # C reads pb[0..len(pa)): mismatched lengths would OOB
    match = np.full(n_ports, -1, dtype=np.int64)
    lib.kmerio_greedy_match(
        pa.ctypes.data_as(_i64p), pb.ctypes.data_as(_i64p),
        pa.shape[0], match.ctypes.data_as(_i64p),
    )
    return match


def revcomp(kmers: np.ndarray, k: int) -> Optional[np.ndarray]:
    """Native reverse complement; None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    kmers = np.ascontiguousarray(kmers, dtype=np.int64)
    out = np.empty_like(kmers)
    lib.kmerio_revcomp(
        kmers.ctypes.data_as(_i64p), kmers.size, k, out.ctypes.data_as(_i64p)
    )
    return out


def window_pack(codes: np.ndarray, k: int) -> Optional[np.ndarray]:
    """Native rolling window pack; None without the lib."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    out = np.empty(max(n - k + 1, 0), dtype=np.int64)
    if out.size:
        lib.kmerio_window_pack(
            codes.ctypes.data_as(_u8p), n, k, out.ctypes.data_as(_i64p)
        )
    return out


def emit_kmer_chains(
    A: np.ndarray, k: int, nodes: np.ndarray, groups: np.ndarray, oriented: bool
):
    """Native one-pass unitig emission (reference ConcatenateKmers,
    lib/core/spss.h:25-41); returns (codes, offsets) or None."""
    lib = get_lib()
    if lib is None:
        return None
    A = np.ascontiguousarray(A, dtype=np.int64)
    nodes = np.ascontiguousarray(nodes, dtype=np.int64)
    groups = np.ascontiguousarray(groups, dtype=np.int64)
    n_groups = groups.shape[0] - 1
    total = int(nodes.shape[0]) + n_groups * (k - 1)
    codes = np.empty(max(total, 1), dtype=np.uint8)
    offsets = np.empty(n_groups + 1, dtype=np.int64)
    lib.kmerio_emit_kmer_chains(
        A.ctypes.data_as(_i64p), k,
        nodes.ctypes.data_as(_i64p), groups.ctypes.data_as(_i64p), n_groups,
        1 if oriented else 0,
        offsets.ctypes.data_as(_i64p), codes.ctypes.data_as(_u8p),
    )
    # Slice to the C function's own final offset: `total` above is an
    # allocation upper bound that over-counts (k-1) per EMPTY group
    # (offsets[g+1] == offsets[g]); returning the inflated slice would
    # carry uninitialized tail bytes into PackedStrings concatenation.
    return codes[: int(offsets[-1])], offsets


def side_tables_directed(A: np.ndarray, k: int):
    """Native side tables of the directed graph (reference:
    lib/core/spss.h:76-94, the fp edition's canonical = 0 case); returns
    ((outdeg, next), (indeg, prev)) or None."""
    lib = get_lib()
    if lib is None:
        return None
    A = np.ascontiguousarray(A, dtype=np.int64)
    n = A.shape[0]
    if n > np.iinfo(np.int32).max:
        # The nbr arrays carry int32 indices; past 2^31 they would wrap
        # silently — fall back to the numpy path.
        return None
    logcap = max(4, int(n * 2 - 1).bit_length())
    # The directed case never touches the probe table (it only probes
    # for canonical candidates): a dummy slot keeps the ABI happy.
    table = np.zeros(1, dtype=np.uint64)
    rdeg = np.empty(n, np.int32); rnbr = np.empty(n, np.int32)
    ldeg = np.empty(n, np.int32); lnbr = np.empty(n, np.int32)
    rsame = np.empty(n, np.uint8); lsame = np.empty(n, np.uint8)
    rc = lib.kmerio_side_tables_fp(
        A.ctypes.data_as(_i64p), n, k, 0, table.ctypes.data_as(_u64p), logcap,
        rdeg.ctypes.data_as(_i32p), rnbr.ctypes.data_as(_i32p),
        rsame.ctypes.data_as(_u8p),
        ldeg.ctypes.data_as(_i32p), lnbr.ctypes.data_as(_i32p),
        lsame.ctypes.data_as(_u8p),
    )
    if rc != 0:
        # Allocation failure inside the C pass: the zeroed tables would
        # silently classify every k-mer as terminal — fall back instead.
        return None
    return (rdeg, rnbr), (ldeg, lnbr)


def seq_match(
    pa: np.ndarray, pb: np.ndarray, n_nodes: int
) -> Optional[np.ndarray]:
    """Native sequential greedy path-extension matching (reference's
    higher-quality mode, lib/core/spss.h:1208-1356), byte-identical to
    core/spss.py::_sequential_matching.  Returns match[2*n_nodes] or
    None."""
    lib = get_lib()
    if lib is None:
        return None
    pa = np.ascontiguousarray(pa, dtype=np.int64)
    pb = np.ascontiguousarray(pb, dtype=np.int64)
    if pb.shape[0] != pa.shape[0]:
        return None  # C reads pb[0..len(pa)): mismatched lengths would OOB
    match = np.empty(2 * n_nodes, dtype=np.int64)
    rc = lib.kmerio_seq_match(
        pa.ctypes.data_as(_i64p), pb.ctypes.data_as(_i64p), pa.shape[0],
        n_nodes, match.ctypes.data_as(_i64p),
    )
    return match if rc == 0 else None


def walk_cycles(
    succ: np.ndarray, A: np.ndarray, k: int, oriented: bool, visited: np.ndarray
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """One-pass native walk of leftover pure cycles (reference:
    lib/core/spss.h:203-224,583-612), byte-identical to the Python
    fallback's output (same ascending-entity order, same stop rule).
    Mutates `visited`; returns (codes, offsets) or None."""
    lib = get_lib()
    if lib is None:
        return None
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    A = np.ascontiguousarray(A, dtype=np.int64)
    n_ent = A.shape[0]
    vis = np.ascontiguousarray(visited, dtype=np.uint8)
    m = int(n_ent - np.count_nonzero(vis))
    codes = np.empty(max(m * k, 1), dtype=np.uint8)
    offsets = np.zeros(m + 1, dtype=np.int64)
    n_cyc = lib.kmerio_walk_cycles(
        succ.ctypes.data_as(_i64p), A.ctypes.data_as(_i64p), n_ent, k,
        1 if oriented else 0,
        vis.ctypes.data_as(_u8p), codes.ctypes.data_as(_u8p),
        offsets.ctypes.data_as(_i64p),
    )
    visited[:] = vis.view(bool) if visited.dtype == bool else vis
    return codes[: int(offsets[n_cyc])], offsets[: n_cyc + 1]


_scratch_tls = threading.local()


def _zeroed_u64(logcap: int, slot: int = 0) -> np.ndarray:
    """Zeroed uint64 fp-table scratch.  Large tables (>= 8 MB) reuse a
    persistent per-slot buffer: a fresh np.zeros at multi-hundred-MB
    sizes pays an mmap + first-touch fault storm on a virtualized host;
    an explicit fill of a resident buffer streams at memory bandwidth
    instead.  Slots separate tables that are live at the same time
    (overlap_edges uses two); the cache is thread-local so concurrent
    builds never share a buffer."""
    size = 1 << logcap
    if logcap < 20:
        return np.zeros(size, dtype=np.uint64)
    cache = getattr(_scratch_tls, "bufs", None)
    if cache is None:
        cache = _scratch_tls.bufs = {}
    buf = cache.get(slot)
    if buf is None or buf.shape[0] < size:
        # Grow-only: shrinking sets in the multi-set loop alternate
        # logcaps, and replacing a larger cached buffer with a smaller
        # fresh np.zeros would re-pay the first-touch fault storm per
        # size class — the exact cost this cache exists to avoid.  A
        # zeroed prefix view serves any smaller request.
        buf = np.zeros(size, dtype=np.uint64)
        cache[slot] = buf
        return buf
    if buf.shape[0] == size:
        buf.fill(0)
        return buf
    view = buf[:size]
    view.fill(0)
    return view


def dedup_edges(a: np.ndarray, b: np.ndarray) -> Optional[np.ndarray]:
    """Indices of first occurrences of undirected port edges, ascending
    (kmerio_dedup_edges: one hash pass in discovery order, replacing the
    numpy unique-with-index sort of core/spss._dedup_port_edges).
    Returns int64 indices into a/b, or None (unbuilt lib, ports too wide
    for the 32|32 key packing)."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    m = a.shape[0]
    if m == 0:
        return np.empty(0, dtype=np.int64)
    if b.shape[0] != m:
        return None
    # Key packs both port ids into 32-bit halves.
    if a.min() < 0 or b.min() < 0 or a.max() >= 1 << 32 or b.max() >= 1 << 32:
        return None
    logcap = max(4, int(m * 2 - 1).bit_length())
    table = _zeroed_u64(logcap)
    idx = np.empty(m, dtype=np.int64)
    cnt = lib.kmerio_dedup_edges(
        a.ctypes.data_as(_i64p), b.ctypes.data_as(_i64p), m,
        table.ctypes.data_as(_u64p), logcap, idx.ctypes.data_as(_i64p),
    )
    if cnt < 0:
        return None  # (0,0) edge would alias the empty marker: numpy path
    return idx[:cnt]


def count_hash(codes: np.ndarray, k: int) -> Optional[int]:
    """Reference-style single-thread hash counting (baseline only);
    returns the number of distinct canonical k-mers, or None."""
    if k > 23:
        return None  # keys are stored in a 48-bit field (2k+1 bits needed)
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    logcap = max(4, int(max(n, 1) * 2 - 1).bit_length())
    table = np.zeros(1 << logcap, dtype=np.uint64)
    return int(
        lib.kmerio_count_hash(
            codes.ctypes.data_as(_u8p), n, k, table.ctypes.data_as(_u64p),
            logcap,
        )
    )


# Partitioned overlap join engages above this unitig count (below it the
# fp tables are cache-resident and the partition passes are pure
# overhead); parity tests lower it.
_OVERLAP_PART_MIN = 1 << 19

# Grow-only scratch of the partitioned overlap join; the lock also
# serializes the C call that uses it (ctypes releases the GIL, so two
# threads could otherwise share the buffer mid-flight).
_part_lock = threading.Lock()
_part_scratch: Optional[np.ndarray] = None


def _overlap_edges_part(lib, P, S, n, k, ptab, stab, logcap):
    """Partitioned overlap probe + discovery-order restore; returns
    (a_ports, b_ports) or None (cap overflow / scratch shape — caller
    falls back to the fp edition)."""
    global _part_scratch
    sbytes = int(lib.kmerio_overlap_part_scratch(n, logcap))
    cap = 8 * n + 1024
    hits = np.empty(cap, dtype=np.int64)
    with _part_lock:
        if _part_scratch is None or _part_scratch.nbytes < sbytes:
            _part_scratch = np.empty(sbytes, dtype=np.uint8)
        scratch = _part_scratch
        m = int(lib.kmerio_overlap_edges_part(
            P.ctypes.data_as(_i64p), S.ctypes.data_as(_i64p), n, k,
            ptab.ctypes.data_as(_u64p), stab.ctypes.data_as(_u64p), logcap,
            scratch.ctypes.data_as(_u8p), scratch.nbytes, cap,
            hits.ctypes.data_as(_i64p),
        ))
    if m < 0:
        return None
    # Packed (pass << 60 | i << 32 | j): an UNSIGNED ascending sort is
    # exactly the fp edition's discovery order.  One C call radix-sorts
    # and unpacks.
    a = np.empty(m, dtype=np.int64)
    b = np.empty(m, dtype=np.int64)
    if m > 0:
        sortbuf = np.empty(m, dtype=np.uint64)
        lib.kmerio_overlap_sort_unpack(
            hits[:m].ctypes.data_as(_u64p), m, sortbuf.ctypes.data_as(_u64p),
            a.ctypes.data_as(_i64p), b.ctypes.data_as(_i64p),
        )
    return a, b


def overlap_edges(P: np.ndarray, S: np.ndarray, k: int):
    """Native unitig overlap-edge discovery (reference hash multimaps,
    lib/core/spss.h:619-695); returns (a_ports, b_ports) in discovery
    order (pre-dedup) or None.

    Large inputs route to the cache-blocked partitioned probe edition
    (kmerio_overlap_edges_part): hits come back as packed
    (pass << 60 | i << 32 | j) in arbitrary order — pass is 4 bits, i
    28 (hence the 16*n < 2^31 guard), j 32 — and an UNSIGNED ascending
    sort restores the fp edition's exact discovery order: pass-major,
    i-minor, and within one probe the fp multimap walks ascending j."""
    lib = get_lib()
    if lib is None:
        return None
    P = np.ascontiguousarray(P, dtype=np.int64)
    S = np.ascontiguousarray(S, dtype=np.int64)
    n = P.shape[0]
    logcap = max(4, int(max(n, 1) * 2 - 1).bit_length())
    # fp tables are uint64 zero-initialized; the two-pass API reuses the
    # same buffers as int64 filled with -1 (same byte layout).
    ptab = _zeroed_u64(logcap, slot=0)
    stab = _zeroed_u64(logcap, slot=1)
    if n >= _OVERLAP_PART_MIN and 16 * n < (1 << 31):
        res = _overlap_edges_part(lib, P, S, n, k, ptab, stab, logcap)
        if res is not None:
            return res
        # overflow/shape failure: the tables may be part-filled — reset
        # for the fp edition below.
        ptab.fill(0)
        stab.fill(0)
    # Single pass with a generous capacity (8 candidate edges per
    # unitig covers non-degenerate graphs); highly repetitive inputs can
    # exceed any linear bound (edge counts are quadratic per signature
    # class), in which case the two-pass count+fill API runs instead.
    cap = 8 * n + 1024
    out = np.empty(2 * cap, dtype=np.int64)
    count = lib.kmerio_overlap_edges_fp(
        P.ctypes.data_as(_i64p), S.ctypes.data_as(_i64p), n, k,
        ptab.ctypes.data_as(_u64p), stab.ctypes.data_as(_u64p),
        logcap, cap, out.ctypes.data_as(_i64p),
    )
    if count >= 0:
        pairs = out[: 2 * count].reshape(-1, 2)
        return pairs[:, 0], pairs[:, 1]
    # The two-pass kernel requires -1-filled tables: its insert loop
    # spins forever on zeros.
    ptab.fill(np.uint64(2**64 - 1))
    stab.fill(np.uint64(2**64 - 1))
    args = (
        P.ctypes.data_as(_i64p), S.ctypes.data_as(_i64p), n, k,
        ptab.ctypes.data_as(_i64p), stab.ctypes.data_as(_i64p), logcap,
    )
    count = lib.kmerio_overlap_edges(*args, 1, None)
    out = np.empty(2 * max(count, 1), dtype=np.int64)
    lib.kmerio_overlap_edges(*args, 0, out.ctypes.data_as(_i64p))
    pairs = out[: 2 * count].reshape(-1, 2)
    return pairs[:, 0], pairs[:, 1]


def sorted_algebra(a: np.ndarray, b: np.ndarray):
    """One-pass (intersection, a_only, b_only) of sorted-unique int64
    arrays (reference set algebra, lib/core/kmer_set.h:164-219), or None."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    inter = np.empty(min(a.size, b.size) or 1, dtype=np.int64)
    a_only = np.empty(a.size or 1, dtype=np.int64)
    b_only = np.empty(b.size or 1, dtype=np.int64)
    counts = np.zeros(3, dtype=np.int64)
    lib.kmerio_sorted_algebra(
        a.ctypes.data_as(_i64p), a.size,
        b.ctypes.data_as(_i64p), b.size,
        inter.ctypes.data_as(_i64p),
        a_only.ctypes.data_as(_i64p),
        b_only.ctypes.data_as(_i64p),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )

    def _trim(buf: np.ndarray, n: int) -> np.ndarray:
        # A slice is a view pinning the whole scratch buffer; long-lived
        # callers (the greedy factor loop caches these arrays per set)
        # would otherwise hold pre-split-sized allocations for tiny
        # results.  Copy when most of the buffer is dead.
        out = buf[:n]
        return out.copy() if 2 * n < buf.shape[0] else out

    return (
        _trim(inter, int(counts[0])),
        _trim(a_only, int(counts[1])),
        _trim(b_only, int(counts[2])),
    )


def intersect_size(a: np.ndarray, b: np.ndarray) -> Optional[int]:
    """|a ∩ b| of sorted-unique int64 arrays — kmerio_sorted_algebra in
    count-only mode (NULL outputs), the similarity-sketch kernel
    (reference sorted-merge loop, lib/core/kmer_set_set.h:158-184).
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    counts = np.zeros(3, dtype=np.int64)
    null = ctypes.cast(None, _i64p)
    lib.kmerio_sorted_algebra(
        a.ctypes.data_as(_i64p), a.size,
        b.ctypes.data_as(_i64p), b.size,
        null, null, null,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    return int(counts[0])


def merge_counts(
    ak: np.ndarray, ac: np.ndarray, bk: np.ndarray, bc: np.ndarray
):
    """One-pass merge of two sorted-unique (key, count) runs, summing
    counts of equal keys (the out-of-core chunk combiner; reference's
    bucket merge, lib/core/kmer_counter.h:105-126), or None."""
    lib = get_lib()
    if lib is None:
        return None
    ak = np.ascontiguousarray(ak, dtype=np.int64)
    ac = np.ascontiguousarray(ac, dtype=np.int64)
    bk = np.ascontiguousarray(bk, dtype=np.int64)
    bc = np.ascontiguousarray(bc, dtype=np.int64)
    ok = np.empty(max(ak.size + bk.size, 1), dtype=np.int64)
    oc = np.empty(max(ak.size + bk.size, 1), dtype=np.int64)
    m = lib.kmerio_merge_counts(
        ak.ctypes.data_as(_i64p), ac.ctypes.data_as(_i64p), ak.size,
        bk.ctypes.data_as(_i64p), bc.ctypes.data_as(_i64p), bk.size,
        ok.ctypes.data_as(_i64p), oc.ctypes.data_as(_i64p),
    )
    return ok[:m], oc[:m]


def merge_keys(ak: np.ndarray, bk: np.ndarray):
    """Sorted union of two sorted-unique int64 arrays (keys-only mode of
    kmerio_merge_counts — the decode-direction chunk combiner), or None."""
    lib = get_lib()
    if lib is None:
        return None
    ak = np.ascontiguousarray(ak, dtype=np.int64)
    bk = np.ascontiguousarray(bk, dtype=np.int64)
    ok = np.empty(max(ak.size + bk.size, 1), dtype=np.int64)
    m = lib.kmerio_merge_counts(
        ak.ctypes.data_as(_i64p), None, ak.size,
        bk.ctypes.data_as(_i64p), None, bk.size,
        ok.ctypes.data_as(_i64p), None,
    )
    return ok[:m]


def gather_ranges(src: np.ndarray, lo: np.ndarray, hi: np.ndarray):
    """Concatenation of src[lo[i]:hi[i]] slices (uint8 or int64), or None."""
    lib = get_lib()
    if lib is None:
        return None
    lo = np.ascontiguousarray(lo, dtype=np.int64)
    hi = np.ascontiguousarray(hi, dtype=np.int64)
    total = int((hi - lo).sum())
    if src.dtype == np.uint8:
        src = np.ascontiguousarray(src)
        out = np.empty(max(total, 1), dtype=np.uint8)
        lib.kmerio_gather_ranges_u8(
            src.ctypes.data_as(_u8p), lo.ctypes.data_as(_i64p),
            hi.ctypes.data_as(_i64p), lo.size, out.ctypes.data_as(_u8p),
        )
    else:
        src = np.ascontiguousarray(src, dtype=np.int64)
        out = np.empty(max(total, 1), dtype=np.int64)
        lib.kmerio_gather_ranges_i64(
            src.ctypes.data_as(_i64p), lo.ctypes.data_as(_i64p),
            hi.ctypes.data_as(_i64p), lo.size, out.ctypes.data_as(_i64p),
        )
    return out[:total]


def pack_rows(codes: np.ndarray, offsets: np.ndarray, k: int, from_end: bool):
    """Packed k-prefix/suffix of every string, or None."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = offsets.shape[0] - 1
    out = np.empty(max(n, 1), dtype=np.int64)
    lib.kmerio_pack_rows(
        codes.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p),
        n, k, 1 if from_end else 0, out.ctypes.data_as(_i64p),
    )
    return out[:n]


def emit_string_chains(
    codes: np.ndarray,
    uoffsets: np.ndarray,
    k: int,
    nodes: np.ndarray,
    groups: np.ndarray,
    oriented: bool,
):
    """Native SPSS string emission (reference GetStringFromPath,
    lib/core/spss.h:1186-1206); returns (codes, offsets) or None."""
    lib = get_lib()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    uoffsets = np.ascontiguousarray(uoffsets, dtype=np.int64)
    nodes = np.ascontiguousarray(nodes, dtype=np.int64)
    groups = np.ascontiguousarray(groups, dtype=np.int64)
    n_groups = groups.shape[0] - 1
    ent = (nodes >> 1) if oriented else nodes
    lens = uoffsets[ent + 1] - uoffsets[ent]
    n_skips = int(np.maximum(np.diff(groups) - 1, 0).sum())
    total = int(lens.sum()) - n_skips * (k - 1)
    out = np.empty(max(total, 1), dtype=np.uint8)
    offsets = np.empty(n_groups + 1, dtype=np.int64)
    lib.kmerio_emit_string_chains(
        codes.ctypes.data_as(_u8p), uoffsets.ctypes.data_as(_i64p), k,
        nodes.ctypes.data_as(_i64p), groups.ctypes.data_as(_i64p), n_groups,
        1 if oriented else 0, offsets.ctypes.data_as(_i64p),
        out.ctypes.data_as(_u8p),
    )
    return out[:total], offsets


def cycle_leaders(succ: np.ndarray, oriented: bool):
    """Min-label leader of every cycle of the matched port graph, or None
    (native one-pass walk replacing pointer-doubling leader election,
    reference union-find loop removal: lib/core/spss.h:877-933,1541-1647)."""
    lib = get_lib()
    if lib is None:
        return None
    succ = np.ascontiguousarray(succ, dtype=np.int64)
    # one leader per cycle; cycles have length >= 1 so n bounds the count
    out = np.empty(max(succ.size, 1), dtype=np.int64)
    cnt = lib.kmerio_cycle_leaders(
        succ.ctypes.data_as(_i64p), succ.size, int(oriented),
        out.ctypes.data_as(_i64p),
    )
    if cnt < 0:
        return None
    return out[:cnt]


# The succ rebuild from side codes takes the partitioned edition from this
# many k-mers on (reference native.py:752); parity tests lower it.
_SUCC_PART_MIN = 1 << 20
# The most k-mers whose side codes succ_from_sides takes: its fp slots
# carry int32 indices, so 2n must fit an int32 (reference :848).
MAX_SIDES_KMERS = np.iinfo(np.int32).max >> 1


def succ_from_sides(A: np.ndarray, sides: np.ndarray, k: int) -> Optional[np.ndarray]:
    """Oriented successor array rebuilt from the device's per-k-mer side
    codes (ops/unitigs.device_unitig_sides, the 1 B/k-mer link format):
    one fp probe per non-terminal side.  From _SUCC_PART_MIN k-mers on it
    takes the cache-blocked partitioned edition (kmerio_succ_from_sides_
    part, bit-identical output), sharing the grow-only partition scratch
    with the overlap join.  Returns succ (2n,) int64 with -1 at terminal
    exits, or None (no library, a probe miss on corrupt side codes, a
    length mismatch or more than MAX_SIDES_KMERS k-mers)."""
    lib = get_lib()
    if lib is None:
        return None
    A = np.ascontiguousarray(A, dtype=np.int64)
    sides = np.ascontiguousarray(sides, dtype=np.uint8)
    n = A.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if sides.shape[0] != n or n > MAX_SIDES_KMERS:
        return None
    use_part = n >= _SUCC_PART_MIN
    # The fp edition wants a low load factor (every extra probe is a DRAM
    # miss); the partitioned one probes cache-resident regions, so about
    # 50% load halves the table fill for free.
    logcap = max(4, int(n + (n >> 1) if use_part else n * 2 - 1).bit_length())
    table = _zeroed_u64(logcap)
    succ = np.empty(2 * n, dtype=np.int64)
    args = (A.ctypes.data_as(_i64p), n, k, sides.ctypes.data_as(_u8p),
            table.ctypes.data_as(_u64p), logcap)
    if use_part:
        global _part_scratch
        sbytes = int(lib.kmerio_succ_part_scratch(n, logcap))
        with _part_lock:
            if _part_scratch is None or _part_scratch.nbytes < sbytes:
                _part_scratch = np.empty(sbytes, dtype=np.uint8)
            rc = lib.kmerio_succ_from_sides_part(
                *args, _part_scratch.ctypes.data_as(_u8p),
                _part_scratch.nbytes, succ.ctypes.data_as(_i64p),
            )
        if rc == 0:
            return succ
        if rc == -1:
            return None  # a probe miss: corrupt side codes
        table[:] = 0  # scratch too small: the fp edition below
    if lib.kmerio_succ_from_sides(*args, succ.ctypes.data_as(_i64p)) != 0:
        return None
    return succ


def delta_decode(d: np.ndarray, exc: np.ndarray, n_exc: int) -> Optional[np.ndarray]:
    """The sorted int64 keys of ops/deltas.py's wire format: d (n,) uint8
    or uint16 gaps, patched at the first n_exc rows of exc (m, 2)
    (ascending (position, true gap) rows, int32 or int64), then summed
    (kmerio_delta_decode).  None without the library, for another gap
    dtype, or when the rows are out of order or the keys are not
    strictly increasing (positional corruption)."""
    lib = get_lib()
    if lib is None or d.dtype not in (np.uint8, np.uint16):
        return None
    d = np.ascontiguousarray(d)
    exc = np.ascontiguousarray(exc[:n_exc], dtype=np.int64)
    out = np.empty(d.shape[0], dtype=np.int64)
    rc = lib.kmerio_delta_decode(
        d.ctypes.data_as(ctypes.c_void_p), d.itemsize, d.shape[0],
        exc.ctypes.data_as(_i64p), n_exc, out.ctypes.data_as(_i64p),
    )
    return out if rc == 0 else None
