"""Gap-encoded downloads of the sorted keys, for slow host-device links.

The port's copy of kmerset_tpu/ops/deltas.py: CAP, CAP_MAX, _cap_class,
expected_escape, plan_escape, dispatch_delta, fetch_delta and
device_delta_download (:42-255), with the encode (_build_encode, :46-86)
in torch ops on the count's device.  The wire arrays are the
reference's, element for element:

  d[i] = keys[i] - keys[i-1], d[0] = keys[0], so the decode is a plain
  cumulative sum;
  dsmall[i] = min(d[i], esc) as uint8 (esc 255) or uint16 (esc 65535);
  exc: one (position, d) row per gap >= esc, ascending, the first
  min(n, cap) of them, padded with (_IDX_SENTINEL, 0) rows, then the
  tail row (n_overflows, keys[n-1]); int32 rows when `narrow` (keys
  under 2^31), else int64.

The reference gathers the exception positions by sorting sentinel keys
(:69-70); here kernel B3 (ops/compact.compact_select) compacts the
positions and gaps of the overflow mask, in order, so the rows come out
ascending as the decode needs.  The port's keys are exactly n long (the
reference's padded length P is n here).

When the format rejects the data (no plan, more overflows than exception
rows, or a decode that fails its integrity checks) the caller downloads
the raw keys: that is the format's own rule, logged at debug level and
counted in `rejections`.  An exception raises; nothing is caught.

Where the port differs from the reference on purpose (pinned in
tests/test_torch_deltas.py):
- expected_overflows computes the canonical density model's expectation
  2n(1 - e^-a(1 + a))/a^2 as 2n(-expm1(-a) - a e^-a)/a^2.  The
  reference's form (:142) cancels to 0 for a below about 1.5e-8 (k = 29
  and 31 from 2^20 keys on), so its plan there is (255, CAP, False)
  while nearly every gap overflows, and each such download is wasted
  and taken again raw;
- plan_escape compares the wire estimate with the raw download the
  port would make instead, 4 bytes a key for k <= SINGLE_MAX_K (int32
  keys) and 8 above, where the reference compares with 8 at every k
  (:152);
- `narrow` keys on ops/pack.SINGLE_MAX_K, the widest k whose keys are
  int32, where the reference tests a literal k <= 15 (:148).
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import native
from ..utils import trace
from . import backend
from .compact import compact_select
from .pack import SINGLE_MAX_K

logger = logging.getLogger("kmerset")

CAP = 1 << 16  # exception slots per download at least (1 MB on the wire)
CAP_MAX = 1 << 21  # adaptive exception slots are capped here
_IDX_SENTINEL = (1 << 31) - 1

# Downloads the format rejected since the last reset, by reason: no plan
# for the set's density, more overflows than exception rows, a decode that
# failed its integrity checks.  chip_smoke.py reads and resets them.
rejections = {"plan": 0, "overflow": 0, "integrity": 0}
# Downloads that the format carried since the last reset.
downloads = 0


def raw_key_bytes(k: int) -> int:
    """Bytes a key takes in the raw download the format replaces: int32
    keys through SINGLE_MAX_K, int64 above (ops/count.count_kmers_frag)."""
    return 4 if k <= SINGLE_MAX_K else 8


def expected_overflows(n: int, k: int, canonical: bool, esc: int) -> float:
    """Expected count of gaps >= esc among n sorted unique keys of 2k bits
    (reference plan_escape's model, deltas.py:92-109, 139-144).

    Forward keys are about uniform over [0, 4^k): gaps are about
    geometric with mean 4^k / n, so n e^-a overflow, a = esc n / 4^k.
    Canonical keys min(x, rc(x)) thin out linearly across the keyspace,
    and integrating the local overflow probability over that density gives
    2n(1 - e^-a(1 + a))/a^2 with a = 2 esc n / 4^k, written here without
    the cancellation of the reference's form: it tends to n as a -> 0."""
    a = esc * n / float(4**k)
    if not canonical:
        return n * math.exp(-a)
    a *= 2.0
    return 2.0 * n * (-math.expm1(-a) - a * math.exp(-a)) / (a * a)


def plan_escape(n: int, k: int, canonical: bool):
    """(esc, cap, narrow) minimizing the estimated wire bytes, or None when
    no plan beats the raw download (reference deltas.py:117-158).

    cap is 1.4x the expected overflow count, at least CAP, rounded up to a
    {2^p, 3*2^(p-1)} class (_cap_class) and at most CAP_MAX; `narrow` marks
    int32 exception rows.  The estimate per escape width is
        n * width + cap * row_bytes
    and a plan must cost less than the raw download, n * raw_key_bytes(k)."""
    if n <= 0:
        return None
    narrow = k <= SINGLE_MAX_K
    row = 8 if narrow else 16
    best = None
    for esc, width in ((255, 1), (65535, 2)):
        cap = _cap_class(max(CAP, int(1.4 * expected_overflows(n, k, canonical, esc)) + 1))
        if cap > CAP_MAX:
            continue
        wire = n * width + cap * row
        if wire >= n * raw_key_bytes(k):
            continue
        if best is None or wire < best[0]:
            best = (wire, esc, cap, narrow)
    return None if best is None else best[1:]


def expected_escape(n: int, k: int, canonical: bool) -> Optional[int]:
    """The escape width of plan_escape's plan, or None (reference
    deltas.py:92-111)."""
    plan = plan_escape(n, k, canonical)
    return plan[0] if plan is not None else None


def _cap_class(c: int) -> int:
    """Smallest {2^p, 3*2^(p-1)} class >= c (reference deltas.py:161-167)."""
    p = max(0, (c - 1).bit_length())
    three = 3 << max(0, p - 2)
    if three >= c and three < (1 << p):
        return three
    return 1 << p


def encode(keys: torch.Tensor, n: int, esc: int, cap: int, narrow: bool):
    """(dsmall, exc) of the first n sorted unique keys (int32 or int64) on
    their device: the wire arrays of the module docstring.  dsmall is
    uint8 for esc 255, else int16 holding the uint16 bit patterns (torch
    has no uint16 arithmetic; the host views them as uint16).  The
    exception rows are compacted by kernel B3 on CUDA, its plain version
    on the CPU."""
    u = keys[:n].long()
    d = torch.empty_like(u)
    d[:1] = u[:1]
    torch.sub(u[1:], u[:-1], out=d[1:])
    over = d >= esc
    dsmall = torch.clamp(d, max=esc).to(torch.uint8 if esc == 255 else torch.int16)
    pos = torch.arange(n, dtype=torch.int32, device=u.device)
    (cpos, cd), n_over = compact_select([pos, d], over)
    m = min(n, cap)
    live = torch.arange(m, device=u.device) < n_over
    rows = torch.stack([torch.where(live, cpos[:m].long(), _IDX_SENTINEL),
                        torch.where(live, cd[:m], 0)], dim=1)
    tail = torch.stack([n_over.long(), u[n - 1]]).view(1, 2)
    exc = torch.cat([rows, tail])
    return dsmall, exc.int() if narrow else exc


class Pending(NamedTuple):
    """An encode launched by dispatch_delta, still on the device."""

    dsmall: torch.Tensor
    exc: torch.Tensor
    esc: int


def _reject(reason: str, why: str) -> None:
    rejections[reason] += 1
    logger.debug("deltas: format rejected (%s): %s; raw key download", reason, why)


def dispatch_delta(keys: torch.Tensor, n: int, k: int, canonical: bool) -> Optional[Pending]:
    """Launches the gap encode of the first n sorted unique keys and
    returns the wire arrays still on the device, or None when plan_escape
    finds no plan (a rejection).  Launching before fetching lets the
    caller queue more device work behind the encode (reference
    deltas.py:170-191)."""
    plan = plan_escape(n, k, canonical)
    if plan is None:
        _reject("plan", f"no plan beats {raw_key_bytes(k)} B/key at n={n}, k={k}")
        return None
    esc, cap, narrow = plan
    dsmall, exc = encode(keys, n, esc, cap, narrow)
    return Pending(dsmall, exc, esc)


def _decode(d: np.ndarray, exc: np.ndarray, n_over: int) -> Optional[np.ndarray]:
    """The keys of the wire arrays through the native decoder, else numpy
    (widen, patch, cumulative sum), or None when the patched gaps are not
    all positive past position 0 (the native decoder's checks, reference
    deltas.py:219-232)."""
    if native.get_lib() is not None:
        return native.delta_decode(d, exc, n_over)
    d64 = d.astype(np.int64)
    d64[exc[:n_over, 0]] = exc[:n_over, 1]
    if d64.shape[0] and (d64[0] < 0 or (d64.shape[0] > 1 and int(d64[1:].min()) <= 0)):
        return None
    return np.cumsum(d64)


def fetch_delta(pending: Pending, n: int) -> Optional[np.ndarray]:
    """Downloads dispatch_delta's wire arrays and decodes the int64 keys,
    or returns None when the format rejects them: more overflows than
    exception rows, or a decode that fails its checks or whose last key
    is not the tail row's (reference deltas.py:194-246).  Logs the wire
    bytes and the download and decode seconds at debug level."""
    global downloads
    with trace.timed("deltas.download") as dl:
        d_h = backend.download("gaps", pending.dsmall)
        exc_h = backend.download("exception rows", pending.exc)
    if pending.esc != 255:
        d_h = d_h.view(np.uint16)
    # min(n, cap) exception rows and the tail row.
    cap_eff = exc_h.shape[0] - 1
    n_over, last = int(exc_h[-1, 0]), int(exc_h[-1, 1])
    if n_over > cap_eff:
        _reject("overflow", f"{n_over} gap overflows exceed the {cap_eff}-row table")
        return None
    with trace.timed("deltas.decode", keys=n) as dc:
        out = _decode(d_h, exc_h, n_over)
    if out is None or (n and int(out[-1]) != last):
        _reject("integrity", "the decoded keys failed the integrity checks")
        return None
    downloads += 1
    logger.debug(
        "deltas: key download %d B (gaps %d B, %d exception rows of %d B) in "
        "%.4f s, decode %.4f s (%d keys, esc %d, %d overflows)",
        d_h.nbytes + exc_h.nbytes, d_h.nbytes, exc_h.shape[0], exc_h.itemsize * 2,
        dl.seconds, dc.seconds, n, pending.esc, n_over,
    )
    return out


def device_delta_download(keys: torch.Tensor, n: int, k: int, canonical: bool):
    """dispatch_delta then fetch_delta: the int64 keys[:n], or None when the
    format rejects them."""
    pending = dispatch_delta(keys, n, k, canonical)
    return None if pending is None else fetch_delta(pending, n)
