"""The staged device-to-host copy of ops/backend.download: copy_staged,
called on CPU tensors (no pinning) with a small piece, against
t.numpy() byte for byte; staged_route, which keeps scalars, small
tensors, views that are not contiguous and the CPU device on t.cpu();
and download on the staged route (forced on CPU tensors), whose span,
counters and debug line are those of the plain route but for
d2h.staged."""

import functools
import json
import logging
import sys
import types

import numpy as np
import pytest
import torch

from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.utils import trace

P = 60  # the piece in bytes: splits int32 and int64 elements across pieces
SIZES = [0, 1, P - 1, P, P + 1, 7 * P // 2]
DTYPES = [torch.uint8, torch.bool, torch.int32, torch.int64]


def source(n: int, dtype, two_d: bool) -> torch.Tensor:
    """n elements of `dtype` (two rows of n with two_d) that differ in
    every byte lane."""
    shape = (2, n) if two_d else (n,)
    vals = torch.arange(int(np.prod(shape)), dtype=torch.int64).reshape(shape)
    if dtype == torch.bool:
        return vals % 3 == 1
    return (vals * 0x0101_0101_0101_0107 + 3).to(dtype)


@pytest.fixture
def logger():
    """The "kmerset" logger at debug level with a capture of its
    messages; its handlers, level and propagation restored afterwards."""
    log = logging.getLogger("kmerset")
    saved = log.handlers[:], log.level, log.propagate
    lines = []

    class Capture(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log.handlers = [Capture(logging.DEBUG)]
    log.setLevel(logging.DEBUG)
    log.propagate = False
    try:
        yield lines
    finally:
        log.handlers, log.propagate = saved[0], saved[2]
        log.setLevel(saved[1])


def traced_download(lines, t: torch.Tensor, what: str = "keys"):
    """(array, the copy.d2h span, the call's counters, the count's debug
    lines) of one logged download under a traced call."""
    del lines[:]
    with trace.root("cli.test", True):
        out = backend.download(what, t, logged=True)
    line = json.loads(next(m for m in lines if m.startswith(trace.PREFIX))
                      [len(trace.PREFIX):])
    (span,) = [s for s in line["spans"] if s["name"] == "copy.d2h"]
    said = [m.rsplit(" in ", 1)[0] for m in lines if m.startswith("count: ")]
    return out, span, line["counters"], said


@pytest.mark.parametrize("two_d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("n", SIZES)
def test_copy_staged_equals_numpy(n, dtype, two_d):
    t = source(n, dtype, two_d)
    want = t.numpy()
    out = np.empty(want.shape, want.dtype)
    got = backend.copy_staged(t, out, piece=P, ring=3, threads=2)
    assert got is out
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _cuda_like(t: torch.Tensor):
    """The shape, layout and size of `t` (a meta tensor: no memory) on a
    device of type "cuda", as far as staged_route reads them."""
    return types.SimpleNamespace(
        device=torch.device("cuda"), is_contiguous=t.is_contiguous,
        numel=t.numel, element_size=t.element_size)


_M = backend.STAGED_MIN_BYTES
ROUTES = {
    "cuda_large": (lambda: _cuda_like(torch.empty(_M // 8, dtype=torch.int64,
                                                  device="meta")), True),
    "cuda_at_threshold_uint8": (lambda: _cuda_like(torch.empty(
        _M, dtype=torch.uint8, device="meta")), True),
    "cuda_large_2d": (lambda: _cuda_like(torch.empty(
        (2, _M // 16), dtype=torch.int64, device="meta")), True),
    "cuda_under_threshold": (lambda: _cuda_like(torch.empty(
        _M - 1, dtype=torch.uint8, device="meta")), False),
    "cuda_scalar": (lambda: _cuda_like(torch.empty(
        (), dtype=torch.int64, device="meta")), False),
    "cuda_not_contiguous": (lambda: _cuda_like(torch.empty(
        _M // 4, dtype=torch.int64, device="meta")[::2]), False),
    "cuda_transposed": (lambda: _cuda_like(torch.empty(
        (_M // 64, 8), dtype=torch.int64, device="meta").t()), False),
    "cpu_large": (lambda: torch.zeros(_M // 8, dtype=torch.int64), False),
    "cpu_small": (lambda: torch.arange(5), False),
    "cpu_scalar": (lambda: torch.tensor(7), False),
    "cpu_not_contiguous": (lambda: torch.arange(64).reshape(8, 8).t(), False),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_only_large_contiguous_cuda_tensors_take_the_staged_route(
        case, monkeypatch):
    make, staged = ROUTES[case]
    x = make()
    assert backend.staged_route(x) is staged
    if isinstance(x, torch.Tensor):  # the CPU device: the plain path
        def refuse(*a, **kw):
            raise AssertionError("copy_staged called off its route")

        monkeypatch.setattr(backend, "copy_staged", refuse)
        before = trace.counts().get("d2h.staged", 0)
        got = backend.download("x", x)
        assert np.array_equal(got, x.numpy())
        assert trace.counts().get("d2h.staged", 0) == before


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_download_on_the_staged_route_keeps_its_span_and_line(
        dtype, logger, monkeypatch):
    t = source(1000, dtype, True)
    plain = traced_download(logger, t)
    monkeypatch.setattr(backend, "staged_route", lambda t: True)
    monkeypatch.setattr(backend, "copy_staged", functools.partial(
        backend.copy_staged, piece=P, ring=3, threads=2))
    staged = traced_download(logger, t)
    for (out, span, counters, said), n_staged in ((plain, None), (staged, 1)):
        assert out.dtype == t.numpy().dtype and out.shape == tuple(t.shape)
        assert out.tobytes() == t.numpy().tobytes()
        assert span["attrs"] == {"what": "keys", "bytes": t.numpy().nbytes}
        assert span.get("counters", {}).get("d2h.staged") == n_staged
        assert counters["d2h_bytes"] == t.numpy().nbytes
        assert counters["d2h_copies"] == 1
        assert counters.get("d2h.staged") == n_staged
    assert staged[3] == plain[3] == [f"count: keys download {t.numpy().nbytes} B"]


def test_copy_staged_with_more_threads_than_cores_and_a_short_switch():
    """Slots handed between the queueing thread and many drain threads at
    a tiny piece: a slot refilled before its host copy is done would put
    a later piece's bytes in an earlier piece's place."""
    t = source(4000, torch.int64, False)
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for ring, threads in ((2, 16), (5, 32)):
            out = np.empty(t.shape, np.int64)
            backend.copy_staged(t, out, piece=7, ring=ring, threads=threads)
            assert out.tobytes() == t.numpy().tobytes()
    finally:
        sys.setswitchinterval(saved)
