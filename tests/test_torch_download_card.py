"""The staged route of ops/backend.download on the card: the pinned ring
against t.cpu().numpy() at 2^28 + 3 int64 keys and at an odd uint8 size,
d2h.staged once a large download and never for a small one, the copy.d2h
span and the count's debug line as on the plain route, and a build whose
dump is byte-identical on both routes.  Card tests (marker `card`) skip
without a CUDA device.  This file imports no JAX, so that it runs where
JAX is not installed, past tests/conftest.py:

    python -m pytest --noconftest -m card tests/test_torch_download_card.py -q
"""

import numpy as np
import pytest
import torch

from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.utils import trace
from tests.test_torch_download import logger, traced_download  # noqa: F401

SEED = 1_618_033_988
SIZES = {"int64_2p28_plus_3": ((1 << 28) + 3, torch.int64),
         "uint8_odd": ((45 << 20) + 7, torch.uint8)}


@pytest.fixture
def card():
    """The CUDA device a card test runs on; skips without one (decided
    here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def on_card(n: int, dtype) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(SEED)
    hi = 1 << 62 if dtype == torch.int64 else 256
    return torch.randint(0, hi, (n,), generator=g, device="cuda",
                         dtype=torch.int64).to(dtype)


def _staged() -> int:
    return trace.counts().get("d2h.staged", 0)


@pytest.mark.card
@pytest.mark.parametrize("size", sorted(SIZES))
def test_the_staged_route_equals_cpu_numpy(card, size):
    n, dtype = SIZES[size]
    t = on_card(n, dtype)
    assert backend.staged_route(t)
    before = _staged()
    got = backend.download("x", t)
    assert _staged() - before == 1
    want = t.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(), (1000,), ((4 << 20) - 1,), (2, 8 << 20)])
def test_small_or_strided_downloads_are_not_staged(card, shape):
    t = on_card(int(np.prod(shape)), torch.int64).reshape(shape)
    if len(shape) == 2:
        t = t.t()  # 128 MiB, not contiguous
    before = _staged()
    got = backend.download("x", t)
    assert _staged() == before
    assert np.array_equal(got, t.cpu().numpy())


@pytest.mark.card
def test_the_span_and_debug_line_are_those_of_the_plain_route(
        card, logger, monkeypatch):  # noqa: F811
    t = on_card(80 << 20, torch.int64)
    staged = traced_download(logger, t)
    monkeypatch.setattr(backend, "staged_route", lambda t: False)
    plain = traced_download(logger, t)
    assert np.array_equal(staged[0], plain[0])
    assert staged[1]["attrs"] == plain[1]["attrs"] == {
        "what": "keys", "bytes": t.numel() * 8}
    assert staged[1]["counters"]["d2h.staged"] == 1
    assert "d2h.staged" not in plain[1].get("counters", {})
    for side in (staged, plain):
        assert side[2]["d2h_bytes"] == t.numel() * 8
        assert side[2]["d2h_copies"] == 1
    assert staged[3] == plain[3] == [f"count: keys download {t.numel() * 8} B"]


@pytest.mark.card
def test_a_build_is_byte_identical_on_both_routes(card, tmp_path, monkeypatch):
    from kmerset_tpu_torch.cli import kmerset_build

    codes = np.random.default_rng(SEED).integers(0, 4, 1 << 26, dtype=np.uint8)
    text = np.frombuffer(b"ACGT", dtype=np.uint8)[codes].tobytes()
    fasta = tmp_path / "genome.fa"
    with open(fasta, "wb") as f:
        for i, at in enumerate(range(0, len(text), 10_000)):
            f.write(b">r%d\n%s\n" % (i, text[at : at + 10_000]))

    def build(out: str):
        before = _staged()
        kmerset_build.main(["--device", card, "--k", "23", "--out", out,
                            str(fasta)])
        with open(out, "rb") as f:
            return f.read(), _staged() - before

    got, staged = build(str(tmp_path / "staged.txt"))
    assert staged >= 2  # the keys and the uint8 counts at least
    monkeypatch.setattr(backend, "staged_route", lambda t: False)
    want, staged = build(str(tmp_path / "plain.txt"))
    assert staged == 0
    assert got == want and len(got) > 1 << 24
