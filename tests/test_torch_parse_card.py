"""Kernel P1 on the card: the FASTA parse and pack against the plain
version (ops/parse.py) on the fuzzed texts of tests/test_torch_parse.py
and at the FASTA of the benchmark's reads, chr1 and dmel cells; then
kmerset-build of the reads and dmel cells' inputs (one shot, and three
halo chunks) on the device route and on the host route: launch.P1 and
parse.device once a build on the first, parse.host once on the second,
the dumps byte-identical.  Card tests (marker `card`) skip without a CUDA
device.  This file imports no JAX, so that it runs where JAX is not
installed, past tests/conftest.py:

    python -m pytest --noconftest -m card tests/test_torch_parse_card.py -q
"""

import json
import os

import numpy as np
import pytest
import torch

from kmerset_tpu_torch.ops import backend, parse
from kmerset_tpu_torch.utils import trace
from tests.test_torch_parse import CASES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (configuration, mix, k, cutoff) of kmerbench/configs and kmerbench/mixes.
SHAPES = {"reads": ("ecoli-k15", "reads", 15, 4),
          "chr1": ("chr1-k23", "assembly", 23, 1),
          "dmel": ("dmel-k19", "reads10x", 19, 2)}
SEED = 2_718_281_828


@pytest.fixture
def card():
    """The CUDA device a card test runs on; skips without one (decided
    here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="module")
def cell_fasta(tmp_path_factory):
    """The FASTA of a cell's shape (SHAPES), written once a module."""
    from kmerbench import generate

    made = {}

    def make(shape: str) -> str:
        if shape not in made:
            config, mix, _, _ = SHAPES[shape]

            def load(name):
                with open(os.path.join(ROOT, "kmerbench", name)) as f:
                    return json.load(f)

            (made[shape],), _ = generate.write_fastas(
                load(f"configs/{config}.json"), load(f"mixes/{mix}.json"), SEED,
                str(tmp_path_factory.mktemp(shape)))
        return made[shape]

    return make


def _outcome(fn):
    try:
        codes, offsets = fn()
    except ValueError as e:
        return None, None, str(e)
    return parse.pack(codes).cpu(), offsets.cpu(), None


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CASES))
def test_p1_equals_the_plain_version_on_the_fuzzed_texts(card, name):
    data = CASES[name]
    buf = torch.tensor(np.frombuffer(data, dtype=np.uint8))
    got = _outcome(lambda: parse.parse(buf.to(card)))
    want = _outcome(lambda: parse.parse_plain(buf))
    assert got[2] == want[2]
    if want[2] is None:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_p1_equals_the_plain_version_at_the_cells_shapes(card, cell_fasta, shape):
    buf = backend.upload_file(cell_fasta(shape), card)
    before = trace.counts().get("launch.P1", 0)
    codes, offsets = parse.parse(buf)
    assert trace.counts().get("launch.P1", 0) - before == 1
    want_codes, want_offsets = parse.parse_plain(buf)
    assert torch.equal(codes, want_codes) and torch.equal(offsets, want_offsets)
    del want_codes, want_offsets
    for at in (0, 1, 585_791_261 % codes.shape[0]):
        assert torch.equal(parse.pack(codes[at:]), parse.pack_plain(codes[at:]))


@pytest.mark.card
@pytest.mark.parametrize("shape", ["reads", "dmel"])
def test_a_build_on_the_device_route_equals_the_host_route(
        card, cell_fasta, tmp_path, monkeypatch, shape):
    from kmerset_tpu_torch.cli import kmerset_build

    fasta = cell_fasta(shape)
    _, _, k, cutoff = SHAPES[shape]
    chunks = 3 if shape == "dmel" else 1  # the cells' plans on one card

    def build(out: str):
        before = trace.counts()
        kmerset_build.main(["--device", card, "--k", str(k), "--cutoff",
                            str(cutoff), "--out", out, fasta])
        now = trace.counts()
        with open(out, "rb") as f:
            return f.read(), {c: now.get(c, 0) - before.get(c, 0) for c in (
                "launch.P1", "launch.P1.pack", "parse.device", "parse.host")}

    got, moved = build(str(tmp_path / "device.txt"))
    assert moved == {"launch.P1": 1, "launch.P1.pack": chunks,
                     "parse.device": 1, "parse.host": 0}
    monkeypatch.setattr(backend, "parse_route", lambda *a: False)
    want, moved = build(str(tmp_path / "host.txt"))
    assert moved == {"launch.P1": 0, "launch.P1.pack": 0, "parse.device": 0,
                     "parse.host": 1}
    assert got == want and len(got) > 1 << 20
