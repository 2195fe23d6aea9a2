"""CPU tests of the benchmark, and its card tests (marker `card`), which
skip where no CUDA device is present.  Run from the root of a checkout:

    python -m pytest kmerbench/tests -q            # here: card tests skip
    python -m pytest kmerbench/tests -q -m card    # on the card's machine
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Small sizes at which the port runs on the CPU in seconds.
SMALL = {"config": {"genome_bp": 60_000}, "mix": {"coverage": 5}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device")


@pytest.fixture
def card():
    """The CUDA device a card test runs on; skips without one (decided
    here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="session")
def root(tmp_path_factory):
    """A checkout root whose BENCHMARK.json also holds the later cells
    (cells.LATER)."""
    from kmerbench.tests.cells import with_later

    return with_later(str(tmp_path_factory.mktemp("root")))


@pytest.fixture
def small():
    return {k: dict(v) for k, v in SMALL.items()}
