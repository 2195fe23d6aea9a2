"""The control (the reference in the program's place, one guarantee
broken) and each planted fault (the work a cell names skipped) have to
come out wrong in every cell, at a size a test holds."""

import pytest

from kmerbench import spec
from kmerbench.control import readings
from kmerbench.reference.check import LIMITS
from kmerbench.tests.cells import LATER

CELLS = ([w["name"] for w in spec.Spec().bench["workloads"]]
         + [w["name"] for w in LATER["workloads"]])


def _size(cell, small):
    if cell == "ecoli-k15.assembly":
        # A forward k-mer meets its reverse complement about
        # genome_bp / 4^15 of the time: some 40 pairs at 300 kb.
        small["config"]["genome_bp"] = 300_000
    return small


def _fails(reading):
    return any(v > LIMITS[n] for n, v in reading["numbers"].items())


def _read(cell, seed, device, small, root, program=False):
    got = readings(cell, seed, device, program, root=root,
                   overrides=_size(cell, small))
    assert _fails(got["control"]), got
    for name, fault in got["faults"].items():
        assert _fails(fault), (name, got)
    return got


@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_are_not_correct(cell, small, root):
    got = _read(cell, 3_000_000_021, "cpu", small, root, program=True)
    assert got["program"]["ok"] and not _fails(got["program"]), got


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(cell, small, root, card):
    _read(cell, 3_000_000_023, card, small, root)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_the_card(cell, small, root, card):
    import json

    from kmerbench.tests.test_kmerbench_run import run_cell

    rc, out, err = run_cell(cell, small, root, trace=1, device=card)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True, err
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
    bench = spec.Spec(root)
    want = {m["name"] for m in bench.metrics(bench.cell(cell), True)}
    assert set(line["metrics"]) == want, err
