"""The benchmark's view of the graph front-end's bounded mode: the
readers front_end_chunks.build and front_end_degrees_s.build on
hand-made job traces (the largest "query_chunks" of a job's
"front_end.plan" spans; the summed self time of its "front_end.degrees"
spans; None where a job has none), the rice-k23.assembly cell as
BENCHMARK.json and its configuration state it, and a whole run of the
cell at a small genome with the budget patched so that the front-end
runs bounded.  The run is a child process: the harness refuses to run
beside the JAX package, which this suite's conftest imports."""

import json
import os
import subprocess
import sys

import pytest

from kmerbench import progtrace, spec
from kmerbench.window import Job, Window

CHUNKS = spec.reader("layers", "front_end_chunks.build")
DEGREES = spec.reader("layers", "front_end_degrees_s.build")
CELL = "rice-k23.assembly"


def _job(t, plans=(), degrees=()):
    """A job whose trace line holds a root, one "front_end.plan" span per
    attrs dict of `plans` and, inside a "front_end.device" span, one
    "front_end.degrees" span per (start, end) offset pair of `degrees`,
    each with a copy below it that its self time leaves out."""
    spans = [{"name": "cli.kmerset_build", "id": 1, "parent": None, "tid": 1,
              "start": t, "end": t + 20.0},
             {"name": "front_end.device", "id": 2, "parent": 1, "tid": 1,
              "start": t + 1.0, "end": t + 19.0, "attrs": {"bounded": True}}]
    for attrs in plans:
        spans.append({"name": "front_end.plan", "id": len(spans) + 1,
                      "parent": 1, "tid": 1, "start": t + 0.5,
                      "end": t + 0.5001, "attrs": attrs})
    for lo, hi in degrees:
        spans.append({"name": "front_end.degrees", "id": len(spans) + 1,
                      "parent": 2, "tid": 1, "start": t + lo, "end": t + hi,
                      "attrs": {"chunks": 5}})
        spans.append({"name": "copy.d2h", "id": len(spans) + 1,
                      "parent": len(spans), "tid": 1, "start": t + lo,
                      "end": t + lo + 0.125, "attrs": {"bytes": 8}})
    line = progtrace.PREFIX + json.dumps({"spans": spans, "counters": {}})
    return Job(t, t + 20.0, 20.0, True, [(t + 20.0, line)])


def _plan(chunks=None, mode="bounded"):
    attrs = {"kmers": 372_000_000, "ceiling": 254_000_000,
             "budget": 40_700_000_000, "mode": mode, "walk": "device"}
    if chunks is not None:
        attrs.update(query_chunk=-(-372_000_000 // chunks), query_chunks=chunks)
    return attrs


class Ctx:
    def __init__(self, kind, jobs):
        self.kind = kind
        self.window = Window(jobs, None, jobs[0].start, jobs[-1].end)

    @property
    def jobs(self):
        return self.window.jobs


def test_the_query_chunks_of_the_plan():
    jobs = [_job(0.0, plans=[_plan(5)]), _job(30.0, plans=[_plan(5)])]
    got = CHUNKS(Ctx("build", jobs))
    assert got == 5.0 and isinstance(got, float)
    one_shot = [_job(0.0, plans=[_plan(1, "one-shot")])]
    assert CHUNKS(Ctx("build", one_shot)) == 1.0


def test_the_largest_query_chunks_of_two_plans():
    assert CHUNKS(Ctx("build", [_job(0.0, plans=[_plan(1), _plan(6)])])) == 6.0
    assert CHUNKS(Ctx("build", [_job(0.0, plans=[_plan(4), _plan(2)])])) == 4.0


def test_a_plan_without_the_attribute_reads_nothing():
    assert CHUNKS(Ctx("build", [_job(0.0, plans=[_plan()])])) is None
    assert CHUNKS(Ctx("build", [_job(0.0)])) is None
    mixed = [_job(0.0, plans=[_plan(5)]), _job(30.0, plans=[_plan()])]
    assert CHUNKS(Ctx("build", mixed)) is None
    assert CHUNKS(Ctx("compress", [_job(0.0, plans=[_plan(5)])])) is None
    no_line = Job(0.0, 1.0, 1.0, True, [(1.0, "constructing kmer_counter")])
    assert CHUNKS(Ctx("build", [no_line])) is None


def test_the_degrees_passes_are_summed_less_what_lies_below():
    jobs = [_job(0.0, plans=[_plan(5)], degrees=[(1.0, 2.5)]),
            _job(30.0, plans=[_plan(5)], degrees=[(1.0, 1.5), (2.0, 2.75)])]
    # Self times 1.375 and 0.375 + 0.625: the mean of 1.375 and 1.0.
    assert DEGREES(Ctx("build", jobs)) == pytest.approx(1.1875)


def test_no_degrees_pass_reads_nothing():
    assert DEGREES(Ctx("build", [_job(0.0, plans=[_plan(1, "one-shot")])])) is None
    mixed = [_job(0.0, degrees=[(1.0, 2.0)]), _job(30.0)]
    assert DEGREES(Ctx("build", mixed)) is None
    assert DEGREES(Ctx("compress", [_job(0.0, degrees=[(1.0, 2.0)])])) is None
    no_line = Job(0.0, 1.0, 1.0, True, [(1.0, "constructing kmer_counter")])
    assert DEGREES(Ctx("build", [no_line])) is None


def test_the_rice_cell_resolves_at_its_published_length():
    s = spec.Spec()
    cell, config, mix = s.resolve(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "rice-k23", "assembly", 1)
    assert mix == s.mix({"traffic": "assembly"})
    assert config["genome_bp"] == sum(config["assumed"]["chromosome_bp"].values())
    assert config["genome_bp"] == 373_245_519
    assert len(config["assumed"]["chromosome_bp"]) == 12
    assert (config["k"], config["canonical"], config["reduced"]) == (23, True, [])
    (entry,) = [c for c in s.bench["configs"] if c["name"] == "rice-k23"]
    assert entry["source"] == config["source"] and entry["reduced"] == []


def test_the_rice_cell_reports_the_front_end_metrics():
    s = spec.Spec()
    cell = s.cell(CELL)
    assert {m["name"] for m in s.metrics(cell, False)} == {
        "build_mbp_per_s", "setup_s"}
    assert {m["name"] for m in s.metrics(cell, True)} == {
        "count_s.build", "front_end_s.build", "host_spss_s.build",
        "device_idle_pct.build", "count_host_s.build", "file_io_s.build",
        "d2h_gbps.build", "front_end_headroom_pct.build",
        "front_end_chunks.build", "front_end_degrees_s.build"}
    for name in ("front_end_chunks.build", "front_end_degrees_s.build"):
        (m,) = [m for m in s.bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["layer"] == "graph front-end"


# A genome at which the assembly mix's 8 records with N runs (80 kb)
# leave about 1.4 windows a k-mer, and a budget of 130 B a base: the
# count in one shot (72 B a window), the front-end above its one-shot
# ceiling (160 B a k-mer) in 3 query chunks.
SMALL_BP = 200_000
_RUN = """
import sys
from kmerset_tpu_torch.ops import backend
backend.memory_budget = lambda device: {budget}
from kmerbench import harness
sys.exit(harness.main(["--workload", "{cell}", "--seed", "4100000017",
                       "--seconds", "1", "--trace", "{trace}"],
                      require_chip=False, device="cpu",
                      overrides={{"config": {{"genome_bp": {bp}}}}}))
"""


@pytest.mark.parametrize("trace", [0, 1])
def test_the_rice_cell_runs_bounded_and_correct(trace):
    env = {k: v for k, v in os.environ.items()
           if k not in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR")}
    env["PYTHONPATH"] = spec.ROOT
    p = subprocess.run(
        [sys.executable, "-c", _RUN.format(budget=130 * SMALL_BP, cell=CELL,
                                           trace=trace, bp=SMALL_BP)],
        cwd=spec.ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0, p.stderr[-4000:]
    assert line["compared"]["errors"]["value"] == 0
    assert line["compared"]["strings_per_unitig"]["value"] <= 1.0
    metrics = {n: m["value"] for n, m in line["metrics"].items()}
    if not trace:
        assert set(metrics) == {"build_mbp_per_s", "setup_s"}
        return
    assert metrics["front_end_chunks.build"] >= 3.0
    assert metrics["front_end_degrees_s.build"] > 0.0
    assert metrics["front_end_headroom_pct.build"] < 0.0
