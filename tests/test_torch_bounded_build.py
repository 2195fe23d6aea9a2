"""kmerset-build end to end with the graph front-end in its bounded mode
(ops/unitigs.bounded_unitig_succ), on the CPU: a seeded random genome of
2^17 bases written as the benchmark's assembly mix writes it, built at
k = 15 and 23 once at the host's budget (front-end in one shot) and once
with backend.memory_budget patched so that the count stays in one shot
and the front-end plans the bounded mode with 3 or more query chunks.
Each build's rows go to the host walk, or stay on the device for W1's
plain version (backend.walk_route taken for a CUDA device).  The bounded
dump must be byte-identical to the one-shot dump, pass the benchmark's
plain check, and trace each of its two passes once."""

import json
import logging

import pytest

from kmerbench import generate, spec
from kmerbench.reference import check
from kmerbench.window import quiet_cli_logger, run_job
from kmerset_tpu_torch.cli import kmerset_build
from kmerset_tpu_torch.ops import backend, unitigs
from kmerset_tpu_torch.utils import trace

GENOME_BP = 1 << 17
# Planning bytes per k-mer of the patched budget: above the count's 72 a
# window times the windows a k-mer (about 1.6 here: the 8 records with N
# runs repeat 80 kb of the genome), so the count runs in one shot, and
# under the 160 a k-mer of the front-end's one-shot ceiling, so the
# front-end runs bounded.
BUDGET_PER_KMER = 140
CASES = [(k, walk) for k in (15, 23) for walk in ("host", "device")]
IDS = [f"k{k}-{walk}" for k, walk in CASES]


def _line(job) -> dict:
    found = [m for _, m in job.lines if m.startswith(trace.PREFIX)]
    assert len(found) == 1, found
    return json.loads(found[0][len(trace.PREFIX):])


def _named(line, name):
    return [s for s in line["spans"] if s["name"] == name]


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    d = tmp_path_factory.mktemp("bounded")
    mix = spec.load_json(f"{spec.HERE}/mixes/assembly.json")
    genome = generate.genomes({"genome_bp": GENOME_BP}, 2_718_281_828)[0]
    path = str(d / "genome.fa")
    generate.write_records(path, genome, mix, generate.rng_of(2_718_281_828, 2))
    return path


@pytest.fixture(scope="module")
def builds(fasta, tmp_path_factory):
    """{(k, walk): {"one shot" | "bounded": (dump path, trace line,
    side_tables calls)}}, each build a traced kmerset-build main()."""
    d = tmp_path_factory.mktemp("dumps")
    log = logging.getLogger("kmerset")
    saved = log.handlers[:], log.level, log.propagate
    quiet_cli_logger(debug=True)
    out = {}
    try:
        for k, walk in CASES:
            with pytest.MonkeyPatch.context() as mp:
                calls = []
                real_tables = unitigs.side_tables
                mp.setattr(unitigs, "side_tables",
                           lambda *a, **kw: calls.append(1) or real_tables(*a, **kw))
                if walk == "device":
                    real_route = backend.walk_route
                    mp.setattr(backend, "WALK_MIN_KMERS", 1)
                    mp.setattr(backend, "walk_route",
                               lambda n, device: real_route(n, "cuda"))
                got = {}
                for name in ("one shot", "bounded"):
                    budget = backend.HOST_BUDGET  # read on every device
                    if name == "bounded":
                        budget = BUDGET_PER_KMER * _named(
                            got["one shot"][1], "front_end.plan")[0]["attrs"]["kmers"]
                    mp.setattr(backend, "memory_budget",
                               lambda device, b=budget: b)
                    dump = str(d / f"k{k}-{walk}-{name.replace(' ', '_')}.txt")
                    calls.clear()
                    job = run_job(kmerset_build.main, [
                        "--device", "cpu", "--debug", "--k", str(k),
                        "--cutoff", "1", "--out", dump, fasta])
                    assert job.ok, job.error
                    got[name] = (dump, _line(job), len(calls))
                out[(k, walk)] = got
    finally:
        log.handlers, log.propagate = saved[0], saved[2]
        log.setLevel(saved[1])
    return out


@pytest.mark.parametrize("k,walk", CASES, ids=IDS)
def test_the_bounded_plan_has_three_or_more_query_chunks(builds, k, walk):
    for name, mode in (("one shot", "one-shot"), ("bounded", "bounded")):
        (plan,) = _named(builds[(k, walk)][name][1], "front_end.plan")
        a = plan["attrs"]
        assert a["mode"] == mode and a["walk"] == walk, name
        assert a["query_chunks"] == -(-a["kmers"] // a["query_chunk"])
        if name == "bounded":
            assert a["query_chunks"] >= 3
            assert a["budget"] == BUDGET_PER_KMER * a["kmers"]
        else:
            assert a["query_chunks"] == 1 and a["query_chunk"] == a["kmers"]
    # The count stayed in one shot at the patched budget.
    (count,) = _named(builds[(k, walk)]["bounded"][1], "count.plan")
    assert count["attrs"]["chunks"] == 1


@pytest.mark.parametrize("k,walk", CASES, ids=IDS)
def test_the_bounded_dump_equals_the_one_shot_dump(builds, k, walk):
    dumps = []
    for name in ("one shot", "bounded"):
        with open(builds[(k, walk)][name][0], "rb") as f:
            dumps.append(f.read())
    assert dumps[0] and dumps[0] == dumps[1]


@pytest.mark.parametrize("k,walk", CASES, ids=IDS)
def test_the_bounded_dump_passes_the_benchmark_check(builds, fasta, k, walk):
    parts, numbers, stats = check.check_build(
        [fasta], builds[(k, walk)]["bounded"][0], k, 1, "cpu")
    assert sum(parts.values()) == 0, parts
    assert numbers["strings_per_unitig"] <= check.LIMITS["strings_per_unitig"]
    assert stats["kept"] > GENOME_BP // 2


@pytest.mark.parametrize("k,walk", CASES, ids=IDS)
def test_the_bounded_trace_holds_each_pass_once(builds, k, walk):
    """front_end.degrees and front_end.rows once each, inside
    front_end.device, with the plan's query chunks; those chunks ran (two
    side-table builds a chunk), and front_end.query_chunks counts them."""
    _, line, calls = builds[(k, walk)]["bounded"]
    (plan,) = _named(line, "front_end.plan")
    chunks = plan["attrs"]["query_chunks"]
    (device,) = _named(line, "front_end.device")
    for name in ("front_end.degrees", "front_end.rows"):
        (sp,) = _named(line, name)
        assert sp["attrs"] == {"chunks": chunks}, name
        assert sp["parent"] == device["id"], name
    degrees, rows = _named(line, "front_end.degrees")[0], _named(line, "front_end.rows")[0]
    assert degrees["end"] <= rows["start"]
    assert calls == 2 * chunks
    assert line["counters"]["front_end.query_chunks"] == 2 * chunks
    assert line["counters"]["front_end.bounded"] == 1
    assert line["counters"].get("walk.bounded", 0) == (walk == "device")
    assert line["counters"][f"walk.{walk}"] == 1
    # The host walk's rows come down a chunk at a time; W1's stay.
    downloads = _named(line, "front_end.download")
    assert len(downloads) == (chunks if walk == "host" else 0)


@pytest.mark.parametrize("k,walk", CASES, ids=IDS)
def test_one_shot_traces_neither_pass(builds, k, walk):
    _, line, calls = builds[(k, walk)]["one shot"]
    assert not _named(line, "front_end.degrees")
    assert not _named(line, "front_end.rows")
    assert calls == line["counters"]["front_end.query_chunks"] == 1
    assert "front_end.bounded" not in line["counters"]
