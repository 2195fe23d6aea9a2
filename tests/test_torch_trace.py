"""The port's tracer (kmerset_tpu_torch/utils/trace.py): spans, their
parents across threads, counters, the off path, and the one "trace: "
line of a CLI call, as kmerbench/progtrace.py reads it, beside the debug
lines that kmerbench/spans.py reads."""

import json
import logging
import threading

import numpy as np
import pytest

from kmerbench import progtrace, spec
from kmerbench import spans as log_spans
from kmerbench.reference import check
from kmerbench.window import Job, run_job
from kmerset_tpu_torch.ops import backend, compact, pack
from kmerset_tpu_torch.utils import trace

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@pytest.fixture
def logger():
    """The "kmerset" logger at debug level with a capture of its records;
    its handlers, level and propagation restored afterwards."""
    log = logging.getLogger("kmerset")
    saved = log.handlers[:], log.level, log.propagate
    lines = []

    class Capture(logging.Handler):
        def emit(self, record):
            lines.append((record.created, record.getMessage()))

    log.handlers = [Capture(logging.DEBUG)]
    log.setLevel(logging.DEBUG)
    log.propagate = False
    try:
        yield lines
    finally:
        log.handlers, log.propagate = saved[0], saved[2]
        log.setLevel(saved[1])


def _line(lines) -> dict:
    found = [m for _, m in lines if m.startswith(trace.PREFIX)]
    assert len(found) == 1, found
    return json.loads(found[0][len(trace.PREFIX):])


def test_nesting_parents_and_threads(logger):
    seen = {}

    def worker():
        with trace.span("t.worker") as s:
            seen["tid"] = threading.get_native_id()
            with trace.span("t.inner", n=3):
                pass
        seen["id"] = s.id

    with trace.root("cli.test", True):
        with trace.span("a.outer", bytes=5):
            with trace.span("a.inner"):
                th = threading.Thread(target=worker)
                th.start()
                th.join(timeout=30)
        assert not th.is_alive()
    got = {s["name"]: s for s in _line(logger)["spans"]}
    root = got["cli.test"]
    assert root["parent"] is None
    assert got["a.outer"]["parent"] == root["id"]
    assert got["a.outer"]["attrs"] == {"bytes": 5}
    assert got["a.inner"]["parent"] == got["a.outer"]["id"]
    # A worker thread with no span open takes the call's root.
    assert got["t.worker"]["parent"] == root["id"]
    assert got["t.inner"]["parent"] == got["t.worker"]["id"]
    assert got["t.worker"]["tid"] == seen["tid"] != root["tid"]
    for s in got.values():
        assert root["start"] <= s["start"] <= s["end"] <= root["end"]
    assert got["a.outer"]["start"] <= got["a.inner"]["start"]
    assert got["a.inner"]["end"] <= got["a.outer"]["end"]
    assert len({s["id"] for s in got.values()}) == len(got)


def test_counters_go_to_the_innermost_span(logger):
    def worker():
        trace.add("c.bytes", 7)  # no span open here: the root's

    with trace.root("cli.test", True):
        trace.add("c.bytes", 1)
        with trace.span("a.outer"):
            trace.add("c.bytes", 10)
            with trace.span("a.inner"):
                trace.add("c.bytes", 100)
                trace.add("c.copies")
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
    out = _line(logger)
    got = {s["name"]: s.get("counters", {}) for s in out["spans"]}
    assert got["cli.test"] == {"c.bytes": 8}
    assert got["a.outer"] == {"c.bytes": 10}
    assert got["a.inner"] == {"c.bytes": 100, "c.copies": 1}
    assert out["counters"]["c.bytes"] == 118
    assert out["counters"]["c.copies"] == 1


def test_off_records_nothing_and_returns_the_shared_noop(logger):
    before = trace.counts().get("c.off", 0)
    with trace.root("cli.test", False):
        s = trace.span("a.x", bytes=1)
        assert s is trace.NOOP and trace.span("a.y") is trace.NOOP
        with s as entered:
            entered.set(more=2)
            trace.add("c.off", 3)
        with trace.timed("a.z") as t:
            pass
        assert t.seconds >= 0.0
    assert not [m for _, m in logger if m.startswith(trace.PREFIX)]
    assert trace.counts()["c.off"] == before + 3
    assert trace._current is None


def test_the_root_logs_once_even_when_the_call_raises(logger):
    with pytest.raises(SystemExit):
        with trace.root("cli.test", True):
            with trace.span("a.x"):
                raise SystemExit(1)
    assert [s["name"] for s in _line(logger)["spans"]] == ["cli.test", "a.x"]
    assert trace._current is None


def test_the_line_round_trips_through_progtrace(logger):
    with trace.root("cli.test", True):
        with trace.span("io.load", file="x", bytes=4):
            trace.add("h2d_bytes", 4)
    job = Job(0.0, 1.0, 1.0, True, list(logger))
    want = _line(logger)
    assert progtrace.job_trace(job) == want
    assert progtrace.spans(job) == want["spans"]
    assert progtrace.counters(job) == want["counters"]
    assert progtrace.counters(Job(0.0, 1.0, 1.0, True, [])) is None


def test_the_chunked_count_spans_its_chunks_and_logs_its_downloads(logger):
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 4000).astype(np.uint8)
    offsets = np.array([0, 1500, 4000], np.int64)
    with trace.root("cli.test", True):
        backend.device_count_chunked(codes, offsets, 15, True, device="cpu",
                                     chunk_windows=1000)
    spans = _line(logger)["spans"]
    chunked = [s for s in spans if s["name"] == "count.chunked"]
    devices = [s for s in spans if s["name"] == "count.device"]
    assert len(chunked) == 1 and len(devices) >= 4
    assert chunked[0]["attrs"] == {"chunks": len(devices)}
    assert {s["parent"] for s in devices} == {chunked[0]["id"]}
    # Each chunk's keys and counts: a copy.d2h span and the count's line.
    lines = [m for _, m in logger if m.startswith("count: ")
             and " download " in m]
    assert len(lines) == 2 * len(devices)
    d2h = [s for s in spans if s["name"] == "copy.d2h"
           and s["attrs"]["what"] in ("keys", "counts")]
    assert len(d2h) == len(lines)


def test_the_launch_globals_are_gone():
    assert not hasattr(pack, "launches") and not hasattr(pack, "launches_pair")
    assert not hasattr(compact, "launches")


# -- the CLIs on the CPU ------------------------------------------------------


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    """A 20 kb genome as reads of both strands, and 3 strains of it."""
    rng = np.random.default_rng(17)
    d = tmp_path_factory.mktemp("trace")
    genome = rng.integers(0, 4, 20_000, dtype=np.uint8)
    reads = []
    for _ in range(200):
        s = int(rng.integers(0, 19_700))
        r = genome[s: s + 300]
        reads.append(3 - r[::-1] if rng.random() < 0.5 else r)
    path = d / "reads.fa"
    path.write_bytes(b"".join(b">r%d\n%s\n" % (i, _BASES[r].tobytes())
                              for i, r in enumerate(reads)))
    strains = []
    for j in range(3):
        g = genome.copy()
        at = rng.integers(0, g.size, 40)
        g[at] = (g[at] + 1 + j) % 4
        p = d / f"s{j}.fa"
        p.write_bytes(b">s\n" + _BASES[g].tobytes() + b"\n")
        strains.append(str(p))
    return str(path), strains, d


def _cli_job(main, argv, logger) -> Job:
    del logger[:]
    job = run_job(main, argv)
    job.lines = list(logger)
    assert job.ok, job.error
    return job


_LOG_PATTERNS = (log_spans._PAIR, log_spans._FRONT_END, log_spans._SKETCH,
                 check._HASH_SIZE, check._EDGE,
                 *(rx for _, rx in log_spans._STATED))


def _check_readers_ignore_the_line(job):
    """kmerbench/spans.py and the reference's log readers read the same
    spans with and without the trace line, which matches none of their
    patterns."""
    rest = [(t, m) for t, m in job.lines if not m.startswith(trace.PREFIX)]
    assert len(rest) == len(job.lines) - 1
    assert log_spans.stated(job.lines) == log_spans.stated(rest)
    for name in log_spans.PHASES:
        assert log_spans.pairs(job.lines, name) == log_spans.pairs(rest, name)
    assert log_spans.sketch_seconds(job.lines) == log_spans.sketch_seconds(rest)
    assert check.logged_sets(job.lines) == check.logged_sets(rest)
    line = next(m for _, m in job.lines if m.startswith(trace.PREFIX))
    assert not line.startswith("failed")
    for rx in _LOG_PATTERNS:
        assert not rx.search(line), rx.pattern


def _check_copies(out):
    for way in ("d2h", "h2d"):
        copies = [s for s in out["spans"] if s["name"] == f"copy.{way}"]
        assert copies, way
        assert out["counters"][f"{way}_bytes"] == sum(
            s["attrs"]["bytes"] for s in copies)
        assert out["counters"][f"{way}_copies"] == len(copies)


def test_build_cli_logs_one_trace_line_with_every_layer(fastas, logger, tmp_path):
    from kmerset_tpu_torch.cli import kmerset_build

    reads, _, _ = fastas
    argv = ["--device", "cpu", "--debug", "--k", "15", "--cutoff", "2",
            "--check", "--out", str(tmp_path / "out.txt"), reads]
    job = _cli_job(kmerset_build.main, argv, logger)
    out = _line(job.lines)
    names = {s["name"] for s in out["spans"]}
    assert {"cli.kmerset_build", "count.parse", "count.stage", "count.device",
            "count.filter", "front_end.device", "front_end.download",
            "spss.chain_walk", "spss.emission", "spss.path_cover",
            "compact.deferred_build", "spss.decode", "io.dump", "copy.h2d",
            "copy.d2h"} <= names
    build = next(s for s in out["spans"] if s["name"] == "compact.deferred_build")
    assert build["attrs"]["kmers"] > 0
    _check_copies(out)
    _check_readers_ignore_the_line(job)
    assert progtrace.per_job(_Ctx("build", [job]), "build",
                             progtrace.file_io_seconds) > 0
    # Untraced (the logger at info level, no --debug): no line.
    logging.getLogger("kmerset").setLevel(logging.INFO)
    job = _cli_job(kmerset_build.main, [a for a in argv if a != "--debug"],
                   logger)
    assert not [m for _, m in job.lines if m.startswith(trace.PREFIX)]


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_the_dump_and_load_count_the_route_of_their_text_codec(
    route, fastas, logger, tmp_path, monkeypatch
):
    """One "lines.<route>" counter inside a build's io.dump and one inside
    a load's io.load; "numpy" where the codec's library is forced absent."""
    from kmerset_tpu_torch.cli import kmerset_build
    from kmerset_tpu_torch.core import native
    from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact

    if route == "numpy":
        monkeypatch.setattr(native, "get_lines_lib", lambda: None)
    reads, _, _ = fastas
    path = str(tmp_path / "out.txt")
    out = _line(_cli_job(kmerset_build.main, [
        "--device", "cpu", "--debug", "--k", "15", "--out", path, reads],
        logger).lines)
    del logger[:]
    with trace.root("cli.test", True):
        KmerSetCompact.load(15, path, device="cpu")
    loaded = _line(logger)
    other = {"native": "numpy", "numpy": "native"}[route]
    for got, name in ((out, "io.dump"), (loaded, "io.load")):
        assert got["counters"][f"lines.{route}"] == 1
        assert f"lines.{other}" not in got["counters"]
        (sp,) = [s for s in got["spans"] if s["name"] == name]
        assert sp["counters"][f"lines.{route}"] == 1


class _Ctx:
    def __init__(self, kind, jobs):
        self.kind, self.jobs, self.trace = kind, jobs, None


def test_compress_cli_logs_one_trace_line_with_every_layer(fastas, logger):
    from kmerset_tpu_torch.cli import kmerset_build, kmerset_multiple_compress

    _, strains, d = fastas
    sets = []
    for i, fa in enumerate(strains):
        sets.append(str(d / f"set{i}.txt"))
        _cli_job(kmerset_build.main, ["--device", "cpu", "--k", "15", "--out",
                                      sets[-1], fa], logger)
    job = _cli_job(kmerset_multiple_compress.main, [
        "--device", "cpu", "--debug", "--k", "15", "--seed", "5", "--out",
        str(d / "M"), "--out_graph", str(d / "M.dot"), *sets], logger)
    out = _line(job.lines)
    names = {s["name"] for s in out["spans"]}
    assert {"cli.kmerset_multiple_compress", "io.load", "kss.construct",
            "kss.sample", "kss.pack_in_memory", "kss.sketch_build", "kss.weigh",
            "kss.algebra", "kss.split", "compact.deferred_build", "spss.decode",
            "front_end.device", "spss.chain_walk", "io.dump", "io.dump_graph",
            "copy.h2d", "copy.d2h"} <= names
    loads = [s for s in out["spans"] if s["name"] == "io.load"]
    assert sorted(s["attrs"]["file"] for s in loads) == sorted(sets)
    assert all(s["attrs"]["bytes"] > 0 for s in loads)
    # One decode a load and one encode a set file (meta.txt has no codec).
    dumps = [s for s in out["spans"] if s["name"] == "io.dump"
             and not s["attrs"]["file"].endswith("meta.txt")]
    for sp in loads + dumps:
        assert sp["counters"]["lines.native"] == 1
    assert out["counters"]["lines.native"] == len(loads) + len(dumps)
    assert "lines.numpy" not in out["counters"]
    _check_copies(out)
    _check_readers_ignore_the_line(job)
    assert log_spans.sketch_seconds(job.lines) is not None
    ctx = _Ctx("compress", [job])
    assert progtrace.per_job(ctx, "compress", progtrace.multiset_self_seconds) > 0
    assert progtrace.per_job(ctx, "compress", progtrace.file_io_seconds) > 0


def _count_build(reads, logger, tmp_path, monkeypatch, chunks):
    """A traced kmerset-build of `reads` at k = 19 and cutoff 2 whose
    count takes `chunks` halo chunks (1: one shot, at the CPU's budget;
    more: the budget patched to that many chunks of the ceiling)."""
    from kmerset_tpu_torch.cli import kmerset_build

    k = 19
    if chunks > 1:
        codes = sum(len(line) for line in open(reads).read().split("\n")
                    if line and not line.startswith(">"))
        ceiling = -(-(codes - k + 1) // chunks)
        monkeypatch.setattr(backend, "memory_budget", lambda device:
                            ceiling * backend.count_bytes_per_window(k))
    job = _cli_job(kmerset_build.main, [
        "--device", "cpu", "--debug", "--k", str(k), "--cutoff", "2",
        "--out", str(tmp_path / f"out{chunks}.txt"), reads], logger)
    return job, _line(job.lines)["spans"]


def test_a_chunked_build_traces_its_count_plan_and_merge(fastas, logger,
                                                         tmp_path, monkeypatch):
    """Above the one-shot ceiling the count's plan span states its 3
    chunks and the numbers of its debug line, and the host merge states
    the runs' keys in and the merged keys out."""
    reads, _, _ = fastas
    job, spans = _count_build(reads, logger, tmp_path, monkeypatch, 3)
    plans = [s for s in spans if s["name"] == "count.plan"]
    assert len(plans) == 1
    p = plans[0]["attrs"]
    assert set(p) == {"windows", "chunks", "chunk", "ceiling", "budget"}
    assert p["chunks"] == 3 and p["chunk"] == p["ceiling"] < p["windows"]
    assert -(-p["windows"] // p["ceiling"]) == 3
    assert p["ceiling"] == p["budget"] // backend.count_bytes_per_window(19)
    line = (f"count: {p['windows']} windows in 3 chunk(s) of at most "
            f"{p['chunk']} (ceiling {p['ceiling']}, budget {p['budget']})")
    assert line in [m for _, m in job.lines]
    merges = [s for s in spans if s["name"] == "count.merge"]
    assert len(merges) == 1
    m = merges[0]["attrs"]
    assert m["chunks"] == 3 and m["keys_in"] >= m["keys_out"] > 0
    devices = [s for s in spans if s["name"] == "count.device"]
    assert m["keys_in"] == sum(s["attrs"]["kmers"] for s in devices)
    assert "front_end.upload" in {s["name"] for s in spans}
    ctx = _Ctx("build", [job])
    assert spec.reader("layers", "count_chunks.build")(ctx) == 3.0
    assert spec.reader("layers", "count_merge_s.build")(ctx) > 0


def test_a_one_shot_build_traces_one_chunk_and_no_merge(fastas, logger,
                                                        tmp_path, monkeypatch):
    reads, _, _ = fastas
    job, spans = _count_build(reads, logger, tmp_path, monkeypatch, 1)
    plans = [s["attrs"] for s in spans if s["name"] == "count.plan"]
    assert len(plans) == 1
    assert plans[0]["chunks"] == 1 and plans[0]["chunk"] == plans[0]["windows"]
    assert plans[0]["ceiling"] >= plans[0]["windows"]
    assert not [s for s in spans if s["name"] == "count.merge"]
    assert "front_end.upload" not in {s["name"] for s in spans}
    ctx = _Ctx("build", [job])
    assert spec.reader("layers", "count_chunks.build")(ctx) == 1.0
    assert spec.reader("layers", "count_merge_s.build")(ctx) is None
