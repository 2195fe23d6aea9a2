"""BENCHMARK.json and the files it names: every cell finds its
configuration and mix, every metric its reader, and every per-layer
metric's cells report the end-to-end metric it moves."""

import os

import pytest

from kmerbench import spec

BENCH = spec.Spec()


@pytest.mark.parametrize("cell", BENCH.bench["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_files(cell):
    config, mix = BENCH.config(cell), BENCH.mix(cell)
    assert {"k", "genome_bp", "canonical"} <= set(config)
    assert mix["job"] in ("build", "compress", "decompress")
    names = {m["name"] for m in BENCH.metrics(cell, False)}
    assert spec.SETUP_METRIC in names and len(names) >= 2
    assert BENCH.metrics(cell, True)


@pytest.mark.parametrize("group,kind", [("end_to_end", "e2e"), ("per_layer", "layers")])
def test_every_metric_has_a_reader(group, kind):
    for m in BENCH.bench[group]:
        if m["name"] != spec.SETUP_METRIC:
            assert callable(spec.reader(kind, m["name"])), m["name"]


def test_moves_are_reported_where_read():
    e2e = {m["name"]: m for m in BENCH.bench["end_to_end"]}
    for m in BENCH.bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_config_files_lie_under_paths():
    for c in BENCH.bench["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in BENCH.bench["paths"]))
        assert os.path.exists(os.path.join(spec.ROOT, c["file"]))
