"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (configs/<config>.json) and a traffic mix
(mixes/<traffic>.json); every metric is read by a file of its own,
e2e/<name>.py for an end-to-end metric and layers/<name>.py for a
per-layer one, whose read(ctx) returns the number or None where it finds
nothing to read.  setup_s is the harness's own.  A metric belongs to a
cell where its "workloads" list names the cell, or where it has none.
"""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SETUP_METRIC = "setup_s"


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"kmerbench: no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                return load_json(os.path.join(self.root, c["file"]))
        raise SystemExit(f"kmerbench: no config {cell['config']!r}")

    def mix(self, cell: dict) -> dict:
        return load_json(os.path.join(HERE, "mixes", cell["traffic"] + ".json"))

    def resolve(self, workload: str, overrides=None):
        """(cell, config, mix) of a workload; `overrides` ({"config":
        {...}, "mix": {...}}, for tests at a small size) merged over the
        files."""
        cell = self.cell(workload)
        o = overrides or {}
        return (cell, {**self.config(cell), **o.get("config", {})},
                {**self.mix(cell), **o.get("mix", {})})

    def metrics(self, cell: dict, trace: bool) -> list:
        """The cell's metrics of the run's kind: end-to-end without the
        trace, per-layer with it."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(kind: str, name: str):
    """The read(ctx) function of e2e/<name>.py or layers/<name>.py."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"kmerbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
