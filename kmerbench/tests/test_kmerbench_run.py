"""Whole runs of each cell at a small size on the CPU (the look for a
chip skipped): the last line's shape, `correct` on sound runs, and
`correct` false with the timed path broken underneath, once for each
fault a cell can have.  The cells are BENCHMARK.json's and those kept
for later (cells.LATER)."""

import contextlib
import io
import json
import os
import shutil

import numpy as np
import pytest

from kmerbench import harness, spec
from kmerbench.reference import check
from kmerbench.tests.cells import LATER

CELLS = ([w["name"] for w in spec.Spec().bench["workloads"]]
         + [w["name"] for w in LATER["workloads"]])


def run_cell(cell, small, root, trace=0, device="cpu", seconds=None,
             seed=3_000_000_019):
    seconds = seconds or (4.0 if cell.startswith("pan16") else 1.0)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace)],
                          require_chip=False, device=device, root=root,
                          overrides=small)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_sound_run_prints_the_contract_line(cell, trace, small, root):
    rc, out, err = run_cell(cell, small, root, trace)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    compared = line["compared"]
    assert list(compared)[0] == "errors"
    assert compared["errors"] == {"value": 0, "limit": 0}
    assert all(c["value"] <= c["limit"] for c in compared.values()), compared
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 2
    tail = err.strip().splitlines()[-len(compared):]
    assert tail == [f"kmerbench: compared {n} = {c['value']} (limit {c['limit']})"
                    for n, c in compared.items()]
    bench = spec.Spec(root)
    want = {m["name"] for m in bench.metrics(bench.cell(cell), bool(trace))}
    got = set(line["metrics"])
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # On the CPU no kernel runs: the roofline finds nothing to read.
        assert got <= want
    else:
        assert got == want


def test_no_chip_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_reader_that_loads_jax_stops_the_result(small, root, tmp_path,
                                                  monkeypatch):
    """A metric's reader runs after the window; one that imports a module
    named jax leaves no result."""
    import sys

    (tmp_path / "jax.py").write_text('"""A stand-in of the name."""\n')
    (tmp_path / "loads_jax.py").write_text("import jax  # noqa: F401\n\n\n"
                                           "def read(ctx):\n    return 1.0\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    real = sys.modules.pop("jax", None)

    def reader(kind, name):
        import importlib

        return importlib.import_module("loads_jax").read

    monkeypatch.setattr(spec, "reader", reader)
    try:
        with pytest.raises(SystemExit) as e:
            run_cell(CELLS[0], small, root)
        assert e.value.code != 0
    finally:
        sys.modules.pop("loads_jax", None)
        sys.modules.pop("jax", None)
        if real is not None:
            sys.modules["jax"] = real


def test_a_mix_states_flags_and_compressors(small, root, monkeypatch):
    """A mix's flags reach every CLI call; its input compressor gives the
    program compressed FASTA, and its output decompressor lets the
    reference read compressed outputs."""
    from kmerset_tpu_torch.cli import kmerset_build

    if not shutil.which("gzip"):
        pytest.skip("needs gzip")
    seen = []
    real = kmerset_build.main
    monkeypatch.setattr(kmerset_build, "main",
                        lambda argv: (seen.append(list(argv)), real(argv))[1])
    small["mix"].update(flags=["--workers", "2", "--decompressor", "gzip -dc",
                               "--compressor", "gzip -c"],
                        input_compressor="gzip -c",
                        output_decompressor="gzip -dc")
    rc, out, err = run_cell(CELLS[0], small, root)
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is True, err
    assert all(a[a.index("--workers") + 1] == "2" for a in seen)
    assert all(a[-1].endswith(".z") for a in seen)


def _unchanged(real, argv):
    """A step that returns its state unchanged: the job does nothing."""
    return None


def _through_write(change):
    """A fault in the bytes the program writes: change(data, argv)."""
    def fault(real, argv):
        from kmerset_tpu_torch.core import io as core_io

        write = core_io.write_file_bytes

        def changed(name, compressor, data):
            return write(name, compressor, change(data, argv) if data else data)

        core_io.write_file_bytes = changed
        try:
            return real(argv)
        finally:
            core_io.write_file_bytes = write
    fault.__name__ = change.__name__
    return fault


def _altered_dump(data, argv):
    """An answer altered where it is produced: one base of the first
    string of each dump changed."""
    b = bytearray(data)
    b[0] = ord("A") if b[0] != ord("A") else ord("C")
    return bytes(b)


def _one_kmer_per_line(data, argv):
    """The SPSS skipped: every k-mer of the dump alone on a line."""
    k = int(argv[argv.index("--k") + 1])
    return b"".join(s[i:i + k] + b"\n" for s in data.split(b"\n")
                    for i in range(len(s) - k + 1))


def _half_reads(real, argv):
    """Half of the batch left out: every other record of the FASTA."""
    from kmerset_tpu_torch.core import io as core_io

    read = core_io.read_file_bytes

    def half(name, decompressor=""):
        lines = read(name, decompressor).split(b"\n")
        records = [lines[i:i + 2] for i in range(0, len(lines) - 1, 2)]
        return b"".join(h + b"\n" + r + b"\n" for h, r in records[::2])

    core_io.read_file_bytes = half
    try:
        return real(argv)
    finally:
        core_io.read_file_bytes = read


def _half_sets(real, argv):
    """Half of the batch left out: every other input set compressed."""
    flags = [a for a in argv if not a.endswith(".txt")]
    files = [a for a in argv if a.endswith(".txt")]
    return real(flags + files[::2])


def _no_sharing(real, argv):
    """The joint compression skipped: every input set file stored whole
    as a file of its own, with no children and no edges."""
    files = [a for a in argv if a.endswith(".txt")]
    out, dot = argv[argv.index("--out") + 1], argv[argv.index("--out_graph") + 1]
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "meta.txt"), "w") as f:
        f.write(" ".join([str(len(files))] + [f"{i} 0" for i in range(len(files))])
                + f"\n{len(files)}\n")
    for i, path in enumerate(files):
        shutil.copyfile(path, os.path.join(out, f"{i}.txt"))
    with open(dot, "w") as f:
        f.write("digraph G {\n}\n")


def _half_decoded(real, argv):
    """Half of the batch left out: the reader yields every other set."""
    from kmerset_tpu_torch.core.kmer_set_set import KmerSetSetReader

    size = KmerSetSetReader.size
    KmerSetSetReader.size = lambda self: size(self) // 2
    try:
        return real(argv)
    finally:
        KmerSetSetReader.size = size


def _altered_decode(real, argv):
    """An answer altered where it is produced: one k-mer of each decode
    changed."""
    from kmerset_tpu_torch.core.kmer_set_set import KmerSetSetReader

    load = KmerSetSetReader._load

    def altered(self, idx):
        a = load(self, idx).copy()
        if a.size:
            a[0] ^= 1
        return np.unique(a)

    KmerSetSetReader._load = altered
    try:
        return real(argv)
    finally:
        KmerSetSetReader._load = load


def _cli(name):
    import importlib

    return importlib.import_module(f"kmerset_tpu_torch.cli.{name}")


_BUILD = (_unchanged, _through_write(_altered_dump), _half_reads,
          _through_write(_one_kmer_per_line))
FAULTS = [
    (c, cli, f) for c, cli, fs in (
        ("ecoli-k15.assembly", "kmerset_build", _BUILD),
        ("ecoli-k15.reads", "kmerset_build", _BUILD),
        ("pan16-k23.compress", "kmerset_multiple_compress",
         (_unchanged, _through_write(_altered_dump), _half_sets, _no_sharing)),
        ("pan16-k23.decompress", "kmerset_multiple_decompress",
         (_unchanged, _altered_decode, _half_decoded)),
    ) for f in fs]


@pytest.mark.parametrize("cell,cli,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, _, f in FAULTS])
def test_broken_timed_path_is_not_correct(cell, cli, fault, small, root,
                                          monkeypatch):
    module = _cli(cli)
    real = module.main

    def main(argv):  # set-up's own calls run as they are
        return real(argv) if _is_setup(cell, argv) else fault(real, argv)

    monkeypatch.setattr(module, "main", main)
    rc, out, err = run_cell(cell, small, root)
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, err
    assert not check.within(line["compared"]) or line["failed"] > 0


def _is_setup(cell, argv):
    """The set-up's own calls of a CLI: the set files' builds of the
    multi-set cells, and the decompress cell's compress."""
    return (cell.startswith("pan16") and "--cutoff" in argv) or (
        cell.endswith("decompress") and "--out" in argv)
