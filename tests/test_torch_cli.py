"""The port's kmerset-build slice as a whole, against the reference CLI.

Both CLIs run in subprocesses on the same FASTA: the port with
--device cpu (its kernels' plain versions), the reference pinned to its
host path.  Their dump files must be byte-identical and their logged
size, hash and cutoff count equal.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from kmerset_tpu.core.kmer_counter import KmerCounter as RefCounter
from kmerset_tpu_torch.core.kmer_counter import KmerCounter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_LOGGED = ("cutoff_count", "kmer_set.Size()", "kmer_set.Hash()",
           "kmer_set_compact.Size()")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """~3x coverage of an 8 kb genome from both strands, a read repeated
    20 times, and reads carrying runs of N."""
    rng = np.random.default_rng(2024)
    genome = rng.integers(0, 4, 8000, dtype=np.uint8)
    reads = []
    for _ in range(60):
        s = int(rng.integers(0, 7600))
        r = genome[s : s + 400]
        reads.append(3 - r[::-1] if rng.random() < 0.5 else r)
    reads += [genome[1000:1300]] * 20
    lines = [_BASES[r].tobytes() for r in reads]
    for j in range(5):
        r = _BASES[genome[1500 * j : 1500 * j + 600]].copy()
        for a in rng.integers(0, 590, 3):
            r[a : a + int(rng.integers(1, 12))] = ord("N")
        lines.append(r.tobytes())
    path = tmp_path_factory.mktemp("cli") / "reads.fa"
    path.write_bytes(
        b"".join(b">r%d\n%s\n" % (i, s) for i, s in enumerate(lines))
    )
    return str(path)


def _run(module: str, *args: str) -> subprocess.CompletedProcess:
    """The CLI `module` in a subprocess: the reference's pinned to its host
    path, the port's with no pin in its environment (it reaches no code
    that reads it)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("KMERSET_TPU_FORCE_BACKEND", None)
    if module.startswith("kmerset_tpu."):
        env["KMERSET_TPU_FORCE_BACKEND"] = "host"
    return subprocess.run(
        [sys.executable, "-m", module, *args],
        capture_output=True, text=True, cwd=ROOT, env=env, timeout=300,
    )


def _logged(stderr: str) -> dict:
    out = {}
    for key in _LOGGED:
        m = re.search(re.escape(key) + r" = (\d+)", stderr)
        if m:
            out[key] = int(m.group(1))
    return out


@pytest.mark.parametrize("cutoff", [1, 2])
def test_build_dump_byte_identical_to_reference(fasta, tmp_path, cutoff):
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    common = ["--k", "15", "--cutoff", str(cutoff), "--check"]
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                *common, "--out", a, fasta)
    ref = _run("kmerset_tpu.cli.kmerset_build", *common, "--out", b, fasta)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert _logged(port.stderr) == _logged(ref.stderr)
    assert len(_logged(port.stderr)) == len(_LOGGED)
    assert "kmer_set_compact -> KmerSet: ok" in port.stderr
    if cutoff > 1:
        assert _logged(port.stderr)["cutoff_count"] > 0


def test_stat_reads_port_dump(fasta, tmp_path):
    out = str(tmp_path / "a.txt")
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                "--k", "15", "--out", out, fasta)
    assert port.returncode == 0, port.stderr
    stat = _run("kmerset_tpu.cli.kmerset_stat", "--k", "15", out)
    assert stat.returncode == 0, stat.stderr
    _, name, size, hash_ = stat.stdout.strip().split("\t")
    logged = _logged(port.stderr)
    assert (int(size), int(hash_)) == (
        logged["kmer_set.Size()"], logged["kmer_set.Hash()"]
    )


def test_trace_writes_torch_profile(fasta, tmp_path):
    trace = tmp_path / "trace"
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                "--k", "15", "--trace", str(trace), fasta)
    assert port.returncode == 0, port.stderr
    assert (trace / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("cutoff", [1, 2])
@pytest.mark.parametrize("k", [19, 23, 31])
def test_pair_k_dump_byte_identical_to_reference(fasta, tmp_path, k, cutoff):
    """k = 19, 23 and 31 (kernel B2, the int64 keys) as k = 15 above."""
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    common = ["--k", str(k), "--cutoff", str(cutoff), "--check"]
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                *common, "--out", a, fasta)
    ref = _run("kmerset_tpu.cli.kmerset_build", *common, "--out", b, fasta)
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert _logged(port.stderr) == _logged(ref.stderr)
    assert len(_logged(port.stderr)) == len(_LOGGED)
    assert "kmer_set_compact -> KmerSet: ok" in port.stderr
    if cutoff > 1:
        assert _logged(port.stderr)["cutoff_count"] > 0


@pytest.mark.parametrize("k", ["25", "31"])
def test_k_25_exits_1_and_k_31_matches_reference(fasta, tmp_path, k):
    """25 is no CLI k: both CLIs exit 1.  31 is one of the reference's:
    both build it, to the same bytes."""
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", "cpu",
                "--k", k, "--out", a, fasta)
    ref = _run("kmerset_tpu.cli.kmerset_build", "--k", k, "--out", b, fasta)
    if k == "25":
        assert port.returncode == ref.returncode == 1
        assert "unsupported k value: 25" in port.stderr
        return
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert _logged(port.stderr) == _logged(ref.stderr)
    assert _logged(port.stderr)["kmer_set.Size()"] > 0


def test_non_utf8_fasta_logs_and_exits_1_like_reference(tmp_path, monkeypatch):
    """A FASTA file holding byte 0xff, read without the native library
    (both packages' loaders report none, as on a machine without one):
    both CLIs log the same "failed to parse FASTA file" line and exit 1,
    in this process, where a subprocess would load the library."""
    import logging

    from kmerset_tpu.cli import kmerset_build as ref_cli
    from kmerset_tpu.core import native as ref_native
    from kmerset_tpu_torch.cli import kmerset_build as port_cli
    from kmerset_tpu_torch.core import native

    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(ref_native, "get_lib", lambda: None)
    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    path = tmp_path / "bad.fa"
    path.write_bytes(b">r0\nACGT\xffACGT\n")
    errors = []
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda record: errors.append(record.getMessage())
    log = logging.getLogger("kmerset")
    log.addHandler(handler)  # the conftest fixture restores the handlers
    logged = {}
    for tag, cli, extra in (("port", port_cli, ["--device", "cpu"]),
                            ("ref", ref_cli, [])):
        errors.clear()
        with pytest.raises(SystemExit) as e:
            cli.main([*extra, "--k", "15", str(path)])
        assert e.value.code == 1, tag
        logged[tag] = list(errors)
    assert logged["port"] == logged["ref"]
    assert len(logged["port"]) == 1
    assert logged["port"][0].startswith("failed to parse FASTA file: 'utf-8'")


def test_cuda_without_a_card_exits_nonzero(fasta):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    port = _run("kmerset_tpu_torch.cli.kmerset_build", "--k", "15", fasta)
    assert port.returncode != 0
    assert "cuda" in port.stderr


def test_counter_saturates_like_reference():
    """A read repeated 300 times: counts saturate at the uint8 default
    (value_max 255) on the device download, as in the reference."""
    rng = np.random.default_rng(9)
    hot = _BASES[rng.integers(0, 4, 60)].tobytes().decode()
    other = [_BASES[rng.integers(0, 4, 200)].tobytes().decode() for _ in range(5)]
    reads = [hot] * 300 + other
    port = KmerCounter.from_reads(15, reads, True, device="cpu")
    ref = RefCounter.from_reads(15, reads, True)
    np.testing.assert_array_equal(port.kmers, ref.kmers)
    np.testing.assert_array_equal(port.counts, ref.counts)
    assert port.counts.max() == 255
    for cutoff in (2, 256):
        (ps, pn), (rs, rn) = port.to_kmer_set(cutoff), ref.to_kmer_set(cutoff)
        assert pn == rn
        np.testing.assert_array_equal(ps.kmers, rs.kmers)


# -- the multi-set CLIs, kmerset-stat and spss-benchmark -------------------

_HASH_SIZE = re.compile(r"kmer_set\.(Hash|Size)\(\) = (\d+)")


@pytest.fixture(scope="module", params=[15, 31], ids=["k15", "k31"])
def strain_sets(request, tmp_path_factory):
    """Five compact set files (k = 15, and k = 31) of point-mutated
    strains of one random genome, and each CLI's compress run of them:
    the port's with --workers 4 on --device cpu, the reference's pinned to
    its host path with --workers 1.  Returns (k, files, runs)."""
    from kmerset_tpu.core import kmer as kc
    from kmerset_tpu_torch.core.kmer_set import KmerSet
    from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact

    k = request.param
    d = tmp_path_factory.mktemp(f"multi{k}")
    rng = np.random.default_rng(77)
    base = rng.integers(0, 4, 15000).astype(np.int64)
    files = []
    for i in range(5):
        mut = base.copy()
        pos = rng.integers(0, base.size, base.size // 250)
        mut[pos] = rng.integers(0, 4, pos.size)
        kmers = np.unique(kc.canonical(kc.kmers_from_codes(mut, k), k))
        files.append(str(d / f"m{i}.txt"))
        KmerSetCompact.from_kmer_set(
            KmerSet(k, kmers, _sorted=True), True, device="cpu"
        ).dump(files[-1])
    runs = {}
    for tag, module, extra in (
        ("port", "kmerset_tpu_torch.cli.kmerset_multiple_compress",
         ["--device", "cpu", "--workers", "4"]),
        ("ref", "kmerset_tpu.cli.kmerset_multiple_compress", []),
    ):
        out = str(d / f"M_{tag}")
        proc = _run(module, *extra, "--k", str(k), "--seed", "1", "--out",
                    out, "--out_graph", out + ".dot", *files)
        assert proc.returncode == 0, proc.stderr
        runs[tag] = (out, proc.stderr)
    return k, files, runs


def test_multiple_compress_byte_identical_to_reference(strain_sets):
    import filecmp

    _, _, runs = strain_sets
    (port, port_log), (ref, ref_log) = runs["port"], runs["ref"]
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(ref)) and "meta.txt" in names
    assert len(names) > 6  # shared children were factored out
    for name in names:
        assert filecmp.cmp(os.path.join(port, name), os.path.join(ref, name),
                           shallow=False), name
    assert filecmp.cmp(port + ".dot", ref + ".dot", shallow=False)
    sizes = re.compile(r"(i = \d+, size = \d+|total_size = \d+)")
    assert sizes.findall(port_log) == sizes.findall(ref_log)


def test_multiple_decompress_and_stat_match_reference(strain_sets):
    k, files, runs = strain_sets
    logs = {}
    for tag, module, extra in (
        ("port", "kmerset_tpu_torch.cli.kmerset_multiple_decompress",
         ["--device", "cpu", "--workers", "3"]),
        ("ref", "kmerset_tpu.cli.kmerset_multiple_decompress", []),
    ):
        proc = _run(module, *extra, "--k", str(k), runs[tag][0])
        assert proc.returncode == 0, proc.stderr
        logs[tag] = _HASH_SIZE.findall(proc.stderr)
    assert logs["port"] == logs["ref"]
    port_stat = _run("kmerset_tpu_torch.cli.kmerset_stat", "--device", "cpu",
                     "--k", str(k), *files)
    ref_stat = _run("kmerset_tpu.cli.kmerset_stat", "--k", str(k), *files)
    assert port_stat.returncode == 0, port_stat.stderr
    assert port_stat.stdout == ref_stat.stdout
    rows = [line.split("\t") for line in port_stat.stdout.splitlines()]
    assert [r[1] for r in rows] == files
    # Every original's decompressed Hash() and Size() is its stat row's.
    decoded = logs["port"]
    for i, (_, _, size, hash_) in enumerate(rows):
        assert decoded[2 * i] == ("Hash", hash_)
        assert decoded[2 * i + 1] == ("Size", size)


def test_spss_benchmark_columns_match_reference(strain_sets):
    k, files, _ = strain_sets
    port = _run("kmerset_tpu_torch.cli.spss_benchmark", "--device", "cpu",
                "--k", str(k), files[0])
    ref = _run("kmerset_tpu.cli.spss_benchmark", "--k", str(k), files[0])
    assert port.returncode == 0, port.stderr
    assert ref.returncode == 0, ref.stderr
    p, r = port.stdout.split(), ref.stdout.split()
    assert len(p) == len(r) == 8
    # time weight time ok, for fast = False then True: weights and oks.
    assert [p[i] for i in (1, 3, 5, 7)] == [r[i] for i in (1, 3, 5, 7)]
    assert p[3] == p[7] == "1"
    assert _HASH_SIZE.findall(port.stderr) == _HASH_SIZE.findall(ref.stderr)


@pytest.mark.parametrize("cli", ["kmerset_stat", "kmerset_multiple_compress",
                                 "kmerset_multiple_decompress",
                                 "spss_benchmark"])
def test_new_clis_exit_1_on_cuda_without_a_card(strain_sets, cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    k, files, runs = strain_sets
    arg = runs["port"][0] if cli == "kmerset_multiple_decompress" else files[0]
    proc = _run(f"kmerset_tpu_torch.cli.{cli}", "--k", str(k), arg)
    assert proc.returncode == 1
    assert "cuda" in proc.stderr


# -- the --device list (a mesh of shards) ------------------------------------


def _device_args(value: str):
    import argparse

    return argparse.Namespace(device=value)


def _errors_of(call):
    """(exit code or None, result, logged error lines) of call(logger)."""
    import logging

    errors = []
    logger = logging.getLogger("kmerset.test_device_list")
    handler = logging.Handler(logging.ERROR)
    handler.emit = lambda record: errors.append(record.getMessage())
    logger.addHandler(handler)
    try:
        return None, call(logger), errors
    except SystemExit as e:
        return e.code, None, errors
    finally:
        logger.removeHandler(handler)


@pytest.mark.parametrize("value,n_shards", [("cpu", 0), ("cpu,cpu", 2),
                                            (" cpu , cpu,cpu,cpu", 4)])
def test_device_list_parses_to_a_mesh(value, n_shards):
    """One entry is the single-device path (no mesh: no automatic one on
    the CPU); a list of several is a mesh of those shards, forced, with
    its first shard as the device."""
    from kmerset_tpu_torch.utils import flags

    code, (device, mesh), errors = _errors_of(
        lambda log: flags.devices_or_exit(_device_args(value), log))
    assert code is None and not errors
    assert device == torch.device("cpu")
    if n_shards == 0:
        assert mesh is None
    else:
        assert mesh.size == n_shards and mesh.forced
        assert mesh.devices == (torch.device("cpu"),) * n_shards


@pytest.mark.parametrize("bad", ["cuda", "cuda:7", "meta", "tpu"])
def test_device_list_with_a_missing_device_exits_1_like_one_device(bad):
    """A list naming a missing or unsupported device exits 1 with the
    message the single device gets."""
    from kmerset_tpu_torch.utils import flags

    if bad.startswith("cuda") and torch.cuda.is_available() and bad == "cuda":
        pytest.skip("a CUDA device is present")
    single = _errors_of(lambda log: flags.devices_or_exit(_device_args(bad), log))
    listed = _errors_of(
        lambda log: flags.devices_or_exit(_device_args(f"cpu,{bad},cpu"), log))
    assert single[0] == listed[0] == 1
    assert single[2] == listed[2] and len(single[2]) == 1
    assert bad.split(":")[0] in single[2][0]


_MULTI_CLIS = ["kmerset_stat", "kmerset_multiple_compress",
               "kmerset_multiple_decompress", "spss_benchmark"]


@pytest.fixture(scope="module")
def small_sets(tmp_path_factory):
    """Three small compact set files (k = 15) and their joint compression
    on one CPU device."""
    from kmerset_tpu_torch.core.config import get_config
    from kmerset_tpu_torch.core.kmer_set import KmerSet
    from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact
    from kmerset_tpu_torch.core.kmer_set_set import KmerSetSet

    from .test_torch_kmer_set_set import _strains

    d = tmp_path_factory.mktemp("small")
    files, compacts = [], []
    for i, a in enumerate(_strains(15, 3, 17, 3000)):
        compacts.append(KmerSetCompact.from_kmer_set(
            KmerSet(15, a, _sorted=True), True, device="cpu"))
        files.append(str(d / f"s{i}.txt"))
        compacts[-1].dump(files[-1])
    out = str(d / "M")
    KmerSetSet(compacts, True, get_config(15), seed=1, device="cpu").dump(out, "", "txt")
    return files, out


@pytest.mark.parametrize("cli", _MULTI_CLIS)
def test_clis_take_a_device_list(small_sets, cli, tmp_path, monkeypatch):
    """kmerset-stat, the multi-set CLIs and spss-benchmark take
    `--device cpu,cpu,cpu,cpu` and exit 0, their decodes on the mesh of
    four CPU shards."""
    import importlib

    from kmerset_tpu_torch.parallel import driver

    files, directory = small_sets
    args = {
        "kmerset_stat": files,
        "kmerset_multiple_compress": ["--out", str(tmp_path / "M"), *files],
        "kmerset_multiple_decompress": [directory],
        "spss_benchmark": files[:1],
    }[cli]
    shards = []
    orig = driver.mesh_count
    monkeypatch.setattr(driver, "mesh_count", lambda *a, **kw: shards.append(
        a[4].size) or orig(*a, **kw))
    main = importlib.import_module(f"kmerset_tpu_torch.cli.{cli}").main
    try:
        main(["--device", "cpu,cpu,cpu,cpu", "--k", "15", *args])
    except SystemExit as e:
        assert e.code in (None, 0), e.code
    assert shards and set(shards) == {4}


@pytest.fixture(scope="module")
def mesh_runs(strain_sets):
    """The four CLIs of the port on `--device cpu,cpu,cpu,cpu` over
    strain_sets' files (compress first, the rest beside each other), and
    the reference's decompress, stat and spss-benchmark on its host path:
    {name: CompletedProcess}."""
    from concurrent.futures import ThreadPoolExecutor

    k, files, runs = strain_sets
    K = str(k)
    port = "kmerset_tpu_torch.cli."
    mesh = ["--device", "cpu,cpu,cpu,cpu", "--k", K]
    out = runs["ref"][0] + "_mesh"
    jobs = {
        "compress": (port + "kmerset_multiple_compress", *mesh, "--debug",
                     "--workers", "4", "--seed", "1", "--out", out,
                     "--out_graph", out + ".dot", *files),
    }
    done = {"compress": _run(*jobs["compress"])}
    jobs = {
        "decompress": (port + "kmerset_multiple_decompress", *mesh, out),
        "stat": (port + "kmerset_stat", *mesh, *files),
        "bench": (port + "spss_benchmark", *mesh, files[0]),
        "ref decompress": ("kmerset_tpu.cli.kmerset_multiple_decompress",
                           "--k", K, runs["ref"][0]),
        "ref stat": ("kmerset_tpu.cli.kmerset_stat", "--k", K, *files),
        "ref bench": ("kmerset_tpu.cli.spss_benchmark", "--k", K, files[0]),
    }
    with ThreadPoolExecutor(len(jobs)) as ex:
        futures = {name: ex.submit(_run, *job) for name, job in jobs.items()}
        done.update((name, f.result()) for name, f in futures.items())
    for name, proc in done.items():
        assert proc.returncode == 0, (name, proc.stderr)
    return out, done


@pytest.mark.parametrize("cli", _MULTI_CLIS)
def test_clis_on_a_device_list_match_reference(strain_sets, mesh_runs, cli):
    """Each CLI on `--device cpu,cpu,cpu,cpu` against the reference's host
    CLI: the compress directory and DOT bytes (its --debug log shows the
    mesh's sketch table, decodes and graph steps), the decompressed
    Hash()/Size() lines, the stat TSV, spss-benchmark's weight and ok
    columns."""
    import filecmp

    _, files, runs = strain_sets
    out, done = mesh_runs
    if cli == "kmerset_multiple_compress":
        ref = runs["ref"][0]
        names = sorted(os.listdir(out))
        assert names == sorted(os.listdir(ref)) and len(names) > 6
        for name in names:
            assert filecmp.cmp(os.path.join(out, name), os.path.join(ref, name),
                               shallow=False), name
        assert filecmp.cmp(out + ".dot", ref + ".dot", shallow=False)
        log = done["compress"].stderr
        assert "kmer_set_set: sketch table on mesh of 4 shards (cpu)" in log
        for step in ("sketch weights", "decode", "front-end", "pointer doubling"):
            assert f"mesh: {step} on 4 shards: " in log, step
    elif cli == "kmerset_multiple_decompress":
        got = _HASH_SIZE.findall(done["decompress"].stderr)
        assert got == _HASH_SIZE.findall(done["ref decompress"].stderr)
        assert len(got) > 2 * len(files)
    elif cli == "kmerset_stat":
        assert done["stat"].stdout == done["ref stat"].stdout
        assert len(done["stat"].stdout.splitlines()) == len(files)
    else:
        p, r = done["bench"].stdout.split(), done["ref bench"].stdout.split()
        assert len(p) == len(r) == 8
        assert [p[i] for i in (1, 3, 5, 7)] == [r[i] for i in (1, 3, 5, 7)]
        assert p[3] == p[7] == "1"


def test_build_cli_on_a_device_list_in_a_subprocess(fasta, tmp_path):
    """`--device cpu,cpu,cpu` from the command line: the dump of the
    single-device build."""
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    for dev, out in (("cpu,cpu,cpu", a), ("cpu", b)):
        proc = _run("kmerset_tpu_torch.cli.kmerset_build", "--device", dev,
                    "--k", "23", "--check", "--out", out, fasta)
        assert proc.returncode == 0, proc.stderr
        assert "kmer_set_compact -> KmerSet: ok" in proc.stderr
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
