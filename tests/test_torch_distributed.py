"""The mesh over a torch.distributed process group (kmerset_tpu_torch/
parallel/: Mesh(group=...), maybe_init_distributed, the CLIs' group
bring-up), in child processes on gloo with CPU shards.

Counterparts of tests/test_distributed.py's two-process and uneven
children (:17-184), which run the reference's jax.distributed mesh; here
the ranks rendezvous through a file under tmp_path (library children)
or a store this process serves on a port it holds (the CLIs'
KMERSET_TPU_DISTRIBUTED=auto, as under torchrun's agent), and import
only kmerset_tpu_torch (tests/torch_distributed_child.py).  Each mesh
program runs in four layouts: 2 ranks of 2 shards, the uneven 4 + 2, a
rank without shards (3 + 0), and a group of one rank (3 shards).  The
child holds every result against the port's single-process mesh and its
single-device or host path; this process holds the saved arrays against
the reference's host functions, and the CLIs' outputs byte for byte
against the reference's host CLIs.
"""

import contextlib
import filecmp
import io
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from kmerset_tpu_torch.ops import backend
from kmerset_tpu_torch.parallel import driver
from kmerset_tpu_torch.parallel.mesh import transport_of

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "torch_distributed_child.py")
CHILD_TIMEOUT_S = 120
LAYOUTS = {"2+2": (2, 2), "4+2": (4, 2), "3+0": (3, 0), "one rank": (3,)}
CASES = ("chain_group", "count", "count_agreed", "count_k19", "count_rounds",
         "emission", "exchange_hazards", "hash", "local_only", "matching",
         "overlap_edges", "pointer_double", "set_algebra",
         "side_tables_directed", "sketch", "unitig_succ",
         "unitig_succ_chunked")
_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _env(**extra) -> dict:
    """The children's environment: the checkout on the path, one torch
    thread each (several children share the machine's cores)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env.pop("KMERSET_TPU_FORCE_BACKEND", None)
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _start(argv, cwd, env=None) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env or _env(),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(procs):
    """[(returncode, output)] of each child, each within CHILD_TIMEOUT_S;
    a child that outlives it is killed, and so is every other.  Every
    child's output is read at once: a rank blocked on a full pipe would
    hold up the collectives of the rank being read."""
    try:
        with ThreadPoolExecutor(max_workers=len(procs)) as ex:
            texts = list(ex.map(
                lambda p: p.communicate(timeout=CHILD_TIMEOUT_S)[0], procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, text) for p, text in zip(procs, texts)]


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    """Every layout's ranks, all started at once: {layout: (dir, [(rc,
    output)], [rank outcome dicts])}."""
    started = {}
    for name, counts in LAYOUTS.items():
        d = tmp_path_factory.mktemp("lib")
        started[name] = (d, [
            _start([CHILD, "lib", str(r), str(len(counts)), str(d / "init"),
                    str(d), str(n)], cwd=str(d))
            for r, n in enumerate(counts)])
    out = {}
    for name, (d, procs) in started.items():
        done = _finish(procs)
        outcomes = []
        for r, (rc, text) in enumerate(done):
            assert rc == 0 and f"rank {r}: ok" in text, (name, r, text[-4000:])
            with open(d / f"rank{r}.json") as f:
                outcomes.append(json.load(f))
        out[name] = (d, done, outcomes)
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_program_over_a_group(layouts, layout, case):
    """Each mesh program on every rank of the group equals the
    single-process mesh of as many shards and the single-device or host
    result (the child's checks)."""
    _, _, outcomes = layouts[layout]
    for r, got in enumerate(outcomes):
        assert got[case] == "ok", (layout, r, got[case])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shards_are_every_ranks_in_rank_order(layouts, layout):
    _, _, outcomes = layouts[layout]
    counts, first = LAYOUTS[layout], 0
    for r, got in enumerate(outcomes):
        assert got["layout"] == {"size": sum(counts),
                                 "local": list(range(first, first + counts[r]))}
        first += counts[r]


def _load(d, r, name):
    return np.load(os.path.join(d, f"rank{r}_{name}.npy"))


@pytest.mark.parametrize("what", ["count", "front-end", "matching",
                                  "overlap edges", "set algebra"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_group_results_match_reference_host(layouts, layout, what):
    """Every rank's saved result against the reference's host functions:
    extract_kmers (the count), _side_table_canonical (the front-end's
    terminal tests and successors), handshake_matching,
    native.overlap_edges, and numpy's set algebra."""
    from kmerset_tpu.core import native as ref_native
    from kmerset_tpu.core import spss as ref_spss
    from kmerset_tpu.core.graph import handshake_matching
    from kmerset_tpu.core.kmer_counter import extract_kmers

    d, _, outcomes = layouts[layout]
    for r in range(len(outcomes)):
        if what == "count":
            codes, offsets = _load(d, r, "count_codes"), _load(d, r, "count_offsets")
            keys, counts = np.unique(extract_kmers(codes, offsets, 11, True),
                                     return_counts=True)
            np.testing.assert_array_equal(_load(d, r, "count_keys"), keys)
            np.testing.assert_array_equal(_load(d, r, "count_counts"), counts)
        elif what == "front-end":
            A = _load(d, r, "succ_A")
            rdeg, rnbr, rsame = ref_spss._side_table_canonical(A, 11, right=True)
            ldeg, lnbr, lsame = ref_spss._side_table_canonical(A, 11, right=False)
            term_r = (rdeg != 1) | (np.where(rsame, rdeg[rnbr], ldeg[rnbr]) != 1)
            term_l = (ldeg != 1) | (np.where(lsame, ldeg[lnbr], rdeg[lnbr]) != 1)
            np.testing.assert_array_equal(_load(d, r, "succ_term_r"), term_r)
            np.testing.assert_array_equal(_load(d, r, "succ_term_l"), term_l)
            np.testing.assert_array_equal(_load(d, r, "succ")[0::2],
                                          np.where(term_r, -1, 2 * rnbr + rsame))
        elif what == "matching":
            want = handshake_matching(_load(d, r, "match_pa"), _load(d, r, "match_pb"), 400)
            np.testing.assert_array_equal(_load(d, r, "match"), want)
        elif what == "overlap edges":
            want = ref_native.overlap_edges(_load(d, r, "ov_P"), _load(d, r, "ov_S"), 11)
            if want is None:
                pytest.skip("the reference's native library is not loaded")
            np.testing.assert_array_equal(_load(d, r, "ov_a"), want[0])
            np.testing.assert_array_equal(_load(d, r, "ov_b"), want[1])
        else:
            A, B = _load(d, r, "algebra_A"), _load(d, r, "algebra_B")
            for name, want in (("inter", np.intersect1d(A, B)),
                               ("a_only", np.setdiff1d(A, B)),
                               ("b_only", np.setdiff1d(B, A))):
                np.testing.assert_array_equal(_load(d, r, f"algebra_{name}"), want)


@pytest.mark.parametrize("every,want", [
    ([[("h", "cuda", "u0", "cuda:0")], [("h", "cuda", "u1", "cuda:1")]], "nccl"),
    ([[("h", "cuda", "u0", "cuda:0")] * 2], "nccl"),
    ([[("h", "cuda", "u0", "cuda:0")] * 2, [("h", "cuda", "u0", "cuda:0")]], "gloo"),
    ([[("h", "cuda", "u0", "cuda:0")], [("g", "cuda", "u0", "cuda:0")]], "nccl"),
    ([[("h", "cuda", "u0", "cuda:0")], [("h", "cpu", "cpu", "cpu")]], "gloo"),
    ([[("h", "cuda", "u0", "cuda:0")], []], "gloo"),
    ([[("h", "cpu", "cpu", "cpu")] * 2, [("h", "cpu", "cpu", "cpu")]], "gloo"),
], ids=["distinct cards", "one rank on one card", "a shared card",
        "two hosts", "a cpu rank", "a rank without shards", "cpu"])
def test_transport_rule(every, want):
    """NCCL only where every rank's shards are on CUDA and no card is held
    by two ranks (a card is its uuid on its host)."""
    assert transport_of(every) == want


@pytest.mark.parametrize("spec", ["localhost", "127.0.0.1:1,2", "127.0.0.1,2,0",
                                  "127.0.0.1:x,2,0", "127.0.0.1:1,2,2"])
def test_malformed_spec_gives_the_reference_message(monkeypatch, spec):
    monkeypatch.setenv(driver.DISTRIBUTED_ENV, spec)
    with pytest.raises(ValueError, match=re.escape(
            f"malformed KMERSET_TPU_DISTRIBUTED={spec!r}: expected 'auto' or "
            "'addr:port,num_processes,process_id'")):
        driver.maybe_init_distributed([])


def test_unset_spec_is_one_process(monkeypatch):
    monkeypatch.delenv(driver.DISTRIBUTED_ENV, raising=False)
    assert driver.maybe_init_distributed([]) is False
    monkeypatch.setenv(driver.DISTRIBUTED_ENV, "")
    assert driver.maybe_init_distributed([]) is False


@pytest.mark.parametrize("mode,rank_error", [
    ("fault", {1: "injected fault on rank 1", 0: "Connection closed by peer"}),
    ("steps", {0: "mesh steps out of step across ranks: rank 0 at step 1 "
                  "(count), rank 1 at step 1 (decode)",
               1: "mesh steps out of step across ranks"}),
], ids=["a rank's error ends both", "a step mismatch raises"])
def test_one_ranks_fault_ends_every_rank(tmp_path, mode, rank_error):
    """An error on one rank (before a collective that the other enters),
    or ranks that start different steps: every rank exits non-zero within
    the children's timeout, and none finishes."""
    done = _finish([_start([CHILD, mode, str(r), "2", str(tmp_path / "init")],
                           cwd=str(tmp_path)) for r in range(2)])
    for r, (rc, text) in enumerate(done):
        assert rc != 0 and "finished" not in text, (r, text[-3000:])
        assert rank_error[r] in text, (r, text[-3000:])


# -- the CLIs over KMERSET_TPU_DISTRIBUTED ----------------------------------


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    """A FASTA of ~3x-coverage reads of a 12 kb genome, and four compact
    set files of point-mutated strains (k = 15) built by the port's host
    path."""
    from kmerset_tpu_torch.core.kmer_set import KmerSet
    from kmerset_tpu_torch.core.kmer_set_compact import KmerSetCompact

    d = tmp_path_factory.mktemp("dist_cli")
    rng = np.random.default_rng(909)
    genome = rng.integers(0, 4, 12000).astype(np.uint8)
    reads = []
    for _ in range(80):
        s = int(rng.integers(0, 11500))
        r = genome[s: s + 450]
        reads.append(3 - r[::-1] if rng.random() < 0.5 else r)
    fasta = d / "reads.fa"
    fasta.write_bytes(b"".join(b">r%d\n%s\n" % (i, _BASES[r].tobytes())
                               for i, r in enumerate(reads)))
    sets = []
    for i in range(4):
        mut = genome.copy()
        pos = rng.integers(0, mut.size, mut.size // 250)
        mut[pos] = rng.integers(0, 4, pos.size)
        kmers, _ = backend.device_count(
            mut, np.array([0, mut.size], dtype=np.int64), 15, True, device="cpu")
        sets.append(str(d / f"s{i}.txt"))
        KmerSetCompact.from_kmer_set(KmerSet(15, kmers, _sorted=True), True,
                                     device="cpu").dump(sets[-1])
    return d, str(fasta), sets


def _ranks_start(module, per_rank_argv, devices=("cpu,cpu", "cpu")):
    """The port's CLI `module` started as len(devices) ranks over
    KMERSET_TPU_DISTRIBUTED=auto (rank r on --device devices[r], then
    per_rank_argv(r)): (the store, the ranks).  As torchrun's agent does,
    this process serves the rendezvous store, on a port it binds and
    holds until the store is dropped, so no other run can take it in
    between; _finish collects the ranks."""
    import torch.distributed as dist

    store = dist.TCPStore("127.0.0.1", 0, len(devices), True,
                          wait_for_workers=False)
    return store, [
        _start(["-m", module, "--debug", "--device", dev, *per_rank_argv(r)],
               cwd=ROOT, env=_env(
                   KMERSET_TPU_DISTRIBUTED="auto", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(store.port), WORLD_SIZE=str(len(devices)),
                   RANK=str(r), TORCHELASTIC_USE_AGENT_STORE="True"))
        for r, dev in enumerate(devices)]


def _reference_cli(monkeypatch, cli, argv) -> str:
    """The reference's CLI `cli` in this process, pinned to its host path:
    its log."""
    import importlib
    import logging

    monkeypatch.setenv("KMERSET_TPU_FORCE_BACKEND", "host")
    monkeypatch.delenv(driver.DISTRIBUTED_ENV, raising=False)
    log = io.StringIO()
    handler = logging.StreamHandler(log)
    logging.getLogger("kmerset").addHandler(handler)
    try:
        importlib.import_module(f"kmerset_tpu.cli.{cli}").main(argv)
    finally:
        logging.getLogger("kmerset").removeHandler(handler)
    return log.getvalue()


@pytest.fixture(scope="module")
def build_runs(cli_inputs):
    """kmerset-build --check at k = 15 and 31 on 2 ranks (3 shards), both
    k at once: {k: [(rc, output)]}."""
    d, fasta, _ = cli_inputs
    started = {k: _ranks_start("kmerset_tpu_torch.cli.kmerset_build", lambda r, k=k: [
        "--k", str(k), "--check", "--out", str(d / f"b{k}_rank{r}.txt"), fasta])
        for k in (15, 31)}
    return {k: _finish(procs) for k, (_, procs) in started.items()}


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("k", [15, 31])
def test_build_over_two_ranks_matches_reference(cli_inputs, build_runs,
                                                monkeypatch, tmp_path, k, rank):
    """Each rank's dump is byte-identical to the reference's host CLI's;
    its log shows the group's mesh and its count, decode and graph steps
    on 3 shards, and its --check ok."""
    d, fasta, _ = cli_inputs
    rc, text = build_runs[k][rank]
    assert rc == 0, text[-4000:]
    ref = tmp_path / "ref.txt"
    _reference_cli(monkeypatch, "kmerset_build", [
        "--k", str(k), "--check", "--out", str(ref), fasta])
    assert filecmp.cmp(d / f"b{k}_rank{rank}.txt", ref, shallow=False)
    assert "mesh: 3 shards over 2 processes, cpu shards: exchanges through " \
           "the host (gloo)" in text
    assert "kmer_set_compact -> KmerSet: ok" in text
    for step in ("count", "decode", "front-end", "pointer doubling"):
        assert f"mesh: {step} on 3 shards: " in text, step


@pytest.fixture(scope="module")
def compress_runs(cli_inputs):
    d, _, sets = cli_inputs
    _store, procs = _ranks_start(
        "kmerset_tpu_torch.cli.kmerset_multiple_compress",
        lambda r: ["--k", "15", "--seed", "1", "--workers", "4", "--out",
                   str(d / f"M_rank{r}"), "--out_graph", str(d / f"M_rank{r}.dot"),
                   *sets])
    return _finish(procs)


@pytest.mark.parametrize("rank", [0, 1])
def test_multiple_compress_over_two_ranks_matches_reference(
        cli_inputs, compress_runs, monkeypatch, tmp_path, rank):
    """--workers 4 on 2 ranks: each rank's directory and DOT file are
    byte-identical to the reference's host CLI's; the deferred builds ran
    in item order, and the pair weights on the group's mesh."""
    d, _, sets = cli_inputs
    rc, text = compress_runs[rank]
    assert rc == 0, text[-4000:]
    ref = tmp_path / "M_ref"
    _reference_cli(monkeypatch, "kmerset_multiple_compress", [
        "--k", "15", "--seed", "1", "--out", str(ref), "--out_graph",
        str(ref) + ".dot", *sets])
    got = d / f"M_rank{rank}"
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(got)) == names and len(names) > 5
    for name in names:
        assert filecmp.cmp(got / name, ref / name, shallow=False), name
    assert filecmp.cmp(f"{got}.dot", f"{ref}.dot", shallow=False)
    assert "items that take mesh steps run in item order, not in 4 workers" in text
    assert "kmer_set_set: sketch table on mesh of 3 shards over 2 processes" in text
    for step in ("sketch weights", "decode", "front-end"):
        assert f"mesh: {step} on 3 shards: " in text, step


def test_a_rank_that_fails_ends_the_other(cli_inputs, tmp_path):
    """Rank 1 cannot read its input and exits 1; rank 0, in the group's
    collectives, must not finish alone: it exits non-zero too."""
    _, fasta, _ = cli_inputs
    _store, procs = _ranks_start(
        "kmerset_tpu_torch.cli.kmerset_build",
        lambda r: ["--k", "15", "--out", str(tmp_path / f"x{r}.txt"),
                   fasta if r == 0 else str(tmp_path / "missing.fa")],
        devices=("cpu", "cpu"))
    done = _finish(procs)
    assert done[1][0] == 1, done[1][1][-3000:]
    assert done[0][0] != 0, done[0][1][-3000:]
    assert not os.path.exists(tmp_path / "x0.txt")


def test_a_missing_device_exits_1_before_the_group_forms(cli_inputs, tmp_path):
    """--device naming a device that is not there exits 1 on that rank,
    with the single device's message, before it joins the group (so the
    spec's port, the discard port, is never bound or dialled)."""
    _, fasta, _ = cli_inputs
    proc = subprocess.run(
        [sys.executable, "-m", "kmerset_tpu_torch.cli.kmerset_build",
         "--device", "cpu,cuda:7", "--k", "15", fasta], cwd=ROOT,
        env=_env(KMERSET_TPU_DISTRIBUTED="127.0.0.1:9,2,0"),
        capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    assert proc.returncode == 1, proc.stderr
    assert "requested but" in proc.stderr
    assert "torch.distributed" not in proc.stderr


def test_one_rank_group_build_equals_one_process(cli_inputs, tmp_path):
    """A group of one rank over the spec addr:port,1,0 (`--device cpu` is
    then a mesh of one local shard, never the single-device path) writes
    the single device's dump.  Port 0: rank 0 serves the store on a port
    the system picks, and no other rank needs to know it."""
    _, fasta, _ = cli_inputs
    (rc, text), = _finish([_start(
        ["-m", "kmerset_tpu_torch.cli.kmerset_build", "--debug", "--device",
         "cpu", "--k", "15", "--check", "--out", str(tmp_path / "g.txt"), fasta],
        cwd=ROOT, env=_env(KMERSET_TPU_DISTRIBUTED="127.0.0.1:0,1,0"))])
    assert rc == 0, text[-4000:]
    assert "mesh: count on 1 shards: " in text
    from kmerset_tpu_torch.cli import kmerset_build

    with contextlib.redirect_stderr(io.StringIO()):
        kmerset_build.main(["--device", "cpu", "--k", "15", "--out",
                            str(tmp_path / "s.txt"), fasta])
    assert filecmp.cmp(tmp_path / "g.txt", tmp_path / "s.txt", shallow=False)
