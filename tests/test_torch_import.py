"""The port imports neither JAX nor the JAX package, and asks for its
device explicitly.

tests/conftest.py imports jax and kmerset_tpu into the test process, so
the import check runs in a subprocess with both blocked and no
KMERSET_TPU_FORCE_BACKEND in its environment.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

import kmerset_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import contextlib, importlib, io, os, pkgutil, sys
# Any import of jax or of the JAX package now raises ImportError.
sys.modules["jax"] = None
sys.modules["kmerset_tpu"] = None
import numpy as np
import kmerset_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    kmerset_tpu_torch.__path__, "kmerset_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"kmerset_tpu_torch.parallel.mesh",
        "kmerset_tpu_torch.parallel.driver",
        "kmerset_tpu_torch.ops.deltas",
        "kmerset_tpu_torch.ops.resident"} <= set(names), names
from kmerset_tpu_torch.core.kmer_counter import KmerCounter
c = KmerCounter.from_reads(3, ["ACGTTGCA", "AANAC"], True, device="cpu")
# canonical 3-mers of ACGTTGCA: ACG CGT(=ACG) GTT(=AAC) TTG(=CAA) TGC(=GCA) GCA
assert c.kmers.tolist() == [0b000001, 0b000110, 0b010000, 0b100100], c.kmers
assert c.counts.tolist() == [1, 2, 1, 2], c.counts

# The CLIs end to end on the CPU: two builds with --check, a joint
# compression of the two sets, its decompression and kmerset-stat.
from kmerset_tpu_torch.cli import (kmerset_build, kmerset_multiple_compress,
                                   kmerset_multiple_decompress, kmerset_stat)
work = sys.argv[1]
rng = np.random.default_rng(3)
base = rng.integers(0, 4, 3000)
sets = []
for i in range(2):
    mut = base.copy()
    mut[rng.integers(0, 3000, 12)] = rng.integers(0, 4, 12)
    fa, out = os.path.join(work, f"g{i}.fa"), os.path.join(work, f"s{i}.txt")
    with open(fa, "w") as f:
        f.write(">g\n" + "".join("ACGT"[c] for c in mut) + "\n")
    kmerset_build.main(["--device", "cpu", "--k", "15", "--check", "--out", out, fa])
    sets.append(out)
# The same build on a slow link (the side-code route): the same dump.
os.environ["KMERSET_TPU_LINK"] = "slow"
slow_out = os.path.join(work, "slow.txt")
kmerset_build.main(["--device", "cpu", "--k", "15", "--check", "--out", slow_out, fa])
del os.environ["KMERSET_TPU_LINK"]
with open(slow_out, "rb") as f, open(sets[-1], "rb") as g:
    assert f.read() == g.read()
# The same build on a mesh of two CPU shards: the same dump.
mesh_out = os.path.join(work, "mesh.txt")
kmerset_build.main(["--device", "cpu,cpu", "--k", "15", "--check", "--out",
                    mesh_out, fa])
with open(mesh_out, "rb") as f, open(sets[-1], "rb") as g:
    assert f.read() == g.read()
# The same build as a group of one process (KMERSET_TPU_DISTRIBUTED, a
# torch.distributed group on gloo; port 0: the store takes a port the
# system picks): the same dump.
os.environ["KMERSET_TPU_DISTRIBUTED"] = "127.0.0.1:0,1,0"
group_out = os.path.join(work, "group.txt")
kmerset_build.main(["--device", "cpu,cpu", "--k", "15", "--out", group_out, fa])
del os.environ["KMERSET_TPU_DISTRIBUTED"]
import torch.distributed as dist
assert not dist.is_initialized()
with open(group_out, "rb") as f, open(sets[-1], "rb") as g:
    assert f.read() == g.read()
d = os.path.join(work, "M")
kmerset_multiple_compress.main(["--device", "cpu", "--k", "15", "--out", d, *sets])
# The same compression on a mesh of two CPU shards (its sharded sketch
# table, decodes and deferred builds): the same directory.
dm = os.path.join(work, "Mm")
kmerset_multiple_compress.main(["--device", "cpu,cpu", "--k", "15", "--out", dm, *sets])
assert sorted(os.listdir(dm)) == sorted(os.listdir(d))
for name in os.listdir(d):
    with open(os.path.join(d, name), "rb") as f, open(os.path.join(dm, name), "rb") as g:
        assert f.read() == g.read(), name
log = io.StringIO()
logger = __import__("logging").getLogger("kmerset")
logger.addHandler(__import__("logging").StreamHandler(log))
kmerset_multiple_decompress.main(["--device", "cpu", "--k", "15", d])
tsv = io.StringIO()
with contextlib.redirect_stdout(tsv):
    kmerset_stat.main(["--device", "cpu", "--k", "15", *sets])
rows = [r.split("\t") for r in tsv.getvalue().splitlines()]
want = [f"kmer_set.Hash() = {r[3]}" for r in rows]
assert len(rows) == 2 and all(w in log.getvalue() for w in want), log.getvalue()
assert sys.modules["jax"] is None and sys.modules["kmerset_tpu"] is None
assert "KMERSET_TPU_FORCE_BACKEND" not in os.environ
print(len(names))
"""


def test_port_imports_and_counts_without_jax(tmp_path):
    """With jax and kmerset_tpu blocked: every module imports, parallel/
    and the link formats' included, and the build (also on a slow link)
    and compress (each on one device and on a mesh of two CPU shards; the
    build also as a process group of one), decompress and stat CLIs run
    on the CPU."""
    env = dict(os.environ)
    env.pop("KMERSET_TPU_FORCE_BACKEND", None)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp_path)], capture_output=True,
        text=True, cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "kmer_set_compact -> KmerSet: ok" in proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 36  # slices 1 to 4


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_distributed_child.py")]
    for d, _, files in os.walk(os.path.dirname(kmerset_tpu_torch.__file__)):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return paths


def test_no_jax_package_import_in_port_sources():
    """No module of the port, not chip_smoke.py and not the process-group
    tests' child, imports kmerset_tpu: the port keeps its own copy of the
    host code it needs."""
    pat = re.compile(r"^\s*(import|from) kmerset_tpu(\.|\s|$)", re.M)
    for path in _port_sources():
        with open(path) as f:
            text = f.read()
        assert not pat.search(text), path
        if os.path.basename(path) != "chip_smoke.py":
            assert "KMERSET_TPU_FORCE_BACKEND" not in text, path


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    for path in _port_sources():
        with open(path) as f:
            assert not pat.search(f.read()), path


def test_resolve_device_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        kmerset_tpu_torch.resolve_device("cuda")
    assert kmerset_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        kmerset_tpu_torch.resolve_device("meta")


def test_mesh_needs_a_shard_and_locks_each_device_once():
    """A mesh of no shard raises; shards sharing a device take its lock
    once a step (backend.device_lock is not reentrant)."""
    from kmerset_tpu_torch.ops import backend
    from kmerset_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="at least one shard"):
        Mesh([])
    mesh = Mesh(["cpu", "cpu", "cpu"])
    assert mesh.physical() == {torch.device("cpu"): 3}
    with mesh.lock():
        assert backend.device_lock("cpu").locked()
    assert not backend.device_lock("cpu").locked()


def test_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises; it never falls
    back to the plain version."""
    from kmerset_tpu_torch.ops import compact, pack

    packed = torch.zeros(10, dtype=torch.uint8, device="meta")
    for k in (5, 19):  # kernels B1 and B2
        with pytest.raises(ValueError, match="unsupported device"):
            pack.canonical_windows(packed, 40, k)
    lane = torch.zeros(16, dtype=torch.int32, device="meta")
    keep = torch.zeros(16, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        compact.compact_select([lane], keep)
    with pytest.raises(ValueError, match="unsupported device"):
        compact.compact_select([lane.long(), lane], keep)


def test_chip_smoke_imports_no_reference_module():
    """chip_smoke.py reaches the reference only through the port and the
    reference CLI's subprocess."""
    pat = re.compile(r"^\s*(import|from) kmerset_tpu(\.|\s|$)", re.M)
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        assert not pat.search(f.read())


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd in (ROOT, tmp_path):  # the checkout, and the script alone
        script = os.path.join(ROOT, "chip_smoke.py")
        if cwd != ROOT:
            script = str(tmp_path / "chip_smoke.py")
            with open(os.path.join(ROOT, "chip_smoke.py")) as src:
                with open(script, "w") as dst:
                    dst.write(src.read())
        proc = subprocess.run(
            [sys.executable, script], capture_output=True, text=True,
            cwd=cwd, timeout=300,
        )
        assert proc.returncode != 0
        assert proc.stdout == ""


_POOL = r"""
import json, os, sys
sys.modules["jax"] = None
sys.modules["kmerset_tpu"] = None
mode = sys.argv[1]
if mode == "present":
    import types
    sys.modules["kmerset_pool"] = types.ModuleType("kmerset_pool")
import kmerset_tpu_torch
if mode == "built":
    # No checkout extension: the port compiles pool_alloc.c into its build
    # directory, once.
    from kmerset_tpu_torch import _nativebuild
    native_dir, build = sys.argv[2], sys.argv[3]
    _nativebuild._native_dir = lambda: native_dir
    _nativebuild.BUILD_DIR = build
    os.environ.pop("KMERSET_TPU_POOL")
    kmerset_tpu_torch.pool = kmerset_tpu_torch._install_pool_allocator()
    import numpy as np
    a = np.ones(1 << 19)  # 4 MB: a pooled block
    del a
    b = np.ones(1 << 19)
    again = kmerset_tpu_torch._install_pool_allocator()
    assert again.how == "present", again
p = kmerset_tpu_torch.pool
print(json.dumps({"how": p.how, "path": p.path, "build_s": p.build_s,
                  "stats": p.module.stats() if hasattr(p.module, "stats") else None}))
"""


def _pool(mode: str, *args, env=None) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", _POOL, mode, *args], capture_output=True,
        text=True, cwd=ROOT, env=dict(os.environ, **(env or {})), timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return __import__("json").loads(proc.stdout.strip().splitlines()[-1])


def test_pool_allocator_off_and_one_per_process():
    """KMERSET_TPU_POOL=0 installs nothing; a kmerset_pool module already
    imported (as the reference's import installs it) is kept, not joined
    by a second pool."""
    assert _pool("off", env={"KMERSET_TPU_POOL": "0"})["how"] == "off"
    assert _pool("present", env={"KMERSET_TPU_POOL": "1"})["how"] == "present"


def test_pool_allocator_built_without_the_checkout_extension(tmp_path):
    """Where native/kmerset_pool<EXT_SUFFIX> is missing the port compiles
    native/pool_alloc.c (no OpenMP) into its build directory and installs
    it: numpy's large arrays then come from the pool (its stats count a
    hit when a freed block is reused)."""
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    with open(os.path.join(ROOT, "native", "pool_alloc.c"), "rb") as f:
        (native_dir / "pool_alloc.c").write_bytes(f.read())
    build = tmp_path / "build"
    got = _pool("built", str(native_dir), str(build), env={"KMERSET_TPU_POOL": "0"})
    if got["how"] == "unavailable":
        pytest.skip("pool_alloc.c does not compile here (no Python.h?)")
    assert got["how"] == "built" and got["path"].startswith(str(build))
    assert got["build_s"] is not None and got["stats"]["pool_hits"] >= 1
