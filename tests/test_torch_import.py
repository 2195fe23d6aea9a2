"""The port imports no JAX, and asks for its device explicitly.

tests/conftest.py imports jax into the test process, so the import check
runs in a subprocess with jax blocked.
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
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import kmerset_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    kmerset_tpu_torch.__path__, "kmerset_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from kmerset_tpu_torch.core.kmer_counter import KmerCounter
c = KmerCounter.from_reads(3, ["ACGTTGCA", "AANAC"], True, device="cpu")
# canonical 3-mers of ACGTTGCA: ACG CGT(=ACG) GTT(=AAC) TTG(=CAA) TGC(=GCA) GCA
assert c.kmers.tolist() == [0b000001, 0b000110, 0b010000, 0b100100], c.kmers
assert c.counts.tolist() == [1, 2, 1, 2], c.counts
assert sys.modules["jax"] is None
print(len(names))
"""


def test_port_imports_and_counts_without_jax():
    env = dict(os.environ, KMERSET_TPU_FORCE_BACKEND="host")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 25  # every module of slices 1 to 3


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.dirname(kmerset_tpu_torch.__file__)):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for path in paths:
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


def test_profile_tool_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from kmerset_tpu_torch.tools import profile_count

    with pytest.raises(RuntimeError, match="is_available"):
        profile_count.main([str(tmp_path / "none.fa")])
