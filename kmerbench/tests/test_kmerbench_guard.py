"""The check for JAX and the JAX package compares top-level names whole."""

import pytest

from kmerbench import guard


def test_whole_top_level_names():
    assert guard.forbidden_modules(["kmerset_tpu_torch", "kmerset_tpu_torch.ops",
                                    "jaxtyping", "flaxen", "numpy"]) == []
    assert guard.forbidden_modules(["kmerset_tpu.core.kmer", "jax.numpy",
                                    "jaxlib", "flax"]) == [
        "flax", "jax.numpy", "jaxlib", "kmerset_tpu.core.kmer"]


def test_require_clean_exits(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "jax", object())
    with pytest.raises(SystemExit) as e:
        guard.require_clean("after the window")
    assert e.value.code != 0


def test_the_harness_loads_neither():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.'); "
            "import kmerbench.harness, kmerbench.control, kmerbench.readers; "
            "from kmerbench import guard; print(guard.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=guard.__file__.rsplit("/kmerbench/", 1)[0])
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, '.'); "
            "import kmerbench.reference.check, kmerbench.reference.control; "
            "print(sorted(m for m in sys.modules if m.startswith('kmerset')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=guard.__file__.rsplit("/kmerbench/", 1)[0])
    assert out.stdout.strip() == "[]"
