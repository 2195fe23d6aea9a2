"""The kernels' build (kmerset_tpu_torch/ops/_build.py) with a stand-in
compiler: one compile per source, started together, then one link; the
log keeps every step's output, the objects are removed, and a failed
compile raises with no library left behind.  The real nvcc exists only on
the card's machine, where chip_smoke.py builds with it."""

import os
import stat
import sys

import pytest

from kmerset_tpu_torch.ops import _build

_FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
if "-c" in args:
    src = args[-1]
    text = open(src).read()
    if "#error" in text:
        print(src + ": error: stop")
        sys.exit(2)
    time.sleep(0.2)
    print("ptxas info    : Used 17 registers (" + src.split("/")[-1] + ")")
    open(out, "w").write(text)
else:
    assert "-shared" in args
    objs = args[args.index("-o") + 2:]
    open(out, "w").write("".join(open(o).read() for o in objs))
"""


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return csrc


def test_build_compiles_each_source_then_links(fake_tree):
    out = _build.library_path()
    _build._compile(out)
    assert open(out).read() == "// a.cu\n// b.cu\n"
    log = _build.build_log()
    assert "Used 17 registers (a.cu)" in log and "Used 17 registers (b.cu)" in log
    assert log.count(" -c ") == 2 and log.count(" -shared ") == 1
    left = os.listdir(os.path.dirname(out))
    assert not [f for f in left if f.endswith((".o", ".tmp"))], left


def test_build_failure_raises_and_leaves_no_library(fake_tree):
    (fake_tree / "b.cu").write_text("#error broken\n")
    out = _build.library_path()
    with pytest.raises(RuntimeError, match="nvcc failed with exit code 2"):
        _build._compile(out)
    assert not os.path.exists(out)
    assert "error: stop" in _build.build_log()
    assert not [f for f in os.listdir(os.path.dirname(out))
                if f.endswith((".o", ".tmp", ".so"))]


def _extern_entries():
    """{name: parameter count} of every extern "C" function in csrc/*.cu."""
    import re

    found = {}
    for src in _build._sources():
        text = open(src).read()
        for m in re.finditer(r'extern "C"[^(]*?\b(\w+)\(([^)]*)\)', text):
            params = [p for p in m.group(2).split(",") if p.strip()]
            found[m.group(1)] = len(params)
    return found


def test_bind_table_names_exactly_the_sources_entry_points():
    """A renamed, added or removed entry, or one whose parameter count
    changed, fails here and not only when the library loads on the card."""
    entries = _extern_entries()
    assert set(entries) == set(_build.SIGNATURES)
    for name, (argtypes, _) in _build.SIGNATURES.items():
        assert len(argtypes) == entries[name], name
    assert "kmerset_compact" in entries
    assert not {"kmerset_compact_count", "kmerset_compact_scatter",
                "kmerset_compact_tile"} & set(entries)
