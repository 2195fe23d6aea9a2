"""kmerset-build on a CUDA device with and without the pooling NumPy
allocator, in turns.

    python -m kmerset_tpu_torch.tools.time_pool [--k 15] [--turns 2] FASTA

The allocator is installed when the package is imported
(kmerset_tpu_torch.pool), so each build runs in a process of its own:
`kmerset-build --device cuda --k K --check --debug` on FASTA, with
KMERSET_TPU_POOL=0 ("off") and with the pool ("on").  Each turn runs
them in the order off, on, on, off, after one build that is not timed.
It prints the card's name and power limit, one line per build (the
CLI's wall in its process, after imports; the device front-end's
upload, device and download and the host chain walk, emission and path
cover of the debug lines; the peak device memory; how the pool was
installed and its stats), the medians of each setting, and one JSON
line of every build.  Every dump must be byte-identical.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

_RUN = r"""
import json, sys, time
t0 = time.perf_counter()
import kmerset_tpu_torch
from kmerset_tpu_torch.cli import kmerset_build
t1 = time.perf_counter()
kmerset_build.main(sys.argv[1:])
import torch
p = getattr(kmerset_tpu_torch, "pool", None)
print(json.dumps({"import_s": t1 - t0, "cli_s": time.perf_counter() - t1,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                  "pool": p.how if p else "none",
                  "stats": p.module.stats() if p and p.module else None}))
"""
_PHASES = ("unitigs: device front-end", "unitigs: chain walk",
           "unitigs: emission + cycles", "spss: path cover")
_FRONT_END = re.compile(r"unitigs: device front-end upload ([\d.]+) s, "
                        r"device ([\d.]+) s, download ([\d.]+) s")
_SHOWN = ("cli_s", "upload", "device", "download", *_PHASES, "peak_gib")


def _phases(stderr: str) -> dict:
    """Seconds of the SPSS build's debug phase lines and of the
    front-end's upload, device and download."""
    out = {}
    for line in stderr.splitlines():
        for name in _PHASES:
            m = re.search(re.escape(name) + r": ([\d.]+)s$", line)
            if m:
                out[name] = out.get(name, 0.0) + float(m.group(1))
        m = _FRONT_END.search(line)
        if m:
            out.update(zip(("upload", "device", "download"), map(float, m.groups())))
    return out


def run_once(fasta: str, k: int, setting: str, root: str, out: str) -> dict:
    """One build in a process of its own, from the checkout at `root`."""
    env = dict(os.environ, KMERSET_TPU_POOL="0" if setting == "off" else "1")
    proc = subprocess.run(
        [sys.executable, "-c", _RUN, "--device", "cuda", "--k", str(k), "--check",
         "--debug", "--out", out, os.path.abspath(fasta)],
        capture_output=True, text=True, env=env, cwd=root, timeout=900,
    )
    if proc.returncode != 0 or "kmer_set_compact -> KmerSet: ok" not in proc.stderr:
        raise RuntimeError(f"kmerset-build ({setting}) failed:\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    res.update(_phases(proc.stderr), setting=setting)
    return res


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--k", type=int, default=15, choices=(15, 19, 23, 31))
    parser.add_argument("--turns", type=int, default=2)
    parser.add_argument("fasta")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this tool times "
                           "builds on a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    settings = ("off", "on")
    runs, want = [], None
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "dump.txt")
        # Not timed: the checkout's first process may build its host
        # library, the pool and its kernels.
        run_once(args.fasta, args.k, "on", here, out)
        for _ in range(args.turns):
            for setting in settings + settings[::-1]:
                r = run_once(args.fasta, args.k, setting, here, out)
                with open(out, "rb") as f:
                    data = f.read()
                if want is None:
                    want = data
                elif data != want:
                    raise RuntimeError(f"the dump of the {setting} build differs")
                runs.append(r)
                print(f"{setting:6s} (pool {r['pool']}): " + ", ".join(
                    f"{n} {r[n]:.4f}" for n in _SHOWN if n in r)
                    + f"; pool stats {r['stats']}", flush=True)
    for setting in settings:
        sel = [r for r in runs if r["setting"] == setting]
        print(f"median, {setting} ({len(sel)} builds): " + ", ".join(
            f"{n} {statistics.median(r[n] for r in sel):.4f}"
            for n in _SHOWN if all(n in r for r in sel)), flush=True)
    print(json.dumps(runs), flush=True)


if __name__ == "__main__":
    main()
