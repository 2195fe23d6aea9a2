"""Readings of a cell's numbers compared, for setting their limits: the
control (the reference in the program's place with one guarantee
broken, reference/control.py), each planted fault of the cell's kind,
and with --program one job of the program, all on the same inputs, at
the cell's own size, each judged by the cell's own comparison.  The
benchmark's runs never run it; its readings set each limit (PERF.md).

    python3 kmerbench/control.py --workload W --seed N [N ...] [--program]

prints one JSON line per seed: each reading's numbers and the parts of
its `errors`.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kmerbench import generate, jobs, spec  # noqa: E402
from kmerbench.window import quiet_cli_logger  # noqa: E402


def _reading(kind, job) -> dict:
    parts, numbers = kind.check(job)
    return {"numbers": {"errors": int(sum(parts.values())), **numbers},
            "parts": parts, "ok": job.ok}


def readings(workload: str, seed: int, device: str, program: bool = False,
             root: str = spec.ROOT, overrides=None) -> dict:
    """{"control": ..., "faults": {name: ...}, "program": ...} of one
    seed, each {"numbers", "parts", "ok"} (ok: the job ran to its end)."""
    _, config, mix = spec.Spec(root).resolve(workload, overrides)
    quiet_cli_logger(debug=False)
    work = tempfile.mkdtemp(prefix="kmerbench-control-")
    try:
        fastas, bases = generate.write_fastas(config, mix, seed, work)
        inputs = generate.compress_inputs(fastas, mix.get("input_compressor", ""))
        kind = jobs.KINDS[mix["job"]](config, mix, inputs, fastas, bases, work,
                                      device, seed, False)
        kind.setup()
        out = {"workload": workload, "seed": seed}
        if program:
            out["program"] = _reading(kind, kind.run())
        out["control"] = _reading(kind, kind.control())
        out["faults"] = {name: _reading(kind, kind.fault(name))
                         for name in kind.FAULTS}
        out["stats"] = kind.stats
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--program", action="store_true",
                   help="also run and judge one job of the program")
    args = p.parse_args(argv)
    for seed in args.seed:
        print(json.dumps(readings(args.workload, seed, args.device,
                                  args.program)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
