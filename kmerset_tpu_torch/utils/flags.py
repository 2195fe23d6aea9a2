"""CLI flag plumbing (reference: lib/flags.h:12-53).

The port's copy of kmerset_tpu/utils/flags.py:1-160, without its JAX
parts (by design): honor_platform_env (:61-83), which re-pins JAX's
platform, and the jax.profiler trace (:131-142), which is a
torch.profiler trace here.
Added: the port's --device flag, which every CLI also takes as a
comma-separated list of shards (a mesh).  The flag surface is otherwise the
reference's, with the same help strings; boolean flags accept --flag /
--noflag / --flag=true|false like absl.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import sys
from typing import List, Optional, Tuple

import torch

from .. import resolve_device
from ..core import native
from ..core.config import CLI_SUPPORTED_K
from ..parallel.driver import auto_mesh, maybe_init_distributed
from ..parallel.mesh import Mesh
from . import trace

TRACE_FILE = "trace.json"

FLAG_MESSAGES = {
    "k": "the length of k-mers",
    "debug": "enable debugging messages",
    "compressor": (
        'a program to compress output files; e.g., "bzip2" for bzip2, '
        '"gzip" for gzip, and "" for no compression'
    ),
    "decompressor": (
        'a program to decompress input files; e.g., "bzip2 -d" for bzip2, '
        '"gzip -d" for gzip, and "" for no decompression'
    ),
    "workers": "number of threads to use",
    "canonical": "set this flag when handling canonical k-mers",
}


def get_flag_message(name: str) -> str:
    return FLAG_MESSAGES.get(name, "")


def _str2bool(v: str) -> bool:
    if v.lower() in ("true", "t", "1", "yes"):
        return True
    if v.lower() in ("false", "f", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"invalid boolean: {v}")


def add_bool_flag(parser: argparse.ArgumentParser, name: str, default: bool, help_: str):
    parser.add_argument(
        f"--{name}",
        nargs="?",
        const=True,
        default=default,
        type=_str2bool,
        help=help_,
    )
    parser.add_argument(
        f"--no{name}", dest=name, action="store_false", help=argparse.SUPPRESS
    )
    if not hasattr(parser, "_bool_flags"):
        parser._bool_flags = set()  # type: ignore[attr-defined]
    parser._bool_flags.add(name)  # type: ignore[attr-defined]


def parse_args(parser: argparse.ArgumentParser, argv: List[str] | None = None):
    """parse_args with absl bool-flag semantics: a bare `--flag` never
    consumes the following token (argparse's nargs='?' would swallow a
    positional, e.g. `--canonical dir`); it is rewritten to `--flag=true`
    (reference absl behavior, lib/flags.h:12-22)."""
    if argv is None:
        argv = sys.argv[1:]
    bools = getattr(parser, "_bool_flags", set())
    argv = [a + "=true" if a.startswith("--") and a[2:] in bools else a for a in argv]
    return parser.parse_args(argv)


def add_common_flags(
    parser: argparse.ArgumentParser,
    *,
    compressor: bool = False,
    canonical: bool = True,
) -> None:
    parser.add_argument("--k", type=int, default=15, help=get_flag_message("k"))
    add_bool_flag(parser, "debug", False, get_flag_message("debug"))
    parser.add_argument(
        "--decompressor", default="", help=get_flag_message("decompressor")
    )
    if compressor:
        parser.add_argument(
            "--compressor", default="", help=get_flag_message("compressor")
        )
    parser.add_argument(
        "--workers", type=int, default=1, help=get_flag_message("workers")
    )
    parser.add_argument(
        "--trace",
        default="",
        help="capture a torch.profiler trace of the run into this directory"
        " (trace.json); with --debug it holds the program's spans too",
    )
    if canonical:
        add_bool_flag(parser, "canonical", True, get_flag_message("canonical"))


def add_device_flag(parser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="torch device for counting and decoding: cuda (default) or cpu;"
        " a comma-separated list (e.g. cuda:0,cuda:1 or cpu,cpu,cpu,cpu)"
        " runs on a mesh of those shards",
    )


def apply_workers(args) -> None:
    """Applies --workers to the native OpenMP pool (the reference sizes
    its thread pools from this flag, lib/flags.h:25-53)."""
    native.set_threads(getattr(args, "workers", 1))


def check_k(k: int) -> None:
    if k not in CLI_SUPPORTED_K:
        # Exit code 1 like the reference (kmerset-build.cc:140-142).
        print(f"unsupported k value: {k}", file=sys.stderr)
        raise SystemExit(1)


def devices_or_exit(args, logger, distributed: bool = False
                    ) -> Tuple[torch.device, Optional[Mesh]]:
    """(device, mesh) of --device.  A comma-separated list of more than one
    entry is a mesh of those shards, routed to whatever the input's size
    (the port's counterpart of the reference's forced mesh of a chosen
    number of devices), and device is its first shard.
    One entry is the single-device path; a plain `cuda` with two or more
    GPUs visible also gets an automatic mesh over them, taken above the
    reference's size gates (parallel/driver.auto_mesh).  Exits 1 on an
    entry that is not there, with the message a single such device gets
    (never a quiet CPU run in place of CUDA).  Every k of check_k is
    ported.

    distributed (the CLIs that join a group in the reference,
    kmerset-build and kmerset-multiple-compress): where
    KMERSET_TPU_DISTRIBUTED brings a process group up
    (parallel/driver.maybe_init_distributed), --device names this rank's
    shards, and the mesh spans the group, forced; one entry is then a
    mesh of one local shard, never the single-device path."""
    names = [x.strip() for x in str(args.device).split(",")]
    try:
        devs = [resolve_device(x) for x in names]
    except (RuntimeError, ValueError) as e:
        logger.error("%s", e)
        sys.exit(1)
    if distributed and maybe_init_distributed(devs):
        import torch.distributed as dist

        return devs[0], Mesh(devs, group=dist.group.WORLD)
    if len(devs) > 1:
        return devs[0], Mesh(devs)
    return devs[0], auto_mesh(devs[0])


@contextlib.contextmanager
def trace_context(args, device: torch.device, cli: str, started: int):
    """The whole body of one CLI call after device resolution: its root
    span "cli.<cli>" (utils/trace.py), from `started` (the call's entry,
    a perf_counter_ns reading, so that argument parsing and device
    resolution are inside it too), recorded when the "kmerset" logger is
    at debug level (--debug), which logs the call's spans and counters as
    one "trace: " line at its end.  With --trace DIR it also
    records a torch.profiler trace (CPU activity, and CUDA kernels and
    copies when `device` is a CUDA device) around the call and writes
    DIR/trace.json (Chrome trace format) on exit; under --debug the
    program's spans are ranges in it too."""
    on = logging.getLogger("kmerset").isEnabledFor(logging.DEBUG)
    trace_dir = getattr(args, "trace", "")
    if not trace_dir:
        with trace.root(f"cli.{cli}", on, started):
            yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        with trace.root(f"cli.{cli}", on, started):
            yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
