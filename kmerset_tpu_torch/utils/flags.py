"""CLI flag plumbing: the reference's (kmerset_tpu/utils/flags.py), with a
--trace that records a torch.profiler trace instead of a jax.profiler one
(:131-142), and the port's --device flag."""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from kmerset_tpu.utils.flags import (  # noqa: F401 - re-exported
    add_bool_flag,
    add_common_flags,
    apply_workers,
    check_k,
    parse_args,
)

from .. import resolve_device
from ..ops.pack import MAX_K

TRACE_FILE = "trace.json"


def add_device_flag(parser) -> None:
    parser.add_argument(
        "--device",
        default="cuda",
        help="torch device for counting and decoding: cuda (default) or cpu",
    )


def device_or_exit(args, logger) -> torch.device:
    """The device of --device, after checking that --k is ported; exits 1
    on a k above MAX_K or a device that is not there (never a quiet CPU
    run in place of CUDA)."""
    if args.k > MAX_K:
        print(f"k={args.k} is not ported: this package counts k <= {MAX_K}",
              file=sys.stderr)
        raise SystemExit(1)
    try:
        return resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        logger.error("%s", e)
        sys.exit(1)


@contextlib.contextmanager
def trace_context(args, device: torch.device):
    """With --trace DIR: records CPU activity, and CUDA kernels when
    `device` is a CUDA device, and writes DIR/trace.json (Chrome trace
    format) on exit.  A no-op without --trace."""
    trace_dir = getattr(args, "trace", "")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
