"""CLI flag plumbing: the reference's (kmerset_tpu/utils/flags.py), with a
--trace that records a torch.profiler trace instead of a jax.profiler one
(:131-142)."""

from __future__ import annotations

import contextlib
import os

import torch

from kmerset_tpu.utils.flags import (  # noqa: F401 - re-exported
    add_bool_flag,
    add_common_flags,
    apply_workers,
    check_k,
    parse_args,
)

TRACE_FILE = "trace.json"


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
