"""stderr logger mirroring the reference's spdlog setup
(reference: lib/log.h:9-15): pattern `[date time] [level] [tid] message`,
info level by default, debug gate via --debug.

The port's copy of kmerset_tpu/utils/log.py:1-40, unchanged: the port's
CLIs log the reference's lines to the same "kmerset" logger."""

from __future__ import annotations

import logging
import sys
import threading


def init_default_logger() -> logging.Logger:
    logger = logging.getLogger("kmerset")
    if logger.handlers:
        return logger
    handler = logging.StreamHandler(sys.stderr)

    class _Fmt(logging.Formatter):
        def format(self, record):
            record.tid = threading.get_native_id()
            return super().format(record)

    handler.setFormatter(
        _Fmt("[%(asctime)s] [%(levelname)s] [%(tid)d] %(message)s",
             datefmt="%Y-%m-%d %H:%M:%S")
    )
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    return logger


def enable_debug_logs() -> None:
    logging.getLogger("kmerset").setLevel(logging.DEBUG)


def get_logger() -> logging.Logger:
    """The package logger (a no-handler logger is silent until a CLI
    calls init_default_logger, matching library-vs-app behavior)."""
    return logging.getLogger("kmerset")
