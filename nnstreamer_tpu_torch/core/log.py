"""Logging: one framework-wide logger tree (``nnstreamer_tpu_torch.*``)."""

from __future__ import annotations

import logging
import os
import traceback

_ROOT = "nnstreamer_tpu_torch"


def get_logger(name: str = "") -> logging.Logger:
    return logging.getLogger(f"{_ROOT}.{name}" if name else _ROOT)


def log_error_with_trace(logger: logging.Logger, msg: str, *args) -> None:
    """An error and the current stack (the ml_loge_stacktrace analog)."""
    stack = "".join(traceback.format_stack()[:-1])
    logger.error(msg + "\nstack:\n%s", *args, stack)


def _init_from_env() -> None:
    """NNSTREAMER_TPU_TORCH_LOG=debug|info|warning|error sets the level."""
    level = os.environ.get("NNSTREAMER_TPU_TORCH_LOG", "").upper()
    if level and hasattr(logging, level):
        logging.basicConfig()
        get_logger().setLevel(getattr(logging, level))


_init_from_env()
