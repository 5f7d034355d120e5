"""Structured logging + RAII-style timers (reference: include/core/logger.hpp spdlog wrapper
with LOG_TRACE..CRITICAL levels and LOG_TIMER, SURVEY.md §5.5)."""

from __future__ import annotations

import logging
import os
import sys
import time
from contextlib import contextmanager

_ROOT = "tpu_splat_torch"
_CONFIGURED = False


def configure(level: str = "info", log_file: str | None = None) -> None:
    """Console + optional file sinks (`--log-level`, argument_parser.cpp:183-204)."""
    global _CONFIGURED
    root = logging.getLogger(_ROOT)
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s] [%(levelname).1s] %(name)s: %(message)s", "%H:%M:%S")
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(fmt)
    root.addHandler(h)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        root.addHandler(fh)
    _CONFIGURED = True


def get_logger(name: str = _ROOT) -> logging.Logger:
    if not _CONFIGURED:
        configure(os.environ.get("TPU_SPLAT_LOG", "info"))
    if name.startswith(_ROOT):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT}.{name}")


@contextmanager
def log_timer(label: str, logger: logging.Logger | None = None, level: int = logging.DEBUG):
    """LOG_TIMER equivalent (logger.hpp:195-240)."""
    logger = logger or get_logger()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.log(level, "%s took %.1f ms", label, (time.perf_counter() - t0) * 1e3)
