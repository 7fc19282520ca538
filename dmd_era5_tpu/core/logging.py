"""Structured per-module logging.

Behavioral parity with the reference logger
(/root/reference/src/dmd_era5/logger.py:7-46): named loggers writing to
``<root>/logs/<file>.log`` with the directory auto-created, handlers reset
on re-setup, and a ``log_and_print`` helper that mirrors messages to
stdout.  Extended with the process index in the log
format so multi-host runs produce attributable lines.
"""

from __future__ import annotations

import logging

from dmd_era5_tpu.core.paths import logs_dir

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


def _process_tag() -> str:
    """Best-effort JAX process index tag, empty for single-process runs."""
    try:
        import jax

        idx = jax.process_index()
        return f"[p{idx}] " if jax.process_count() > 1 else ""
    except Exception:
        return ""


def setup_logger(
    name: str, log_file: str, level: int = logging.INFO
) -> logging.Logger:
    """Create (or reconfigure) a named logger writing to ``logs/<log_file>``."""
    formatter = logging.Formatter(_FORMAT)
    path = logs_dir() / log_file

    logger = logging.getLogger(name)
    logger.setLevel(level)

    # Reset handlers so repeated setup calls do not duplicate output.
    for handler in list(logger.handlers):
        logger.removeHandler(handler)

    file_handler = logging.FileHandler(path)
    file_handler.setFormatter(formatter)
    logger.addHandler(file_handler)
    return logger


def log_and_print(logger: logging.Logger, message: str, level: str = "info") -> None:
    """Log ``message`` at ``level`` and mirror it to stdout."""
    getattr(logger, level.lower())(message)
    print(f"{_process_tag()}{message}")
