"""Console/file logging.

Unlike the reference (``nldsc/core/logger.py:42-46``), no log file is created
at *import* time; file logging is opt-in via :func:`enable_file_logging`.
"""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "nldsc_jax"

_FMT = "%(asctime)s [%(levelname).1s] %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"


def get_logger(name: str | None = None) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        logger.setLevel(logging.DEBUG)
        console = logging.StreamHandler(sys.stderr)
        console.setLevel(logging.INFO)
        console.setFormatter(logging.Formatter(_FMT, _DATEFMT))
        logger.addHandler(console)
        logger.propagate = False
    if name:
        return logger.getChild(name)
    return logger


def enable_file_logging(path: str = "nldsc.log") -> None:
    """Add an INFO file handler (reference writes ``./nldsc.log`` always)."""
    logger = get_logger()
    fh = logging.FileHandler(path)
    fh.setLevel(logging.INFO)
    fh.setFormatter(logging.Formatter(_FMT, _DATEFMT))
    logger.addHandler(fh)


log = get_logger()
