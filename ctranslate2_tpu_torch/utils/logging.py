"""Logging configuration (parity with reference: src/logging.cc:54-82).

The level comes from ``CT2TPU_VERBOSE`` (the reference's ``CT2_VERBOSE``
scale, -3..3) or from :func:`set_log_level`.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("ctranslate2_tpu_torch")

_LEVELS = {
    -3: logging.CRITICAL + 10,  # off
    -2: logging.CRITICAL,
    -1: logging.ERROR,
    0: logging.WARNING,
    1: logging.INFO,
    2: logging.DEBUG,
    3: logging.DEBUG,
}


def set_log_level(level: int) -> None:
    """Set the runtime log level. Accepts standard :mod:`logging` levels
    (``logging.INFO``, ...: the reference binding's convention,
    python/cpp/logging.cc) or the reference's ``CT2_VERBOSE`` -3..3
    scale."""
    if -3 <= level <= 3:
        level = _LEVELS.get(level, logging.WARNING)
    logger.setLevel(level)


def get_log_level() -> int:
    """Current level as a standard :mod:`logging` level (reference:
    ctranslate2.get_log_level returns logging.WARNING by default)."""
    return logger.level or logging.WARNING


def _init() -> None:
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "[%(asctime)s] [ctranslate2_tpu_torch] [%(levelname)s] %(message)s"))
    logger.addHandler(handler)
    try:
        set_log_level(int(os.environ.get("CT2TPU_VERBOSE", "0")))
    except ValueError:
        set_log_level(0)


_init()
