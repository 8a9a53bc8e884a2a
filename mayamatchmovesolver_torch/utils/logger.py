"""Logging with the reference's level semantics.

Mirrors mmSolver's 5-level LogLevel enum kept numerically in sync
between C++ and Python (ref: src/mmSolver/adjust/adjust_data.h:90-100,
python/mmSolver/logger.py get_logger, constant.py
LOG_LEVEL_NAME_TO_VALUE_MAP).

Port of mayamatchmovesolver_tpu/utils/logger.py: a copy of the
reference's host code, on the port's config.
"""

import enum
import logging

from mayamatchmovesolver_torch.utils import config


class LogLevel(enum.IntEnum):
    """(ref: adjust_data.h:93-100.)"""

    ERROR = 0
    WARNING = 1
    INFO = 2
    VERBOSE = 3
    DEBUG = 4


LOG_LEVEL_NAME_TO_VALUE_MAP = {
    "error": LogLevel.ERROR,
    "warning": LogLevel.WARNING,
    "info": LogLevel.INFO,
    "verbose": LogLevel.VERBOSE,
    "debug": LogLevel.DEBUG,
}

_TO_PY_LEVEL = {
    LogLevel.ERROR: logging.ERROR,
    LogLevel.WARNING: logging.WARNING,
    LogLevel.INFO: logging.INFO,
    LogLevel.VERBOSE: logging.INFO - 5,
    LogLevel.DEBUG: logging.DEBUG,
}

logging.addLevelName(logging.INFO - 5, "VERBOSE")


def get_logger(name="mmsolver_tpu"):
    """(ref: python/mmSolver/logger.py get_logger.)"""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(name)s: %(levelname)s: %(message)s")
        )
        logger.addHandler(handler)
        level_name = str(config.get("logging/level", "info")).lower()
        level = LOG_LEVEL_NAME_TO_VALUE_MAP.get(level_name, LogLevel.INFO)
        logger.setLevel(_TO_PY_LEVEL[level])
    return logger


def set_log_level(level):
    """level: LogLevel value or name string."""
    if isinstance(level, str):
        level = LOG_LEVEL_NAME_TO_VALUE_MAP[level.lower()]
    get_logger().setLevel(_TO_PY_LEVEL[LogLevel(level)])
