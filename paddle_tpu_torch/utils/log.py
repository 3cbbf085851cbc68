"""Logging: counterpart of ``paddle_tpu/utils/log.py``. One
``logging.Logger`` a name, with a stderr handler, its level from
``level`` or ``PADDLE_TPU_LOG_LEVEL`` (default INFO)."""
from __future__ import annotations

import logging
import os
import sys

from .memo import LockedLRU

__all__ = ["get_logger"]

# logger names are a bounded keyspace: no eviction
_LOGGERS = LockedLRU(maxsize=None)


def get_logger(name: str = "paddle_tpu_torch", level=None):
    def _build():
        logger = logging.getLogger(name)
        if not logger.handlers:
            h = logging.StreamHandler(sys.stderr)
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s] %(message)s"))
            logger.addHandler(h)
        lvl = level or os.environ.get("PADDLE_TPU_LOG_LEVEL", "INFO")
        logger.setLevel(lvl.upper() if isinstance(lvl, str) else lvl)
        logger.propagate = False
        return logger

    return _LOGGERS.get_or_create(name, _build)
