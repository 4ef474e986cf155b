"""Logging: the reference's stdout banners with localtime brackets
(chromosome3D.pl:48-53, 100-108) as standard logging with a stdout handler —
the port's copy of chromosome3d_tpu/utils/logging.py's get_logger and
banner."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "chromosome3d_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter("[%(asctime)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def banner(logger: logging.Logger, message: str) -> None:
    logger.info(message)
