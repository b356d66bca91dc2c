"""Logging setup (file + stdout sinks).

Behavioural contract: reference `crowdsam/utils.py:164-172` (loguru file sink
at DEBUG + stdout at INFO, memoized).  Built on stdlib logging since loguru
is not a dependency of this framework.  Counterpart of the JAX package's
`utils/logging.py`, under this package's own logger name.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
import time
from datetime import datetime

LOGGER_NAME = "crowdsam_tpu_torch"


@functools.lru_cache()
def setup_logger(save_path: str, quiet: bool = False) -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s-%(levelname)s-%(message)s")

    os.makedirs(save_path, exist_ok=True)
    ts = datetime.fromtimestamp(time.time()).strftime("%Y-%m-%d_%H-%M-%S")
    fh = logging.FileHandler(os.path.join(save_path, f"{ts}.log"))
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(fmt)
    logger.addHandler(fh)

    if not quiet:
        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(logging.INFO)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
    return logger


def get_logger() -> logging.Logger:
    """Module logger that works before/without setup_logger."""
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
