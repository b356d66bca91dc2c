"""Logging setup (file + stdout sinks).

Behavioural contract: reference `crowdsam/utils.py:164-172` (loguru file sink
at DEBUG + stdout at INFO, memoized).  Built on stdlib logging since loguru
is not a dependency of this framework.  Counterpart of the JAX package's
`utils/logging.py`, under this package's own logger name.

The logger is process-wide, so `setup_logger` owns its sinks: a call with
other arguments than the last closes and removes the handlers that the last
call installed (handlers that other code added stay), and a repeated call
with the same arguments returns the logger as it is.  Without that, a sink
on a stream that its owner has since closed (a test's captured stdout)
breaks every later record.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from datetime import datetime

LOGGER_NAME = "crowdsam_tpu_torch"

# (save_path, quiet) of the last call and the handlers it installed.
_installed = {"key": None, "handlers": []}


def setup_logger(save_path: str, quiet: bool = False) -> logging.Logger:
    logger = logging.getLogger(LOGGER_NAME)
    key = (save_path, quiet)
    if _installed["key"] == key and _installed["handlers"] and all(
            h in logger.handlers for h in _installed["handlers"]):
        return logger
    for h in _installed["handlers"]:
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s-%(levelname)s-%(message)s")

    os.makedirs(save_path, exist_ok=True)
    ts = datetime.fromtimestamp(time.time()).strftime("%Y-%m-%d_%H-%M-%S")
    fh = logging.FileHandler(os.path.join(save_path, f"{ts}.log"))
    fh.setLevel(logging.DEBUG)
    fh.setFormatter(fmt)
    handlers = [fh]

    if not quiet:
        sh = logging.StreamHandler(sys.stdout)
        sh.setLevel(logging.INFO)
        sh.setFormatter(fmt)
        handlers.append(sh)
    for h in handlers:
        logger.addHandler(h)
    _installed.update(key=key, handlers=handlers)
    return logger


def get_logger() -> logging.Logger:
    """Module logger that works before/without setup_logger."""
    logger = logging.getLogger(LOGGER_NAME)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
