"""Logging (``akari_tpu/utils/logger.py``): stdlib logging with an
elapsed-time formatter, ANSI colours on a terminal, a ``VERBOSE`` level
and pluggable observer handlers.

The logger is named ``akari_torch`` (the JAX package's is ``akari``), so
a process that imports both packages keeps one handler on each. Records
also propagate to the root logger, where an application's (or pytest's)
handlers see them.
"""

from __future__ import annotations

import logging
import sys
import time

_START = time.monotonic()
_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"

VERBOSE = 15
logging.addLevelName(VERBOSE, "VERBOSE")


class _ElapsedFormatter(logging.Formatter):
    def format(self, record):
        elapsed = time.monotonic() - _START
        color = _COLORS.get(record.levelno, "")
        use_color = sys.stderr.isatty()
        prefix = f"[{elapsed:9.3f}s {record.levelname}] "
        msg = record.getMessage()
        if use_color and color:
            return f"{color}{prefix}{msg}{_RESET}"
        return prefix + msg


_logger = None


def get_logger(name="akari_torch"):
    global _logger
    if _logger is None:
        lg = logging.getLogger(name)
        lg.setLevel(logging.INFO)
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(_ElapsedFormatter())
        lg.addHandler(h)
        _logger = lg
    return _logger


def set_verbose(enabled=True):
    get_logger().setLevel(logging.DEBUG if enabled else logging.INFO)


def add_handler(handler):
    """Attach an observer handler."""
    get_logger().addHandler(handler)
