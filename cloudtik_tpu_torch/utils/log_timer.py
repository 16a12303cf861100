"""Timed log sections for slow operations.

Reference parity: core/_private/log_timer.py:28 (LogTimer wrapping the
cloud/SSH phases of cluster creation so operators can see where the time
goes).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

logger = logging.getLogger(__name__)


class LogTimer:
    """`with LogTimer("creating head node"):` logs the elapsed time on
    exit (and the failure, if the block raised)."""

    def __init__(self, message: str, *, logger_: Optional[
            logging.Logger] = None, level: int = logging.INFO):
        self.message = message
        self.logger = logger_ or logger
        self.level = level
        self.start = 0.0
        self.elapsed: Optional[float] = None

    def __enter__(self) -> "LogTimer":
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, _exc, _tb) -> None:
        self.elapsed = time.perf_counter() - self.start
        status = "failed" if exc_type else "done"
        self.logger.log(self.level, "%s: %s in %.2fs",
                        self.message, status, self.elapsed)
