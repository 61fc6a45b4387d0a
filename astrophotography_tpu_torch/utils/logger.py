"""Single logging module for the whole framework.

The reference duplicates console-handler setup (``_initialize_logger``)
in every Ap* class and additionally keeps a global singleton
(reference core/logger.py:16-84).  Here there is ONE place that
configures logging; everything else calls :func:`get_logger`.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional, TextIO

_FORMAT = "%(asctime)s | %(levelname)s | %(name)s | %(message)s"

_ROOT_NAME = "astrophotography_tpu_torch"


class AstroLogger:
    """Application-wide logger with an explicit start/stop lifecycle.

    Mirrors the semantics of the reference Logger singleton
    (reference core/logger.py:16-84): a NullHandler is installed by
    default so library use emits nothing; ``start(level)`` attaches a
    stream handler; ``stop()`` detaches it.  ``start`` may be called
    repeatedly to change level/stream (the reference restarts the
    logger after config load, reference cli.py:54-61).
    """

    def __init__(self, name: str = _ROOT_NAME) -> None:
        self._logger = logging.getLogger(name)
        self._logger.addHandler(logging.NullHandler())
        self._logger.propagate = False
        self._handler: Optional[logging.Handler] = None

    @property
    def logger(self) -> logging.Logger:
        return self._logger

    @property
    def running(self) -> bool:
        return self._handler is not None

    def start(self, level: str = "INFO", stream: Optional[TextIO] = None) -> None:
        if self._handler is not None:
            self.stop()
        handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        self._logger.addHandler(handler)
        self._logger.setLevel(getattr(logging, level.upper(), logging.INFO))
        self._handler = handler

    def stop(self) -> None:
        if self._handler is not None:
            self._handler.close()
            self._logger.removeHandler(self._handler)
            self._handler = None

    def __getattr__(self, item):
        # Delegate .info/.debug/.warning/... to the underlying logger.
        return getattr(self._logger, item)


#: Global application logger (the only singleton).
logger = AstroLogger()


def get_logger(name: str) -> logging.Logger:
    """Child logger under the application root; inherits handlers."""
    child = logging.getLogger(f"{_ROOT_NAME}.{name}")
    child.propagate = True
    return child
