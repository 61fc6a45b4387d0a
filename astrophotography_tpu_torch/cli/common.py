"""Shared CLI plumbing for the ap_* tools.

Every tool follows the reference pattern (reference
scripts/ap_calibrate.py:40-155 etc.): argparse wrapper, logger start,
log-and-exit-1 on error (reference cli.py:68-72).
"""

from __future__ import annotations

import argparse
import functools
from typing import Callable, List, Optional

from ..utils.logger import logger


def add_loglevel(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-l", "--loglevel", default="INFO",
                        choices=["DEBUG", "INFO", "WARNING", "ERROR",
                                 "CRITICAL"],
                        help="logging level")


def add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="device the tool computes on (default cuda; "
                             "cpu only when asked for)")


def cli_main(run: Callable[[argparse.Namespace], None],
             parse: Callable[[Optional[List[str]]], argparse.Namespace]):
    """Wrap a tool body with logger lifecycle + error handling."""

    @functools.wraps(run)
    def main(argv: Optional[List[str]] = None) -> int:
        ns = parse(list(argv) if argv is not None else None)
        logger.start(getattr(ns, "loglevel", "INFO"))
        try:
            run(ns)
        except Exception as exc:
            logger.error(f"{type(exc).__name__}: {exc}")
            return 1
        finally:
            logger.stop()
        return 0

    return main
