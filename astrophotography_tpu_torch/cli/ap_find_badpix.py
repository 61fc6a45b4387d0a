"""ap_find_badpix: build a bad-pixel mask from a master dark/bias.

Reference surface (scripts/ap_find_badpix.py:53-67): positional
master + output mask, --sigma (default 4), --user_badpix YAML.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..core.badpix_engine import find_badpix


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_find_badpix",
        description="Generate a bad pixel mask from a master dark or bias")
    p.add_argument("master", help="input master dark/bias FITS file")
    p.add_argument("output", help="output bad pixel mask FITS file")
    p.add_argument("--sigma", type=float, default=4.0,
                   help="sigma threshold for bad pixels (default 4)")
    p.add_argument("--user_badpix", default=None,
                   help="user bad-pixel YAML (bad_columns/bad_rows/"
                        "bad_rectangles, 1-based inclusive)")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    find_badpix(ns.master, ns.output, sigma=ns.sigma,
                user_badpix=ns.user_badpix, device=ns.device)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
