"""ap_auto_badcol: auto-detect bad columns/rows in a master frame.

Reference surface (scripts/ap_auto_badcol.py:56-68): positional image,
--sigma 5, --window 11.  Adds --output_yaml to emit the detections in
the user-badpix YAML convention.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..core.badpix_engine import auto_badcol_file


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_auto_badcol",
        description="Detect bad columns and rows from sliding-window "
                    "statistics of per-column/row medians")
    p.add_argument("image", help="input master FITS image")
    p.add_argument("--sigma", type=float, default=5.0,
                   help="bad column/row significance threshold (default 5)")
    p.add_argument("--window", type=int, default=11,
                   help="sliding window width (default 11)")
    p.add_argument("--output_yaml", default=None,
                   help="write detections to this user-badpix YAML file")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    auto_badcol_file(ns.image, sigma=ns.sigma, window=ns.window,
                     output_yaml=ns.output_yaml, device=ns.device)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
