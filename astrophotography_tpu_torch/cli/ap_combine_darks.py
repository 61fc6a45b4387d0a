"""ap_combine_darks: build a master bias/dark/flat from a directory.

Reference surface: scripts/ap_combine_darks.py (positional rootdir +
master output, --temptol).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..core.masters import make_master


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_combine_darks",
        description="Combine calibration frames into a master (sigma-clipped"
                    " average)")
    p.add_argument("rootdir", help="directory of input FITS frames")
    p.add_argument("master", help="output master FITS file")
    p.add_argument("--temptol", type=float, default=0.5,
                   help="CCD-TEMP tolerance vs SET-TEMP in Celsius "
                        "(default 0.5)")
    p.add_argument("--sigma", type=float, default=5.0,
                   help="sigma clip threshold (default 5)")
    p.add_argument("--pattern", default="*.fits",
                   help="input filename glob (default *.fits)")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    make_master(ns.rootdir, ns.master, temptol=ns.temptol, sigma=ns.sigma,
                pattern=ns.pattern, device=ns.device)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
