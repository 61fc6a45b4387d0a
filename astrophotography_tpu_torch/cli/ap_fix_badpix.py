"""ap_fix_badpix: repair bad pixels in an image using a mask file.

Reference surface (scripts/ap_fix_badpix.py:59-67): positional
image, badpix mask, output; --deltapix default 1.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..core.badpix_engine import fix_badpix_files


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_fix_badpix",
        description="Repair bad pixels with the local good-pixel median")
    p.add_argument("image", help="input FITS image")
    p.add_argument("badpix", help="bad pixel mask FITS file")
    p.add_argument("output", help="output corrected FITS image")
    p.add_argument("--deltapix", type=int, default=1,
                   help="half-width of repair neighborhood (default 1)")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    fix_badpix_files(ns.image, ns.badpix, ns.output, deltapix=ns.deltapix,
                     device=ns.device)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
