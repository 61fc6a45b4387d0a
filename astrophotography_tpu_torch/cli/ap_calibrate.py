"""ap_calibrate: bias/dark/flat/badpix/CR calibration of a light frame.

CLI surface mirrors the reference (scripts/ap_calibrate.py:52-115):
positional raw, master_bias, master_dark, output; optional
--master_flat --master_badpix --normflat --deltapix --fixcosmic
--dark_still_biased.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..core.calibrator import Calibrator


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_calibrate",
        description="Calibrate a raw light frame with master calibrations")
    p.add_argument("raw", help="raw light frame FITS file")
    p.add_argument("master_bias", help="master bias FITS file")
    p.add_argument("master_dark", help="master dark FITS file")
    p.add_argument("output", help="output calibrated FITS file")
    p.add_argument("--master_flat", default=None,
                   help="optional master flat FITS file")
    p.add_argument("--master_badpix", default=None,
                   help="optional bad pixel mask FITS file")
    p.add_argument("--normflat", action="store_true", default=True,
                   help="normalize the flat by its full-image mean (default)")
    p.add_argument("--no-normflat", dest="normflat", action="store_false",
                   help="use the master flat as-is")
    p.add_argument("--deltapix", type=int, default=2,
                   help="half-width of bad pixel repair box (default 2)")
    p.add_argument("--fixcosmic", action="store_true",
                   help="apply L.A.Cosmic cosmic ray removal")
    p.add_argument("--dark_still_biased", action="store_true", default=True,
                   help="master dark still contains the bias signal (default)")
    p.add_argument("--dark_debiased", dest="dark_still_biased",
                   action="store_false",
                   help="master dark was already bias-subtracted")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    cal = Calibrator(
        master_bias=ns.master_bias,
        master_dark=ns.master_dark,
        master_flat=ns.master_flat,
        master_badpix=ns.master_badpix,
        norm_flat=ns.normflat,
        deltapix=ns.deltapix,
        dark_still_biased=ns.dark_still_biased,
        device=ns.device)
    cal.calibrate(ns.raw, ns.output, fix_cosmic=ns.fixcosmic)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
