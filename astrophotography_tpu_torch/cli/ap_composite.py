"""ap_composite: 3-color composite from FITS channels (stiff replacement).

Covers the capability of composite_all.sh + stiff (reference
scripts/composite_all.sh:6-27): channel selections like rgb/sho/hgb map
input files to output R/G/B.  ``--device`` (default cuda) is where the
channels are stretched.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..io.fits import read_image
from ..io.writer import file_writer
from ..ops.composite import compose_rgb
from ..utils.logger import get_logger

logger = get_logger("cli.ap_composite")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_composite",
        description="Build a stretched 3-color composite from FITS images")
    p.add_argument("red", help="FITS image for the red channel")
    p.add_argument("green", help="FITS image for the green channel")
    p.add_argument("blue", help="FITS image for the blue channel")
    p.add_argument("output", help="output TIFF/PNG file")
    p.add_argument("--mode", default="asinh",
                   choices=["asinh", "gamma", "linear"],
                   help="stretch mode (default asinh)")
    p.add_argument("--black_pct", type=float, default=0.5,
                   help="black point percentile (default 0.5)")
    p.add_argument("--white_pct", type=float, default=99.8,
                   help="white point percentile (default 99.8)")
    p.add_argument("--gamma", type=float, default=2.2,
                   help="gamma for --mode gamma (default 2.2)")
    p.add_argument("--asinh_q", type=float, default=8.0,
                   help="asinh softening parameter (default 8)")
    p.add_argument("--bits", type=int, default=8, choices=[8, 16],
                   help="output bit depth (default 8)")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    r, _ = read_image(ns.red)
    g, _ = read_image(ns.green)
    b, _ = read_image(ns.blue)
    if not (r.shape == g.shape == b.shape):
        raise RuntimeError(
            f"channel shapes differ: {r.shape}, {g.shape}, {b.shape}")
    rgb = compose_rgb(r, g, b, mode=ns.mode, black_pct=ns.black_pct,
                      white_pct=ns.white_pct, gamma=ns.gamma,
                      asinh_q=ns.asinh_q, bits=ns.bits, device=ns.device)
    file_writer(ns.output, rgb)
    logger.info(f"Composite written to {ns.output}")


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
