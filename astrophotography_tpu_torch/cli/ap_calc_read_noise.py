"""ap_calc_read_noise: read noise from two bias frames.

Reference surface (scripts/ap_calc_read_noise.py): positional bias1,
bias2; --gain value or --gain_keyword.
RN = gain * sigma(B1 - B2) / sqrt(2).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..core.masters import calc_read_noise
from ..utils.logger import get_logger

logger = get_logger("cli.ap_calc_read_noise")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_calc_read_noise",
        description="Estimate CCD read noise from a pair of bias frames")
    p.add_argument("bias1", help="first bias FITS file")
    p.add_argument("bias2", help="second bias FITS file")
    p.add_argument("--gain", type=float, default=None,
                   help="gain in e-/ADU (overrides header)")
    p.add_argument("--gain_keyword", default="GAIN",
                   help="header keyword for gain (default GAIN)")
    p.add_argument("--sigma", type=float, default=3.0,
                   help="sigma clip for the difference image (default 3)")
    p.add_argument("--plot", default=None,
                   help="write a difference-histogram plot (PNG) here")
    p.add_argument("--diffim", default=None,
                   help="write the bias difference image (FITS) here")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    result = calc_read_noise(ns.bias1, ns.bias2, gain=ns.gain,
                             gain_keyword=ns.gain_keyword, sigma=ns.sigma,
                             plot_path=ns.plot, diffim_path=ns.diffim,
                             device=ns.device)
    print(f"READ_NOISE= {result['read_noise_e']:.4f} e- "
          f"(gain {result['gain']:.3f} e-/ADU, "
          f"sigma_diff {result['diff_sigma_adu']:.4f} ADU)")


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
