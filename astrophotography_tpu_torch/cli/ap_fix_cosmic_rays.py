"""ap_fix_cosmic_rays: L.A.Cosmic cosmic-ray removal on a FITS file.

Reference surface (scripts/ap_fix_cosmic_rays.py:56-65): positional
input, output; --crdiffim and --crmaskim optional outputs
(reference core/ApFixCosmicRays.py:366-400).  ``--device`` (default
cuda) is where L.A.Cosmic runs.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from .common import add_device, add_loglevel, cli_main
from ..core.calibrator import find_gain
from ..device import on_device, resolve_device
from ..io.fits import read_image, write_image
from ..ops.cosmic import lacosmic
from ..utils.logger import get_logger

logger = get_logger("cli.ap_fix_cosmic_rays")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_fix_cosmic_rays",
        description="Detect and remove cosmic rays (L.A.Cosmic)")
    p.add_argument("input", help="input FITS image")
    p.add_argument("output", help="output cleaned FITS image")
    p.add_argument("--crdiffim", default=None,
                   help="write the input-minus-cleaned difference image here")
    p.add_argument("--crmaskim", default=None,
                   help="write the cosmic-ray mask (uint8) here")
    p.add_argument("--sigclip", type=float, default=4.5,
                   help="Laplacian SNR threshold (default 4.5)")
    p.add_argument("--niter", type=int, default=6,
                   help="number of detection iterations (default 6)")
    p.add_argument("--readnoise", type=float, default=12.0,
                   help="read noise in electrons (default 12)")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    img, hdr = read_image(ns.input)
    gain = find_gain(hdr)
    cleaned, crmask = lacosmic(
        on_device(img, resolve_device(ns.device)), gain=gain,
        readnoise=ns.readnoise, sigclip=ns.sigclip,
        satlevel_e=gain * 65535.0, niter=ns.niter)
    cleaned = cleaned.cpu().numpy()
    crmask = crmask.cpu().numpy()
    n_bad = int(crmask.sum())
    hdr["CR_CLEAN"] = (True, "Has cosmic ray removal been performed?")
    hdr["CR_NPIX"] = (n_bad, "Number of pixels modified by lacosmic")
    hdr.add_history(f"L.A.Cosmic: {n_bad} CR pixels cleaned "
                    f"(sigclip={ns.sigclip}, niter={ns.niter})")
    write_image(ns.output, cleaned, hdr)
    logger.info(f"{n_bad} cosmic ray pixels cleaned: "
                f"{ns.input} -> {ns.output}")
    if ns.crmaskim:
        mhdr = hdr.copy()
        mhdr["IMAGETYP"] = ("CRMASK", "Cosmic ray mask")
        write_image(ns.crmaskim, crmask.astype(np.uint8), mhdr)
    if ns.crdiffim:
        dhdr = hdr.copy()
        dhdr["IMAGETYP"] = ("CRDIFF", "Cosmic ray difference image")
        write_image(ns.crdiffim, img - cleaned, dhdr)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
