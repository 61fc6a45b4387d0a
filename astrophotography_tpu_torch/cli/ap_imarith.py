"""ap_imarith: fimarith-style image arithmetic.

Reference surface (scripts/ap_imarith.py:50-80): positional
input op value output, --units.  ``value`` is a number or a second
FITS file; BUNIT updated and HISTORY provenance added
(reference core/ApImArith.py:255-346).  ``--device`` (default cuda)
is where the arithmetic runs.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from .common import add_device, add_loglevel, cli_main
from ..device import on_device, resolve_device
from ..io.fits import read_image, write_image
from ..ops.imarith import ALLOWED_OPS, imarith
from ..utils.logger import get_logger

logger = get_logger("cli.ap_imarith")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_imarith",
        description="Image arithmetic: image OP scalar-or-image")
    p.add_argument("input", help="input FITS image")
    p.add_argument("op", choices=[o for o in ALLOWED_OPS]
                   + [o.lower() for o in ALLOWED_OPS],
                   help="operation")
    p.add_argument("value", help="scalar value or second FITS image path")
    p.add_argument("output", help="output FITS image")
    p.add_argument("--units", default=None,
                   help="value for the output BUNIT keyword")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    # native dtype: the reference allocates the result in the INPUT's
    # dtype (core/ApImArith.py:321), so int16 in -> BITPIX 16 out;
    # unsigned ints become float32 at read time (reference _read_fits)
    dev = resolve_device(ns.device)
    img, hdr = read_image(ns.input, as_float32=False)
    if img.dtype.kind == "u":
        img = img.astype(np.float32)
    out_dtype = img.dtype
    op = ns.op.upper()
    try:
        value = float(ns.value)
        desc = ns.value
    except ValueError:
        other, _ = read_image(ns.value)
        if other.shape != img.shape:
            raise RuntimeError(
                f"image shapes differ: {img.shape} vs {other.shape}")
        value = on_device(other, dev)
        desc = os.path.basename(ns.value)
    out = imarith(on_device(img, dev), op, value).cpu().numpy()
    if out.dtype != out_dtype:
        out = out.astype(out_dtype)
    if ns.units:
        hdr["BUNIT"] = (ns.units, "Pixel data units")
    hdr.add_history(f"ap_imarith: {os.path.basename(ns.input)} {op} {desc}")
    write_image(ns.output, out, hdr)
    logger.info(f"{ns.input} {op} {desc} -> {ns.output}")


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
