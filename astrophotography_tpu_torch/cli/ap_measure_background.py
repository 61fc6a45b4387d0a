"""ap_measure_background: large-scale 2-D sky background model.

Reference surface (scripts/ap_measure_background.py:67-127): positional
input + output background image; --srclist (an ap_find_stars source
list used to build the star-exclusion mask instead of re-detecting —
the reference declares this flag at scripts/ap_measure_background.py:
67-74 but its engine stubs it with a 'not yet implemented' warning at
core/ApMeasureBackground.py:468-470; here it is implemented);
--nbg_cols/--nbg_rows (16), box-size minima, --bg_filter_width 3,
--bg_badbox_pctile 25, --bg_sigmaclip 3.  The box grid geometry is
padded to divisibility on the host (the analogue of the reference's
_set_bgbox_size rounding, core/ApMeasureBackground.py:255-330).
``--device`` (default cuda) is where the mask and the model are computed.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from .common import add_device, add_loglevel, cli_main
from ..device import on_device, resolve_device
from ..io.fits import read_image, write_image
from ..ops.background import background2d, source_mask
from ..utils.logger import get_logger

logger = get_logger("cli.ap_measure_background")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_measure_background",
        description="Model the large-scale sky background of an image")
    p.add_argument("input", help="input FITS image")
    p.add_argument("output", help="output background FITS image")
    p.add_argument("--nbg_cols", type=int, default=16,
                   help="number of background boxes across (default 16)")
    p.add_argument("--nbg_rows", type=int, default=16,
                   help="number of background boxes down (default 16)")
    p.add_argument("--min_bgwidth", type=int, default=48,
                   help="minimum background box width in px (default 48); "
                        "the grid shrinks to respect it")
    p.add_argument("--min_bgheight", type=int, default=48,
                   help="minimum background box height in px (default 48)")
    p.add_argument("--bg_filter_width", type=int, default=3,
                   help="median filter width over the box grid (default 3)")
    p.add_argument("--bg_badbox_pctile", type=float, default=25.0,
                   help="min %% of unmasked pixels for a box (default 25)")
    p.add_argument("--bg_sigmaclip", type=float, default=3.0,
                   help="sigma clip within each box (default 3)")
    p.add_argument("--srclist", metavar="SRCLIST.FITS", default=None,
                   help="ap_find_stars source list; its star positions "
                        "build the exclusion mask instead of re-detecting "
                        "(for images where automated detection fails)")
    p.add_argument("--srclist_radius", type=float, default=None,
                   help="exclusion radius in px around each srclist "
                        "source (default: ceil(2*FWHM) from the "
                        "srclist's AP_FWHM keyword, the photometry "
                        "aperture radius; 6 px when absent)")
    p.add_argument("--bg_upsample", choices=("spline", "bilinear"),
                   default="spline",
                   help="box-grid upsampler: 'spline' (order-3 B-spline "
                        "zoom, photutils Background2D parity — the "
                        "reference's engine) or 'bilinear' (fast path; "
                        "divergence bounded in tests). Default: spline")
    p.add_argument("--subtract", default=None,
                   help="also write the background-subtracted image here")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def effective_grid(h: int, w: int, nbg_rows: int, nbg_cols: int,
                   min_bgheight: int = 48, min_bgwidth: int = 48):
    """Box-grid fixups with the reference's _set_bgbox_size semantics
    (core/ApMeasureBackground.py:255-330): the box edge is
    quantum*(1 + image // (quantum*grid)) — the reference's literal
    floor-plus-one-quantum formula, which perturbs even exactly
    divisible geometries by one quantum — clamped to the minimum box
    size; the grid then covers the image with ceil(image/box) boxes
    (photutils Background2D edge_method='pad').
    Returns (n_rows, n_cols, box_h, box_w)."""
    q = 2
    box_h = max(min_bgheight, q * (1 + h // (q * max(nbg_rows, 1))))
    box_w = max(min_bgwidth, q * (1 + w // (q * max(nbg_cols, 1))))
    n_rows = max(1, -(-h // box_h))
    n_cols = max(1, -(-w // box_w))
    return n_rows, n_cols, box_h, box_w


def srclist_mask(shape, xs, ys, radius: float) -> np.ndarray:
    """Boolean exclusion mask: disks of ``radius`` px around each
    source center (0-based coordinates).  The --srclist replacement for
    the automated segmentation mask (reference intent,
    scripts/ap_measure_background.py:67-74)."""
    h, w = shape
    mask = np.zeros((h, w), bool)
    r = int(np.ceil(radius))
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    disk = (yy * yy + xx * xx) <= radius * radius
    for x, y in zip(np.asarray(xs, float), np.asarray(ys, float)):
        cy, cx = int(round(y)), int(round(x))
        y0, y1 = max(cy - r, 0), min(cy + r + 1, h)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, w)
        if y0 >= y1 or x0 >= x1:
            continue
        mask[y0:y1, x0:x1] |= disk[y0 - (cy - r):y1 - (cy - r),
                                   x0 - (cx - r):x1 - (cx - r)]
    return mask


def run(ns: argparse.Namespace) -> None:
    dev = resolve_device(ns.device)
    data, hdr = read_image(ns.input)
    h, w = data.shape
    n_rows, n_cols, box_h, box_w = effective_grid(
        h, w, ns.nbg_rows, ns.nbg_cols, ns.min_bgheight, ns.min_bgwidth)
    if (n_rows, n_cols) != (ns.nbg_rows, ns.nbg_cols):
        logger.info(f"Box grid adjusted to {n_rows}x{n_cols} boxes of "
                    f"{box_h}x{box_w} px on a {h}x{w} image")
    # pad so the box grid covers the image (edge-replicate), crop after
    ph = n_rows * box_h - h
    pw = n_cols * box_w - w
    padded = np.pad(data, ((0, ph), (0, pw)), mode="edge")
    if ns.srclist:
        from ..io.fits import open_fits

        src = open_fits(ns.srclist)
        xy = src["AP_XYPOS"]
        xs = np.asarray(xy["X"], float) - 1.0  # FITS 1-based -> 0-based
        ys = np.asarray(xy["Y"], float) - 1.0
        radius = ns.srclist_radius
        if radius is None:
            fwhm = src[0].header.get("AP_FWHM")
            # AP_FWHM is NaN when zero stars fit — fall back to 6 px
            radius = (float(np.ceil(2.0 * float(fwhm)))
                      if fwhm is not None and np.isfinite(float(fwhm))
                      and float(fwhm) > 0 else 6.0)
        m = srclist_mask((h, w), xs, ys, radius)
        logger.info(f"Exclusion mask from {len(xs)} srclist sources "
                    f"(radius {radius:.1f} px, {m.mean() * 100:.2f}% "
                    f"of pixels)")
        smask = on_device(np.pad(m, ((0, ph), (0, pw)), mode="edge"), dev)
    else:
        smask = source_mask(on_device(padded, dev), nsigma=3.0, dilate=13)
    bg = background2d(
        on_device(padded, dev), smask,
        nboxes_y=n_rows, nboxes_x=n_cols,
        filter_size=ns.bg_filter_width, sigma=ns.bg_sigmaclip,
        exclude_percentile=ns.bg_badbox_pctile,
        upsample=ns.bg_upsample)
    bg = bg.cpu().numpy()[:h, :w]
    out_hdr = hdr.copy()
    out_hdr["IMAGETYP"] = ("Background Sky", "Background model image")
    out_hdr.add_history(
        f"Background model: {n_rows}x{n_cols} boxes, "
        f"filter {ns.bg_filter_width}, sigma {ns.bg_sigmaclip}")
    write_image(ns.output, bg, out_hdr)
    logger.info(f"Background model written to {ns.output} "
                f"(median {np.median(bg):.2f} ADU)")
    if ns.subtract:
        sub_hdr = hdr.copy()
        sub_hdr.add_history(f"Subtracted sky background model {ns.output}")
        write_image(ns.subtract, data - bg, sub_hdr)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
