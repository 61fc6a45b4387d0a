"""File-level bad-pixel workflows: find, fix, auto column/row detection.

Mirrors ApFindBadPixels / ApFixBadPixels / ApAutoBadcols surfaces
(reference core/ApFindBadPixels.py, core/ApFixBadPixels.py,
core/ApAutoBadcols.py) over the vectorized device ops: bitmask
semantics GOOD=0, AUTO_BAD=1, USER_BAD=2; user bad-pixel YAML with
1-based inclusive bad_columns/bad_rows/bad_rectangles sections
(reference etc/user_badpixels.yml:36-53); BPIX* provenance keywords on
repaired images (core/ApFixBadPixels.py:340-344,431-443).  ``device``
is where each workflow computes: CUDA when not given.  ``yaml`` is
imported by the functions that parse or write a YAML file.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np

from ..device import on_device, resolve_device
from ..io.fits import Header, read_image, write_image
from ..ops.badpix import (MASK_AUTO_BAD, MASK_USER_BAD, auto_badcols,
                          combine_user_badpix, fix_bad_pixels,
                          sigmaclip_badpix_mask)
from ..utils.logger import get_logger

logger = get_logger("core.badpix")


def read_user_badpix(path: str) -> dict:
    """Parse a user bad-pixel YAML; absent sections yield empty lists
    (the reference crashes on absent sections, SURVEY.md §2.8 —
    implemented tolerantly here)."""
    import yaml

    with open(path) as fh:
        data = yaml.safe_load(fh) or {}
    return {
        "bad_columns": data.get("bad_columns") or [],
        "bad_rows": data.get("bad_rows") or [],
        "bad_rectangles": data.get("bad_rectangles") or [],
    }


def find_badpix(
    master_path: str,
    output_mask: str,
    sigma: float = 4.0,
    user_badpix: Optional[str] = None,
    device=None,
) -> Header:
    """Build a bad-pixel mask from a master dark/bias + optional user file."""
    dev = resolve_device(device)
    data, hdr = read_image(master_path)
    auto_mask = sigmaclip_badpix_mask(on_device(data, dev),
                                      sigma=sigma).cpu().numpy()
    mask = (auto_mask * MASK_AUTO_BAD).astype(np.uint8)
    n_user = 0
    if user_badpix:
        user = read_user_badpix(user_badpix)
        umask = combine_user_badpix(
            data.shape, user["bad_columns"], user["bad_rows"],
            user["bad_rectangles"], device=dev).cpu().numpy()
        mask = np.where(umask > 0, MASK_USER_BAD, mask).astype(np.uint8)
        n_user = int((umask > 0).sum())
    out_hdr = Header()
    out_hdr["IMAGETYP"] = ("BADPIX", "Bad pixel mask")
    out_hdr["BPIXSIGM"] = (sigma, "Sigma threshold for auto bad pixels")
    out_hdr["BPIXNAUT"] = (int((mask == MASK_AUTO_BAD).sum()),
                           "Number of auto-detected bad pixels")
    out_hdr["BPIXNUSR"] = (n_user, "Number of user-defined bad pixels")
    out_hdr["BPIXSRC"] = (os.path.basename(master_path),
                          "Image used for bad pixel detection")
    out_hdr.add_history(
        f"Bad pixel mask: sigma clip {sigma} on {master_path}"
        + (f" + user file {user_badpix}" if user_badpix else ""))
    write_image(output_mask, mask, out_hdr)
    n_bad = int((mask > 0).sum())
    logger.info(f"Bad pixel mask {output_mask}: {n_bad} bad pixels "
                f"({100.0 * n_bad / mask.size:.4f}%)")
    return out_hdr


def fix_badpix_files(
    img_path: str,
    mask_path: str,
    output: str,
    deltapix: int = 1,
    device=None,
) -> Header:
    """Repair bad pixels in a FITS file (reference fix_files,
    core/ApFixBadPixels.py:245-290)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    img, hdr = read_image(img_path)
    mask_data, _ = read_image(mask_path, as_float32=False,
                              remove_pedestal=False)
    badmask = np.asarray(mask_data) != 0
    nbad = int(badmask.sum())
    fixed, still_bad = fix_bad_pixels(on_device(img, dev),
                                      on_device(badmask, dev),
                                      deltapix=deltapix)
    fixed = fixed.cpu().numpy()
    n_notfix = int(still_bad.sum())
    hdr["BPIXNBAD"] = (nbad, "Total number of bad pixels in bad pixel file")
    hdr["BPIX_MIN"] = (4, "Minimum number of good neighbors needed")
    hdr["BPIXDPIX"] = (deltapix, "Half width of collection region (pixels)")
    hdr["BPIXNREM"] = (n_notfix, "Number of bad pixels NOT fixed")
    hdr["BPIXNFIX"] = (nbad - n_notfix, "Number of bad pixels fixed")
    hdr["BPIXCORR"] = (True, "Bad pixel correction applied?")
    hdr["BPIXFILE"] = (os.path.basename(mask_path), "Bad pixel mask file")
    hdr.add_history(f"Fixed {nbad - n_notfix}/{nbad} bad pixels "
                    f"(deltapix={deltapix}) from {mask_path}")
    write_image(output, fixed, hdr)
    dt = time.perf_counter() - t0
    logger.info(f"Fixed {nbad - n_notfix}/{nbad} bad pixels in {dt:.3f} s "
                f"({1000 * dt / max(nbad, 1):.3f} ms/pixel equivalent)")
    return hdr


def auto_badcol_file(
    img_path: str,
    sigma: float = 5.0,
    window: int = 11,
    output_yaml: Optional[str] = None,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Detect bad columns/rows of a master frame; optionally write them
    as a user-badpix YAML (1-based convention)."""
    data, _hdr = read_image(img_path)
    frame = on_device(data, resolve_device(device))
    cols = np.where(auto_badcols(frame, window=window, sigma=sigma,
                                 axis=0).cpu().numpy())[0]
    rows = np.where(auto_badcols(frame, window=window, sigma=sigma,
                                 axis=1).cpu().numpy())[0]
    logger.info(f"Found {len(cols)} bad columns {cols.tolist()} and "
                f"{len(rows)} bad rows {rows.tolist()}")
    if output_yaml:
        payload = {
            "bad_columns": [int(c) + 1 for c in cols],
            "bad_rows": [int(r) + 1 for r in rows],
            "bad_rectangles": [],
        }
        import yaml

        with open(output_yaml, "w") as fh:
            yaml.safe_dump(payload, fh)
        logger.info(f"Wrote user bad-pixel YAML to {output_yaml}")
    return cols, rows
