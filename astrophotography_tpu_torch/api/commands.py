"""dksraw command implementations (reference api/grey.py, api/rgb.py,
api/split.py — each constructs a RawConv, runs one conversion, and hands
the array to the file writer, with wall-time logging).  ``device`` is
where the conversion runs: CUDA when not given."""

from __future__ import annotations

import os
import time

from ..core.raw_conv import RawConv
from ..io.writer import file_writer
from ..utils.logger import get_logger

logger = get_logger("api")


def grey(rawfile: str, output: str, luminance_method: str = "linear",
         subtract_black: bool = True, wb_method: str = "daylight",
         print_stats: bool = False, renormalize: bool = False,
         demosaic: str = "mhc", device=None) -> None:
    """RAW -> 16-bit greyscale (reference api/grey.py:9-46)."""
    t0 = time.perf_counter()
    raw = RawConv(rawfile, device=device)
    img, exif = raw.grey(luminance_method=luminance_method,
                         subtract_black=subtract_black, wb_method=wb_method,
                         print_stats=print_stats, renorm=renormalize,
                         demosaic=demosaic)
    file_writer(output, img, exif)
    logger.info(f"dksraw grey: {rawfile} -> {output} "
                f"in {time.perf_counter() - t0:.3f} s")


def rgb(rawfile: str, output: str, luminance_method: str = "linear",
        subtract_black: bool = True, wb_method: str = "daylight",
        print_stats: bool = False, renormalize: bool = False,
        demosaic: str = "mhc", device=None) -> None:
    """RAW -> 16-bit RGB (reference api/rgb.py:9-46)."""
    t0 = time.perf_counter()
    raw = RawConv(rawfile, device=device)
    img, exif = raw.rgb(luminance_method=luminance_method,
                        subtract_black=subtract_black, wb_method=wb_method,
                        print_stats=print_stats, renorm=renormalize,
                        demosaic=demosaic)
    file_writer(output, img, exif)
    logger.info(f"dksraw rgb: {rawfile} -> {output} "
                f"in {time.perf_counter() - t0:.3f} s")


def split(rawfile: str, output: str, subtract_black: bool = False,
          extension: str = "tiff", device=None) -> None:
    """RAW -> four per-band images ``_r/_g1/_b/_g2.<ext>``
    (reference api/split.py:9-42)."""
    t0 = time.perf_counter()
    raw = RawConv(rawfile, device=device)
    r, g1, b, g2, exif = raw.split(subtract_black=subtract_black)
    base, _ = os.path.splitext(output)
    ext = extension.lstrip(".")
    for name, img in (("r", r), ("g1", g1), ("b", b), ("g2", g2)):
        file_writer(f"{base}_{name}.{ext}", img, exif)
    logger.info(f"dksraw split: {rawfile} -> {base}_[r,g1,b,g2].{ext} "
                f"in {time.perf_counter() - t0:.3f} s")
