"""Image output dispatch: graphics formats via imageio, FITS natively.

Equivalent of the reference file_writer (core/file_writer.py:14-112):
dispatch on extension, 16-bit graphics output, RGB FITS as three image
HDUs with FILTER keywords, EXIF -> FITS header mapping (DATE-OBS,
INSTRUME, EXPOSURE/EXPTIME, FNUMBER, ISONUM, FOCALLEN).  The
reference's ``eval()`` of EXIF rationals (core/file_writer.py:162-167,
flagged in SURVEY.md §2.8) is replaced by safe numeric handling — EXIF
values arrive from io/raw.py already decoded to numbers.
"""

from __future__ import annotations

import fractions
import os
import time
from typing import Any, Dict, Optional

import numpy as np

from .fits import HDUList, Header, ImageHDU
from ..utils.logger import get_logger

_GRAPHICS_EXT = {".png", ".tif", ".tiff", ".jpg", ".jpeg", ".bmp"}
_FITS_EXT = {".fits", ".fit", ".ftz"}

logger = get_logger("io.writer")


def determine_file_type(path: str) -> str:
    """'graphics' or 'fits' by extension (reference
    core/file_writer.py:193-218)."""
    lower = path.lower()
    if lower.endswith(".fits.gz"):
        return "fits"
    ext = os.path.splitext(lower)[1]
    if ext in _GRAPHICS_EXT:
        return "graphics"
    if ext in _FITS_EXT:
        return "fits"
    raise ValueError(f"cannot determine output file type for {path!r}")


def _safe_number(value: Any) -> Optional[float]:
    """Parse EXIF-ish values ('1/200', Fraction, number) without eval."""
    if isinstance(value, (int, float, np.integer, np.floating)):
        return float(value)
    if isinstance(value, fractions.Fraction):
        return float(value)
    if isinstance(value, str):
        s = value.strip()
        try:
            if "/" in s:
                num, den = s.split("/", 1)
                d = float(den)
                return float(num) / d if d else None
            return float(s)
        except ValueError:
            return None
    return None


def exif_to_fits_header(exif: Dict[str, Any], header: Header) -> Header:
    """Map EXIF tags to the FITS keywords the reduction chain expects
    (reference update_fits_header_with_exif, core/file_writer.py:114-172)."""
    if "DateTime" in exif:
        date = str(exif["DateTime"]).strip()
        # EXIF 'YYYY:MM:DD HH:MM:SS' -> FITS 'YYYY-MM-DDTHH:MM:SS'
        if len(date) >= 19 and date[4] == ":" and date[7] == ":":
            date = (date[:4] + "-" + date[5:7] + "-" + date[8:10]
                    + "T" + date[11:19])
        header["DATE-OBS"] = (date, "Date of observation")
    model = exif.get("Model") or exif.get("Make")
    if model:
        header["INSTRUME"] = (str(model).strip(), "Instrument (camera model)")
    exp = _safe_number(exif.get("ExposureTime"))
    if exp is not None:
        header["EXPOSURE"] = (exp, "[s] Exposure time")
        header["EXPTIME"] = (exp, "[s] Exposure time")
    fnum = _safe_number(exif.get("FNumber"))
    if fnum is not None:
        header["FNUMBER"] = (fnum, "F-number of lens")
    iso = exif.get("ISOSpeedRatings")
    if iso is not None:
        try:
            header["ISONUM"] = (int(iso), "ISO sensitivity")
        except (TypeError, ValueError):
            pass
    focal = _safe_number(exif.get("FocalLength"))
    if focal is not None:
        header["FOCALLEN"] = (focal, "[mm] Focal length of lens")
    return header


def file_writer(
    path: str,
    data: np.ndarray,
    exif: Optional[Dict[str, Any]] = None,
    header: Optional[Header] = None,
) -> None:
    """Write greyscale (H,W) or RGB (H,W,3) data to a graphics or FITS file.

    Graphics: uint16 output (uint8 passthrough).  FITS: greyscale as the
    primary HDU; RGB as three IMAGE HDUs tagged FILTER='R'/'G'/'B'
    (reference core/file_writer.py:66-97).
    """
    t0 = time.perf_counter()
    data = np.asarray(data)
    kind = determine_file_type(path)
    if kind == "graphics":
        out = data if data.dtype in (np.uint8, np.uint16) \
            else np.clip(data, 0, 65535).astype(np.uint16)
        if out.ndim not in (2, 3):
            raise ValueError(f"cannot write {out.ndim}-D data as graphics")
        ext = os.path.splitext(path.lower())[1]
        if ext in (".jpg", ".jpeg") and out.dtype == np.uint16:
            out = (out // 257).astype(np.uint8)  # JPEG is 8-bit only
        if ext == ".png" and out.dtype == np.uint16:
            # Pillow cannot encode 16-bit RGB PNG; use the native encoder
            from .png16 import write_png16

            write_png16(path, out)
        else:
            import imageio.v3 as iio

            iio.imwrite(path, out)
    else:
        hdr = header.copy() if header is not None else Header()
        if exif:
            exif_to_fits_header(exif, hdr)
        if data.ndim == 2:
            hdus = HDUList([ImageHDU(data, hdr)])
        elif data.ndim == 3 and data.shape[-1] == 3:
            hdus = HDUList([ImageHDU(None, hdr)])
            for i, band in enumerate("RGB"):
                bhdr = hdr.copy()
                bhdr["FILTER"] = (band, "RGB channel")
                hdus.append(ImageHDU(np.ascontiguousarray(data[..., i]), bhdr,
                                     name=band))
        else:
            raise ValueError(f"cannot write array of shape {data.shape} as FITS")
        hdus.writeto(path)
    dt = time.perf_counter() - t0
    mb = data.nbytes / 1e6
    logger.debug(f"Wrote {path} ({mb:.1f} MB) in {dt:.3f} s "
                 f"({mb / max(dt, 1e-9):.1f} MB/s)")
