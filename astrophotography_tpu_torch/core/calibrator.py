"""Calibrator: file-level bias/dark/flat/badpix calibration engine.

Mirrors the reference ApCalibrate surface and header semantics
(reference core/ApCalibrate.py:33-509): masters read once at
construction, exposure-time ratio from EXPOSURE/EXPTIME, flat
normalized by its full-image mean (MEAN_FULL, :166-190), provenance
keywords BIASCORR/DARKCORR/FLATCORR/BPIXFILE/BUNIT on output
(:454-466).  The arithmetic itself is the device function in
ops/calibrate.py; ``device`` is where it runs, CUDA when not given.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from ..device import on_device, resolve_device
from ..io.fits import Header, read_image, write_image
from ..ops.calibrate import calibrate_frame
from ..utils.logger import get_logger

logger = get_logger("core.calibrator")


def find_exptime(hdr: Header) -> Optional[float]:
    """EXPOSURE else EXPTIME, in seconds (reference
    core/ApCalibrate.py:128-164)."""
    for kw in ("EXPOSURE", "EXPTIME"):
        if kw in hdr:
            return float(hdr[kw])
    return None


def find_gain(hdr: Header, default: float = 1.0) -> float:
    """GAIN else EGAIN else default e-/ADU (reference
    core/ApCalibrate.py:192-208)."""
    gain = None
    for kw in ("GAIN", "EGAIN"):
        if kw in hdr:
            gain = float(hdr[kw])
    if gain is None:
        logger.warning(f"Could not find gain in header; assuming {default}")
        gain = default
    return gain


class Calibrator:
    """Calibrate light frames against master bias/dark/flat/badpix files."""

    def __init__(
        self,
        master_bias: Optional[str] = None,
        master_dark: Optional[str] = None,
        master_flat: Optional[str] = None,
        master_badpix: Optional[str] = None,
        norm_flat: bool = True,
        deltapix: int = 2,
        dark_still_biased: bool = True,
        device=None,
    ) -> None:
        self._device = dev = resolve_device(device)
        self._deltapix = deltapix
        self._dark_still_biased = dark_still_biased
        self._paths = {
            "bias": master_bias, "dark": master_dark,
            "flat": master_flat, "badpix": master_badpix,
        }
        self._bias = self._dark = self._flat = self._badpix = None
        self._dark_hdr: Optional[Header] = None
        if master_bias:
            data, _ = read_image(master_bias)
            self._bias = on_device(data, dev)
        if master_dark:
            data, self._dark_hdr = read_image(master_dark)
            self._dark = on_device(data, dev)
        if master_flat:
            data, fhdr = read_image(master_flat)
            if norm_flat:
                norm = float(np.nanmean(data))
                logger.info(f"Flat field normalization factor: {norm:.2f}")
                data = data / norm
            self._flat = on_device(data, dev)
        if master_badpix:
            data, _ = read_image(master_badpix, as_float32=False,
                                 remove_pedestal=False)
            self._badpix = on_device(np.asarray(data) != 0, dev)

    def calibrate(self, raw_path: str, out_path: str,
                  fix_cosmic: bool = False) -> Header:
        """Calibrate one file and write the result with provenance."""
        t0 = time.perf_counter()
        img, hdr = read_image(raw_path)

        exp_ratio = 1.0
        if self._dark is not None:
            img_exp = find_exptime(hdr)
            dark_exp = find_exptime(self._dark_hdr) if self._dark_hdr else None
            if img_exp is None or dark_exp is None:
                msg = ("Could not determine exposure time for "
                       + ("image" if img_exp is None else "dark"))
                logger.error(msg)
                raise RuntimeError(msg)
            exp_ratio = img_exp / dark_exp
            logger.info(f"Image to dark exposure time ratio: {exp_ratio:.3f}")

        out = calibrate_frame(
            on_device(img, self._device), self._bias, self._dark, self._flat,
            exp_ratio=exp_ratio, dark_still_biased=self._dark_still_biased,
            badpix_mask=self._badpix, deltapix=self._deltapix)

        if fix_cosmic:
            from ..ops.cosmic import lacosmic

            gain = find_gain(hdr)
            cleaned, crmask = lacosmic(out, gain=gain)
            hdr["CR_CLEAN"] = (True, "Cosmic rays cleaned by L.A.Cosmic")
            hdr["CR_NPIX"] = (int(crmask.sum()),
                              "Number of cosmic ray pixels fixed")
            out = cleaned

        # provenance keywords (reference core/ApCalibrate.py:454-466)
        hdr["BIASCORR"] = (self._bias is not None, "Bias subtracted?")
        hdr["DARKCORR"] = (self._dark is not None, "Dark subtracted?")
        hdr["FLATCORR"] = (self._flat is not None, "Flat field applied?")
        if self._paths["badpix"]:
            hdr["BPIXFILE"] = (os.path.basename(self._paths["badpix"]),
                               "Bad pixel file applied")
        hdr["BUNIT"] = ("adu", "Pixel data units")
        for name in ("bias", "dark", "flat"):
            if self._paths[name]:
                hdr.add_history(
                    f"Calibrated with master {name} "
                    f"{os.path.basename(self._paths[name])}")
        write_image(out_path, out.cpu().numpy(), hdr)
        logger.info(f"Calibrated {raw_path} -> {out_path} in "
                    f"{time.perf_counter() - t0:.3f} s")
        return hdr
