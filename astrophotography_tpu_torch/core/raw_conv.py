"""RawConv: RAW -> greyscale/RGB/split conversion engine.

Mirrors the reference RawConv surface (core/RawConv.py:19-618) — the
``grey``/``rgb``/``split``/``get_whitebalance`` methods, white-balance
methods daylight/camera/auto/region[..]/user[..], black-level handling
— while the per-pixel work (black subtraction, WB, demosaic, luma,
renormalization) runs as the device functions in ops/demosaic.py
instead of LibRaw postprocess.

Implements the *documented* semantics at the reference's known defects
(SURVEY.md §2.8): grey(method='direct') works and renormalizes its own
output, and region white-balance operates on black-subtracted site data.
"""

from __future__ import annotations

import ast
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import on_device, resolve_device, to_uint16
from ..io.raw import RawImage, load_raw
from ..ops import demosaic as dk
from ..utils.logger import get_logger

logger = get_logger("core.raw_conv")


class RawConv:
    """RAW conversion engine for a single RAW file."""

    R, G1, B, G2 = 0, 1, 2, 3
    MAX_ADU = 65535

    def __init__(self, rawfile: str, pattern: str = "RGGB",
                 raw_image: "RawImage | None" = None,
                 device=None) -> None:
        """``raw_image`` supplies an already-decoded RawImage (e.g. from
        a prefetch thread overlapping container decode with device
        work); ``rawfile`` is then only used for logging.

        The frame goes to ``device`` (CUDA when not given; the CPU only
        when asked for by name): the mosaic at its native uint16 width
        (the conversions read it through ``device.to_float32``'s int16
        view), ``color_map`` as int64 (it indexes the per-band tables:
        ``black_levels[color_map]``), ``black_levels`` as float32.
        ``white_level`` stays a host float; ``camera_wb`` and
        ``daylight_wb`` stay host lists until a conversion turns the
        chosen white balance into a (4,) float32 tensor."""
        t0 = time.perf_counter()
        self._device = resolve_device(device)
        self._rawfile = rawfile
        self._raw: RawImage = (raw_image if raw_image is not None
                               else load_raw(rawfile, pattern=pattern))
        self._mosaic = on_device(self._raw.mosaic, self._device)
        # widened on the device: the host sends one byte a site
        self._color_map = on_device(self._raw.color_map,
                                    self._device).to(torch.int64)
        self._black_levels = on_device(
            np.asarray(self._raw.black_levels, dtype=np.float32),
            self._device)
        logger.debug(
            f"Loaded {rawfile}: {self._raw.shape[1]}x{self._raw.shape[0]} "
            f"mosaic, black={list(self._raw.black_levels)}, "
            f"white={self._raw.white_level} "
            f"in {time.perf_counter() - t0:.3f} s")

    # -- metadata ---------------------------------------------------------
    @property
    def exif(self) -> Dict:
        return self._raw.exif

    @property
    def shape(self) -> Tuple[int, int]:
        return self._raw.shape

    # -- white balance ----------------------------------------------------
    def get_whitebalance(self, wb_method: str) -> List[float]:
        """WB multipliers for daylight/camera/auto/region[..]/user[..]
        (reference core/RawConv.py:368-399)."""
        method = wb_method.split("[")[0]
        allowed = ["daylight", "camera", "auto", "region", "user"]
        if method not in allowed:
            msg = (f'Unexpected white balance method "{method}" — '
                   f"allowed: {allowed}")
            logger.error(msg)
            raise RuntimeError(msg)
        if method == "daylight":
            wb = list(self._raw.daylight_wb)
        elif method == "camera":
            wb = list(self._raw.camera_wb)
        elif method == "user":
            spec = wb_method[len("user"):]
            try:
                vals = ast.literal_eval(spec) if spec else [1, 1, 1, 1]
            except (SyntaxError, ValueError) as exc:
                raise RuntimeError(
                    f"malformed user whitebalance spec {wb_method!r}; "
                    "expected user[r,g,b] or user[r,g1,b,g2]") from exc
            if len(vals) == 3:
                vals = [vals[0], vals[1], vals[2], vals[1]]
            if len(vals) != 4:
                raise RuntimeError(
                    f"user whitebalance needs 3 or 4 values, got {vals}")
            wb = [float(v) for v in vals]
        else:
            h, w = self._raw.shape
            if method == "auto":
                region = [0, h - 1, 0, w - 1]
            else:
                try:
                    region = list(ast.literal_eval(wb_method[len("region"):]))
                except (SyntaxError, ValueError) as exc:
                    raise RuntimeError(
                        f"malformed region whitebalance spec {wb_method!r}; "
                        "expected region[rowmin,rowmax,colmin,colmax]") from exc
                if len(region) != 4:
                    raise RuntimeError(
                        f"region whitebalance needs [rowmin,rowmax,colmin,"
                        f"colmax], got {region}")
            sub = dk.safe_subtract_black(self._mosaic, self._color_map,
                                         self._black_levels)
            wb = dk.wb_from_region(sub, self._color_map,
                                   [int(v) for v in region]).cpu().tolist()
        logger.debug(f"White balance ({method}): {wb}")
        return [float(v) for v in wb]

    def _wb_array(self, wb_method: str) -> torch.Tensor:
        return torch.tensor(self.get_whitebalance(wb_method),
                            dtype=torch.float32, device=self._device)

    # -- conversions ------------------------------------------------------
    def rgb(self, luminance_method: str = "linear", subtract_black: bool = True,
            wb_method: str = "auto", print_stats: bool = False,
            renorm: bool = False, demosaic: str = "mhc") -> Tuple[np.ndarray, Dict]:
        """(H, W, 3) uint16 linear RGB (reference core/RawConv.py:401-486).

        ``demosaic``: 'mhc' (gradient-corrected, AHD-class — matches the
        reference's LibRaw postprocess quality), 'bilinear' or 'ahd'.
        """
        if luminance_method not in ("linear",):
            logger.error(f"Unexpected luminance method {luminance_method!r} "
                         "for rgb; allowed: ['linear']")
        wb = self._wb_array(wb_method)
        img = dk.raw_to_rgb(self._mosaic, self._color_map, self._black_levels,
                            wb, self._raw.white_level,
                            subtract_black=subtract_black,
                            algorithm=demosaic)
        return self._finalize(img, renorm, print_stats), self._raw.exif

    def grey(self, luminance_method: str = "linear", subtract_black: bool = True,
             wb_method: str = "auto", print_stats: bool = False,
             renorm: bool = False, demosaic: str = "mhc",
             fetch: bool = True) -> Tuple[np.ndarray, Dict]:
        """(H, W) uint16 luminance (reference core/RawConv.py:488-587).

        ``fetch=False`` returns the uint16 image still on the device (a
        tensor) so pipelined callers can overlap the device->host pull
        with the next frame's upload; requires ``print_stats=False``."""
        wb = self._wb_array(wb_method)
        if luminance_method == "direct":
            img = dk.raw_to_grey_direct(self._mosaic, self._color_map,
                                        self._black_levels, wb,
                                        subtract_black=subtract_black)
        elif luminance_method == "linear":
            img = dk.raw_to_grey_linear(self._mosaic, self._color_map,
                                        self._black_levels, wb,
                                        self._raw.white_level,
                                        subtract_black=subtract_black,
                                        algorithm=demosaic)
        else:
            msg = (f"Unexpected luminance method {luminance_method!r}; "
                   "allowed: ['linear', 'direct']")
            logger.error(msg)
            raise RuntimeError(msg)
        return (self._finalize(img, renorm, print_stats, fetch=fetch),
                self._raw.exif)

    def split(self, subtract_black: bool = True) -> Tuple[
            np.ndarray, np.ndarray, np.ndarray, np.ndarray, Dict]:
        """Four full-size per-band uint16 images R, G1, B, G2
        (reference core/RawConv.py:589-618)."""
        chans = dk.split_channels(self._mosaic, self._color_map,
                                  self._black_levels, subtract_black)
        # clip+cast on device: u16 down-transfer (half the f32 bytes)
        arrs = to_uint16(chans).cpu().numpy()
        return arrs[0], arrs[1], arrs[2], arrs[3], self._raw.exif

    # -- internals --------------------------------------------------------
    def _finalize(self, img: torch.Tensor, renorm: bool,
                  print_stats: bool, fetch: bool = True):
        if renorm:
            img = dk.percentile_renorm(img)
        if not print_stats:
            # clip+cast on DEVICE: the device->host transfer is u16
            # instead of f32 (half the bytes) and the host skips a
            # full-frame clip/cast pass.  ``fetch=False`` returns the
            # device tensor so a writer thread can pull it down while
            # the caller uploads the next frame
            dev = to_uint16(img)
            return dev.cpu().numpy() if fetch else dev
        out = img.cpu().numpy()
        logger.info(
            f"Image statistics: min={out.min():.1f} max={out.max():.1f} "
            f"mean={out.mean():.2f}+/-{out.std():.2f} "
            f"median={np.median(out):.1f} ADU")
        return np.clip(out, 0, self.MAX_ADU).astype(np.uint16)
