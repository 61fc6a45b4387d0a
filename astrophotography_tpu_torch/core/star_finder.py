"""StarFinder: detection + photometry + PSF + quality reporting engine.

Mirrors the reference ApFindStars surface and outputs
(reference core/ApFindStars.py:87-1079): sigma-clipped background
statistics with a source mask, saturation peak masking, DAOFIND-style
detection, aperture photometry sorted/trimmed to max_sources, PSF FWHM
measurement (delegating to the batched Gaussian fitter — the reference
delegates to ApMeasureStars), source-list FITS (AP_XYPOS with 1-based
coordinates for astrometry.net, AP_L1MAG photometry, AP_L1PSF fits),
the quality-report YAML schema
(image/background/source/saturation/psf sections, :918-1079), and ds9
region files (:878-916).  All array work runs on the device ops.

The JAX package's ``core/star_finder.py``.  The image lives on
``device`` (CUDA when not given); each device result the host needs
comes down in one transfer (the photometry table, the PSF fits), and the
sort, trim and table build run on the host.  ``yaml`` and
``matplotlib`` are imported by the methods that write YAML or plot.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..io.fits import BinTableHDU, HDUList, Header, ImageHDU, read_image_device
from ..ops import (aperture_photometry, aperture_radii, find_saturated,
                   find_stars, isolated_mask, mask_boxes, measure_fwhm,
                   median_fwhm, sigma_clipped_stats, source_mask)
from ..ops.psf import PSFFits
from ..utils.logger import get_logger

logger = get_logger("core.star_finder")

NULL_VAL = -999


def _download(fields) -> list:
    """(n,) device tensors as host numpy arrays, in one transfer (float32
    on the way; bool fields come back bool)."""
    host = torch.stack([f.to(torch.float32) for f in fields]).cpu().numpy()
    return [h.astype(bool) if f.dtype == torch.bool else h
            for h, f in zip(host, fields)]


class StarFinder:
    """Find, photometer, and characterize stars in a FITS image."""

    def __init__(
        self,
        fitsimg: str,
        search_fwhm: float = 3.0,
        search_nsigma: float = 7.0,
        bitdepth: int = 16,
        sat_frac: float = 0.80,
        max_sources: Optional[int] = None,
        nosatmask: bool = False,
        capacity: int = 1024,
        device=None,
    ) -> None:
        self._fitsimg = fitsimg
        self._search_fwhm = search_fwhm
        self._search_nsigma = search_nsigma
        self._max_sources = max_sources
        self._capacity = capacity
        self._sat_thresh = sat_frac * (2 ** bitdepth - 1)
        # native-width transfer + on-device f32 conversion (halves the
        # host->device bytes for 16-bit detector frames)
        self._data, hdr = read_image_device(fitsimg, device=device)
        self._hdr = hdr
        self._fwhm_both = self._fwhm_x = self._fwhm_y = None
        self._nsrcs_fitted = 0
        self._psf = None

        # background stats with a source mask
        # (reference core/ApFindStars.py:142-154)
        smask = source_mask(self._data, nsigma=3.0, dilate=11)
        # mask convention: True = valid, so exclude source pixels
        _, med, std = sigma_clipped_stats(self._data, mask=~smask, sigma=3.0)
        self._bg_median = float(med)
        self._bg_stddev = float(std)
        logger.info(f"Background median {self._bg_median:.2f} ADU, "
                    f"stddev {self._bg_stddev:.2f} ADU")

        # saturated-star masking (reference :159-189)
        sx, sy, sv = find_saturated(self._data, self._sat_thresh)
        self._nsrcs_saturated = int(sv.sum())
        self._mask = None
        if not nosatmask and self._nsrcs_saturated:
            half = max(4, int(round(4 * search_fwhm)))
            self._mask = mask_boxes(self._data.shape, sx, sy, sv, half)
            logger.info(f"Masked {self._nsrcs_saturated} saturated stars "
                        f"with {2 * half + 1}-px boxes")

        self.source_search(search_fwhm, search_nsigma)
        self.aperture_photometry()

    # ------------------------------------------------------------------
    def source_search(self, search_fwhm: float, search_nsigma: float) -> None:
        """(Re)detect sources (reference source_search, :299-340)."""
        self._search_fwhm = float(search_fwhm)
        self._search_nsigma = float(search_nsigma)
        stars = find_stars(
            self._data - self._bg_median, fwhm=self._search_fwhm,
            threshold=self._search_nsigma * self._bg_stddev,
            max_stars=self._capacity, mask=self._mask)
        self._stars = stars
        self._nsrcs_detected = int(stars.valid.sum())
        logger.info(
            f"Found {self._nsrcs_detected} sources at FWHM="
            f"{self._search_fwhm:.2f}, nsigma={self._search_nsigma}")

    def aperture_photometry(self) -> Dict[str, np.ndarray]:
        """Photometer current sources; sort by brightness and trim
        (reference aperture_photometry, :363-446)."""
        r_ap, r_out = aperture_radii(self._search_fwhm)
        exposure = None
        for kw in ("EXPOSURE", "EXPTIME"):
            if exposure is None and kw in self._hdr:
                exposure = float(self._hdr[kw])
        if exposure is None:
            logger.warning("EXPOSURE not found in header; assuming 1 second")
            exposure = 1.0
        st = self._stars
        phot = aperture_photometry(self._data, st.x, st.y, st.valid, r_ap,
                                   r_out, exposure=exposure)
        # one download of the (capacity,) tables; sort and trim on the host
        (valid, x, y, peak, sharp, rnd, ap_sum, bgmed, adups,
         mag) = _download([st.valid, st.x, st.y, st.peak, st.sharpness,
                           st.roundness, phot.aperture_sum,
                           phot.bgmed_per_pix, phot.adu_per_sec,
                           phot.magnitude])
        order = np.argsort(-np.where(valid, adups, -np.inf))
        n = valid.sum()
        order = order[:n]
        table = {
            "id": np.arange(1, n + 1, dtype=np.int32),
            "xcenter": x[order],
            "ycenter": y[order],
            "aperture_sum": ap_sum[order],
            "peak_adu": peak[order],
            "psbl_sat": peak[order] > self._sat_thresh,
            "bgmed_per_pix": bgmed[order],
            "adu_per_sec": adups[order],
            "magnitude": mag[order],
            "sharpness": sharp[order],
            "roundness": rnd[order],
        }
        self._full_table = table
        if self._max_sources is not None and n > self._max_sources:
            table = {k: v[: self._max_sources] for k, v in table.items()}
        self._table = table
        self._nsrcs_photom = len(table["id"])
        return table

    # ------------------------------------------------------------------
    @staticmethod
    def select_fit_candidates(
        x: np.ndarray,
        y: np.ndarray,
        brightness: np.ndarray,
        shape: Tuple[int, int],
        box: int,
        per_region: int = 5,
    ) -> np.ndarray:
        """Region-based PSF-fit candidate selection.

        Reference ApMeasureStars scheme (core/ApMeasureStars.py:790-950):
        the image is split into a central region plus four quadrants;
        after excluding stars within box/2 of the edges, the brightest
        ``per_region`` stars of each region are selected.  (Neighbor
        isolation is applied separately on device.)  Returns a boolean
        selection mask.
        """
        h, w = shape
        margin = box // 2
        ok = ((x >= margin) & (x < w - margin)
              & (y >= margin) & (y < h - margin))
        # center box: middle half of each axis; quadrants split the rest
        in_center = ((x >= w / 4) & (x < 3 * w / 4)
                     & (y >= h / 4) & (y < 3 * h / 4))
        region = np.where(in_center, 0,
                          1 + (x >= w / 2).astype(int)
                          + 2 * (y >= h / 2).astype(int))
        selected = np.zeros(len(x), bool)
        for r in range(5):
            members = np.where(ok & (region == r))[0]
            if len(members):
                order = members[np.argsort(-brightness[members])]
                selected[order[:per_region]] = True
        return selected

    def measure_fwhm(self, direction: str = "both", per_region: int = 5):
        """Fit star PSFs and estimate the median FWHM
        (reference measure_fwhm, :474-553 delegating to ApMeasureStars)."""
        box = max(12, 2 * int(3 * self._search_fwhm))
        dev = self._data.device
        x = torch.from_numpy(self._table["xcenter"]).to(dev)
        y = torch.from_numpy(self._table["ycenter"]).to(dev)
        n = len(self._table["id"])
        if n == 0:
            # zero detections: no cutouts to fit — report NaN medians
            # (written as blank FITS cards) instead of crashing on
            # zero-size reductions
            nan = float("nan")
            self._psf = None
            self._nsrcs_fitted = 0
            self._fwhm_x = self._fwhm_y = (nan, nan, 0)
            self._fwhm_both = (nan, nan, 0)
            logger.warning("measure_fwhm: no detected sources to fit")
            if direction == "x":
                return self._fwhm_x
            if direction == "y":
                return self._fwhm_y
            return self._fwhm_both
        sel = self.select_fit_candidates(
            self._table["xcenter"], self._table["ycenter"],
            self._table["adu_per_sec"], self._data.shape, box,
            per_region=per_region)
        valid = torch.from_numpy(sel).to(dev)
        iso = isolated_mask(x, y, torch.ones(n, dtype=torch.bool, device=dev),
                            min_sep=float(box))
        valid = valid & iso
        # fall back to brightest stars if region selection empties out
        valid = torch.where(valid.any(), valid,
                            torch.arange(n, device=dev) < min(n, 5 * per_region))
        fits = measure_fwhm(self._data, x, y, valid,
                            init_fwhm=self._search_fwhm, box=box)
        (mfx, sfx), (mfy, sfy) = median_fwhm(fits)
        # the fits and their medians come down in one transfer each
        mfx, sfx, mfy, sfy = torch.stack([mfx, sfx, mfy, sfy]).cpu().tolist()
        fits = PSFFits(*_download(list(fits)))
        self._psf = fits
        self._nsrcs_fitted = int(fits.valid.sum())
        nfit = self._nsrcs_fitted
        self._fwhm_x = (float(mfx), float(sfx), nfit)
        self._fwhm_y = (float(mfy), float(sfy), nfit)
        both = np.concatenate([fits.fwhm_x[fits.valid],
                               fits.fwhm_y[fits.valid]])
        if both.size:
            med = float(np.median(both))
            mad = float(1.4826 * np.median(np.abs(both - med)))
        else:
            med, mad = float("nan"), float("nan")
        self._fwhm_both = (med, mad, nfit * 2)
        logger.info(f"Median FWHM: {med:.2f} +/- {mad:.2f} pix "
                    f"({nfit} stars fit)")
        if direction == "x":
            return self._fwhm_x
        if direction == "y":
            return self._fwhm_y
        return self._fwhm_both

    # ------------------------------------------------------------------
    def _keyword_dictionary(self) -> Dict[str, Tuple]:
        """(value, comment) pairs for the source list primary header
        (reference _build_keyword_dictionary, :761-849)."""
        hdr = self._hdr
        kw: Dict[str, Tuple] = {
            "IMG_FILE": (os.path.basename(self._fitsimg),
                         "Name of image file searched for stars"),
            "IMG_COLS": (int(self._data.shape[1]),
                         "Number of columns in input image"),
            "IMG_ROWS": (int(self._data.shape[0]),
                         "Number of rows in input image"),
            "AP_NDET": (self._nsrcs_detected,
                        "Number of sources detected in the image."),
            "AP_NPHOT": (self._nsrcs_photom,
                         "Number of sources final photometry."),
            "AP_NFIT": (self._nsrcs_fitted,
                        "Number of sources used in FWHM fitting."),
            "AP_NSIGM": (self._search_nsigma,
                         "Source searching threshold (sigma above background)"),
        }
        for okw in ("OBJECT", "TELESCOP", "FILTER", "DATE-OBS", "EXPOSURE",
                    "EXPTIME", "CCD-TEMP", "EGAIN", "GAIN", "AIRMASS",
                    "FOCALLEN", "XPIXSZ", "YPIXSZ", "RA", "DEC"):
            if okw in hdr:
                kw[okw] = (hdr[okw], hdr.comments.get(okw, ""))
        # approximate center coordinates: RA stored in hours, DEC in deg
        if "RA" in kw and "DEC" in kw:
            try:
                ra_deg = _parse_angle(str(kw["RA"][0]), hours=True)
                dec_deg = _parse_angle(str(kw["DEC"][0]), hours=False)
                kw["APRX_RA"] = (ra_deg, "[deg] Approximate image center RA")
                kw["APRX_DEC"] = (dec_deg, "[deg] Approximate image center Dec")
            except ValueError:
                logger.warning("Could not parse RA/DEC keywords")
        # plate scale from focal length + pixel size
        if all(k in kw for k in ("FOCALLEN", "XPIXSZ", "YPIXSZ")):
            focal_mm = float(kw["FOCALLEN"][0])
            cols, rows = int(self._data.shape[1]), int(self._data.shape[0])
            xps_deg = math.degrees(float(kw["XPIXSZ"][0]) * 1e-6
                                   / (focal_mm * 1e-3))
            yps_deg = math.degrees(float(kw["YPIXSZ"][0]) * 1e-6
                                   / (focal_mm * 1e-3))
            fov = math.hypot(cols * xps_deg, rows * yps_deg)
            kw["APRX_FOV"] = (fov, "[deg] Approximate diagonal size of image")
            kw["APRX_XWD"] = (cols * xps_deg,
                              "[deg] Approximate X-axis width of image")
            kw["APRX_YHG"] = (rows * yps_deg,
                              "[deg] Approximate Y-axis height of image")
            kw["APRX_XPS"] = (3600 * xps_deg,
                              "[arcseconds] Approximate X-axis plate scale")
            kw["APRX_YPS"] = (3600 * yps_deg,
                              "[arcseconds] Approximate Y-axis plate scale")
        if self._fwhm_both is not None:
            # zero fitted stars leaves NaN medians, which FITS headers
            # cannot encode — write blank (undefined-value) cards so
            # the source list is still produced; readers get None back
            med, mad = self._fwhm_both[0], self._fwhm_both[1]
            kw["AP_FWHM"] = (med if np.isfinite(med) else None,
                             "[pix] Median FWHM of fitted stars in image")
            kw["AP_EFWHM"] = (mad if np.isfinite(mad) else None,
                              "[pix] MAD standard deviation of fitted FWHM")
        kw["AP_BGMED"] = (self._bg_median,
                          "[ADU] Median source-masked background level")
        kw["AP_BGSTD"] = (self._bg_stddev,
                          "[ADU] Std dev of source-masked background level")
        return kw

    def write_source_list(self, path: str) -> None:
        """AP_XYPOS (1-based) + AP_L1MAG (+AP_L1PSF) FITS tables
        (reference _write_source_list, :627-678)."""
        kw = self._keyword_dictionary()
        pri_hdr = Header()
        for k, vc in kw.items():
            if k in ("RA", "DEC") or len(k) <= 8:
                pri_hdr[k] = vc
        xy = BinTableHDU(
            {"X": self._table["xcenter"] + 1.0,
             "Y": self._table["ycenter"] + 1.0}, name="AP_XYPOS")
        xy.header.add_comment("Uses FITS 1-based pixel coordinate system.")
        mag = BinTableHDU(dict(self._table), name="AP_L1MAG")
        mag.header.add_comment("Aperture photometry within StarFinder.")
        mag.header.add_comment("Uses python 0-based pixel coordinate system.")
        hdus = HDUList([ImageHDU(None, pri_hdr), xy, mag])
        if self._psf is not None:
            psf_h = self._psf
            pv = psf_h.valid
            psf = BinTableHDU(
                {"x0": psf_h.x0[pv],
                 "y0": psf_h.y0[pv],
                 "fwhm_x": psf_h.fwhm_x[pv],
                 "fwhm_y": psf_h.fwhm_y[pv],
                 "theta": psf_h.theta[pv],
                 "amplitude": psf_h.amplitude[pv],
                 "background": psf_h.background[pv],
                 "chi2_red": psf_h.chi2_red[pv],
                 "axial_ratio": psf_h.axial_ratio[pv],
                 "circular": psf_h.circular[pv]},
                name="AP_L1PSF")
            psf.header.add_comment("PSF characterization (batched LM fits).")
            hdus.append(psf)
        hdus.writeto(path)
        logger.info(f"Wrote source list to {path}")

    def write_ds9_region_file(self, path: str) -> None:
        """ds9 region file of photometry apertures
        (reference write_ds9_region_file, :878-916)."""
        r_ap, _ = aperture_radii(self._search_fwhm)
        with open(path, "w") as fh:
            fh.write("# Region file format: DS9 version 4.1\n")
            fh.write('global color=green dashlist=8 3 width=1'
                     ' select=1 highlite=1 dash=0 fixed=0 edit=1'
                     ' move=1 delete=1 include=1 source=1\n')
            fh.write("image\n")
            for x, y, sat in zip(self._table["xcenter"],
                                 self._table["ycenter"],
                                 self._table["psbl_sat"]):
                color = " # color=red" if sat else ""
                fh.write(f"circle({x + 1:.2f},{y + 1:.2f},{r_ap}){color}\n")
        logger.info(f"Wrote ds9 region file to {path}")

    def write_quality_report(self, path: str) -> None:
        """Quality-report YAML, schema-compatible with the reference
        (write_quality_report, :918-1079)."""
        kw = self._keyword_dictionary()

        im_map = {"file": "IMG_FILE", "ncols": "IMG_COLS", "nrows": "IMG_ROWS",
                  "object": "OBJECT", "telescope": "TELESCOP",
                  "filter": "FILTER", "date-obs": "DATE-OBS",
                  "exposure": "EXPOSURE", "ccd_temperature": "CCD-TEMP",
                  "electronic_gain": "EGAIN", "airmass": "AIRMASS",
                  "approx_width_deg": "APRX_XWD",
                  "approx_height_deg": "APRX_YHG",
                  "approx_xpixsiz_arcs": "APRX_XPS",
                  "approx_ypixsiz_arcs": "APRX_YPS"}
        im_info = {k: _plain(kw[fkw][0]) for k, fkw in im_map.items()
                   if fkw in kw}
        bg_info = {"median": self._bg_median, "stddev": self._bg_stddev}
        adups = self._full_table["adu_per_sec"]
        src_info = {
            "num_detected": self._nsrcs_detected,
            "num_with_photometry": self._nsrcs_photom,
            "search_nsigma": self._search_nsigma,
            "adups_brightest": float(adups[0]) if len(adups) else NULL_VAL,
            "adups_median": float(adups[len(adups) // 2]) if len(adups)
            else NULL_VAL,
            "adups_faintest": float(adups[-1]) if len(adups) else NULL_VAL,
        }
        sat_info = {
            "num_saturated_in_image": self._nsrcs_saturated,
            "num_saturated_in_photometry":
                int(np.sum(self._table["psbl_sat"])),
        }
        psf_info: Dict = {"num_fit": self._nsrcs_fitted}
        if self._psf is not None and self._fwhm_both is not None:
            have_ps = "APRX_XPS" in kw and "APRX_YPS" in kw
            xps = float(kw["APRX_XPS"][0]) if have_ps else NULL_VAL
            yps = float(kw["APRX_YPS"][0]) if have_ps else NULL_VAL
            avg_ps = math.sqrt(0.5 * (xps ** 2 + yps ** 2)) if have_ps \
                else NULL_VAL
            fx, fxe, _ = self._fwhm_x
            fy, fye, _ = self._fwhm_y
            psf_info["circular_psf"] = bool(
                abs(fx - fy) < 3.0 * math.sqrt(fxe ** 2 + fye ** 2))
            for name, tup, ps in (("fwhm_xandy", self._fwhm_both, avg_ps),
                                  ("fwhm_x", self._fwhm_x, xps),
                                  ("fwhm_y", self._fwhm_y, yps)):
                val, err, npts = tup
                psf_info[name] = {
                    "fwhm_val_pix": val,
                    "fwhm_err_pix": err,
                    "fwhm_val_arcs": val * ps if ps != NULL_VAL else NULL_VAL,
                    "fwhm_err_arcs": err * ps if ps != NULL_VAL else NULL_VAL,
                    "num_data_pts": npts,
                }
        report = {
            "image_info": im_info,
            "background_info": bg_info,
            "source_info": src_info,
            "saturation_info": sat_info,
            "psf_info": psf_info,
        }
        import yaml

        with open(path, "w") as fh:
            yaml.dump(_plain(report), fh, indent=4, sort_keys=False)
        logger.info(f"Wrote image quality report to {path}")

    def plot_image(self, path: str, figsize=(10, 8)) -> None:
        """Asinh-stretched image with aperture overlays
        (reference plot_image, core/ApFindStars.py:224-270)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Circle

        data = self._data.cpu().numpy()
        med = self._bg_median
        std = max(self._bg_stddev, 1e-3)
        stretched = np.arcsinh(np.clip((data - med) / std, -2, None))
        fig, ax = plt.subplots(figsize=figsize)
        im = ax.imshow(stretched, origin="lower", cmap="gray",
                       interpolation="nearest")
        r_ap, _ = aperture_radii(self._search_fwhm)
        for x, y, sat in zip(self._table["xcenter"], self._table["ycenter"],
                             self._table["psbl_sat"]):
            ax.add_patch(Circle((x, y), r_ap, fill=False, lw=0.8,
                                color="red" if sat else "lime"))
        ax.set_title(f"{os.path.basename(self._fitsimg)}: "
                     f"{self._nsrcs_photom} sources")
        fig.colorbar(im, ax=ax, label="asinh((ADU - bg)/sigma)")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        logger.info(f"Wrote detection plot to {path}")

    def plot_fits(self, path: str, max_stars: int = 25) -> None:
        """Grid of PSF-fit cutouts (reference _plot_fits,
        core/ApMeasureStars.py:624-751 — 5x5 subplot grid)."""
        if self._psf is None:
            raise RuntimeError("run measure_fwhm() before plot_fits()")
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        data = self._data.cpu().numpy()
        v = self._psf.valid
        idx = np.where(v)[0][:max_stars]
        ncols = 5
        nrows = max(1, (len(idx) + ncols - 1) // ncols)
        fig, axes = plt.subplots(nrows, ncols,
                                 figsize=(2.2 * ncols, 2.2 * nrows))
        axes = np.atleast_2d(axes)
        box = max(12, 2 * int(3 * self._search_fwhm))
        half = box // 2
        h, w = data.shape
        for k, i in enumerate(idx):
            ax = axes[k // ncols, k % ncols]
            cx = int(round(float(self._psf.x0[i])))
            cy = int(round(float(self._psf.y0[i])))
            y0 = min(max(cy - half, 0), h - box)
            x0 = min(max(cx - half, 0), w - box)
            ax.imshow(data[y0:y0 + box, x0:x0 + box], origin="lower",
                      cmap="viridis")
            fx = float(self._psf.fwhm_x[i])
            fy = float(self._psf.fwhm_y[i])
            ax.set_title(f"{fx:.2f}x{fy:.2f} px", fontsize=7)
            ax.set_xticks([])
            ax.set_yticks([])
        for k in range(len(idx), nrows * ncols):
            axes[k // ncols, k % ncols].axis("off")
        fig.suptitle("PSF fit cutouts (FWHM x by y)")
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        logger.info(f"Wrote PSF fit plot to {path}")

    # -- accessors ---------------------------------------------------------
    @property
    def table(self) -> Dict[str, np.ndarray]:
        return self._table

    @property
    def bg_median(self) -> float:
        return self._bg_median

    @property
    def bg_stddev(self) -> float:
        return self._bg_stddev


def _plain(v):
    """Convert numpy scalars/arrays to plain Python for YAML output."""
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def _parse_angle(text: str, hours: bool) -> float:
    """Parse '12:34:56.7' sexagesimal or decimal degrees/hours to degrees."""
    text = text.strip()
    neg = text.startswith("-")
    parts = text.lstrip("+-").split(":")
    if len(parts) == 1:
        val = float(parts[0])
    else:
        nums = [float(p) for p in parts]
        val = nums[0] + nums[1] / 60.0 + (nums[2] if len(nums) > 2 else 0.0) / 3600.0
    if neg:
        val = -val
    if hours:
        val *= 15.0
    return val
