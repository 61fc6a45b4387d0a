"""Astrometric (plate) solving: astrometry.net client + local solver.

Equivalent of ApAstrometry (reference core/ApAstrometry.py:66-520):
reads the AP_XYPOS source list produced by ap_find_stars, generates
solve hints (center/radius from APRX_RA/APRX_DEC, scale bounds from the
plate-scale keywords with a scale_err_ratio, reference :176-274),
submits the XY list to nova.astrometry.net, and writes a WCS-stamped
copy of the image plus ra/dec columns in the source list (:455-494).

Differences from the reference, by design:

* the HTTP transport is an injectable callable so tests and offline
  batch runs never touch the network (SURVEY.md §4 item f);
* a LOCAL solve path: when a solved reference frame is available, the
  frame-to-frame registration (ops/register.py) plus TanWCS.fit
  produces an absolute WCS with no network at all (SURVEY.md §2.5
  astrometry.net row).

The JAX package's ``wcs/astrometry.py``: host code, but for
:func:`solve_from_reference`, which maps its grid through a port
``Similarity`` on that similarity's device.
"""

from __future__ import annotations

import math
import os
import re
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..io.fits import HDUList, Header, ImageHDU, open_fits
from ..utils.logger import get_logger
from .wcs import TanWCS

logger = get_logger("wcs.astrometry")

#: transport signature: (x, y, image_width, image_height, hints,
#: timeout) -> FITS-WCS-like dict of header keywords, or None on failure
Transport = Callable[..., Optional[Dict[str, float]]]

DEFAULT_TIMEOUT = 180.0  # reference core/ApAstrometry.py:380


class SolveTimeout(Exception):
    """A solve submission timed out; carries the submission id so the
    caller can monitor the SAME submission once more (the reference's
    resubmission-retry behavior, core/ApAstrometry.py:411-425 — the
    astroquery TimeoutError's args[1])."""

    def __init__(self, submission_id=None):
        super().__init__(f"solve timed out (submission {submission_id})")
        self.submission_id = submission_id


def generate_hints(
    srclist_hdr: Header,
    user_scale: Optional[float] = None,
    scale_err_ratio: float = 1.3,
) -> Dict[str, float]:
    """Solve hints from source-list keywords (reference _generate_hints,
    core/ApAstrometry.py:176-274)."""
    hints: Dict[str, float] = {}
    ra = srclist_hdr.get("RA-OBJ", srclist_hdr.get("APRX_RA"))
    dec = srclist_hdr.get("DEC-OBJ", srclist_hdr.get("APRX_DEC"))
    fov = xps = yps = None
    if user_scale is None:
        fov = srclist_hdr.get("APRX_FOV")
        xps = srclist_hdr.get("APRX_XPS")
        yps = srclist_hdr.get("APRX_YPS")
    else:
        cols = int(srclist_hdr.get("IMG_COLS", 4096))
        rows = int(srclist_hdr.get("IMG_ROWS", 4096))
        xsiz = cols * user_scale / 3600.0
        ysiz = rows * user_scale / 3600.0
        fov = math.hypot(xsiz, ysiz)
        xps = yps = user_scale
    if ra is not None and dec is not None:
        hints["center_ra"] = float(ra)
        hints["center_dec"] = float(dec)
        if fov is None:
            fov = 4.0  # reference's iTelescope upper bound guess
        hints["radius"] = math.ceil(float(fov) * 1.5 * scale_err_ratio)
    else:
        logger.warning("Could not estimate center_ra/center_dec/radius hints")
    if xps is not None and yps is not None:
        mean_ps = math.sqrt((float(xps) ** 2 + float(yps) ** 2) / 2)
        hints["scale_units"] = "arcsecperpix"
        hints["scale_type"] = "ul"
        hints["scale_lower"] = mean_ps / scale_err_ratio
        hints["scale_upper"] = mean_ps * scale_err_ratio
    else:
        logger.warning("Could not generate scale hints")
    return hints


def xylist_fits_bytes(x, y) -> bytes:
    """Source list as an astrometry.net FITS xylist (in-memory bytes).

    The xylist convention is a binary table extension with float64
    X and Y columns holding 1-based pixel coordinates, rows sorted
    brightest first — which ap_find_stars' AP_XYPOS table already is
    (reference core/ApFindStars.py:643-648).
    """
    from ..io.fits import BinTableHDU, HDUList, ImageHDU

    tbl = BinTableHDU({"X": np.asarray(x, np.float64),
                       "Y": np.asarray(y, np.float64)}, name="XYLIST")
    return HDUList([ImageHDU(None), tbl]).tobytes()


def _multipart_body(fields: Dict[str, str], file_field: str,
                    filename: str, file_bytes: bytes):
    """Encode a multipart/form-data body (text fields + one file part)."""
    import uuid

    boundary = uuid.uuid4().hex
    buf = bytearray()
    for name, value in fields.items():
        buf += (f"--{boundary}\r\n"
                f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
                f"{value}\r\n").encode()
    buf += (f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="{file_field}"; '
            f'filename="{filename}"\r\n'
            "Content-Type: application/octet-stream\r\n\r\n").encode()
    buf += file_bytes
    buf += f"\r\n--{boundary}--\r\n".encode()
    return bytes(buf), f"multipart/form-data; boundary={boundary}"


def nova_transport(api_key: str, use_sip: bool = False) -> Transport:
    """Real nova.astrometry.net transport (network).

    Implements the same protocol astroquery's ``solve_from_source_list``
    uses on behalf of the reference (core/ApAstrometry.py:398-409):
    login via request-json form post, then a multipart ``api/upload``
    whose file part is the source list as a FITS xylist binary table
    (nova has no JSON xylist endpoint), then submission/job polling.
    On success the solver's ACTUAL ``wcs_file`` is downloaded and its
    full WCS (CD matrix + SIP distortion) extracted with the in-repo
    FITS codec; the coarser calibration-summary TAN reconstruction is
    only a fallback if that download fails.  ``use_sip`` requests a SIP
    distortion polynomial of order 2 (``tweak_order``), matching the
    reference's --use-sip (core/ApAstrometry.py:382-386).  A timeout
    raises :class:`SolveTimeout` carrying the submission id; calling
    again with ``submission_id=<id>`` monitors the SAME submission
    instead of re-uploading.  Constructed lazily so offline use never
    imports urllib.
    """

    def solve(x, y, width, height, hints, timeout=DEFAULT_TIMEOUT,
              submission_id=None):
        import json
        import urllib.parse
        import urllib.request

        base = "https://nova.astrometry.net/api/"

        def post_json(path, payload):
            data = urllib.parse.urlencode(
                {"request-json": json.dumps(payload)}).encode()
            req = urllib.request.Request(base + path, data=data)
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        def get(path):
            with urllib.request.urlopen(base + path, timeout=30) as resp:
                return json.loads(resp.read())

        if submission_id is None:
            login = post_json("login", {"apikey": api_key})
            if login.get("status") != "success":
                raise RuntimeError(f"astrometry.net login failed: {login}")
            session = login["session"]
            upload_args = {
                "session": session,
                "image_width": int(width),
                "image_height": int(height),
                "parity": 2,        # reference core/ApAstrometry.py:401
                "positional_error": 10,
                "crpix_center": True,
                "publicly_visible": "n",
                "tweak_order": 2 if use_sip else 0,
                **hints,
            }
            body, content_type = _multipart_body(
                {"request-json": json.dumps(upload_args)},
                "file", "sources.xyls", xylist_fits_bytes(x, y))
            req = urllib.request.Request(
                base + "upload", data=body,
                headers={"Content-Type": content_type})
            with urllib.request.urlopen(req, timeout=60) as resp:
                sub = json.loads(resp.read())
            if sub.get("status") != "success":
                raise RuntimeError(f"astrometry.net upload failed: {sub}")
            subid = sub["subid"]
        else:
            subid = submission_id
        t0 = time.time()
        while time.time() - t0 < timeout:
            status = get(f"submissions/{subid}")
            jobs = [j for j in status.get("jobs", []) if j]
            for job in jobs:
                jstat = get(f"jobs/{job}")
                if jstat.get("status") == "success":
                    try:
                        # the solver's real WCS header (full CD + SIP),
                        # served outside the /api/ prefix
                        url = base[: -len("api/")] + f"wcs_file/{job}"
                        with urllib.request.urlopen(url, timeout=60) as r:
                            blob = r.read()
                        return wcs_keys_from_wcs_file(blob)
                    except Exception as exc:  # pragma: no cover - network
                        logger.warning(
                            f"wcs_file download failed ({exc}); falling "
                            "back to the calibration-summary TAN")
                        cal = get(f"jobs/{job}/calibration")
                        return _calibration_to_wcs(cal, width, height)
                if jstat.get("status") == "failure":
                    return None
            time.sleep(5)
        raise SolveTimeout(subid)

    return solve


#: header keywords lifted verbatim from a downloaded wcs_file: the core
#: TAN solution plus the full SIP forward/inverse polynomials
_WCS_FILE_KEY = re.compile(
    r"^(CTYPE[12]|CRVAL[12]|CRPIX[12]|CD[12]_[12]|CDELT[12]|CUNIT[12]|"
    r"EQUINOX|LONPOLE|LATPOLE|(A|B|AP|BP)_ORDER|(A|B|AP|BP)_[0-9]+_[0-9]+)$")


def wcs_keys_from_wcs_file(blob: bytes) -> Dict[str, float]:
    """WCS keyword dict from an astrometry.net ``wcs_file`` download —
    the solver's actual TAN(+SIP) solution, parsed with the in-repo
    FITS codec (the reference receives the same header via astroquery,
    core/ApAstrometry.py:398-409)."""
    from ..io.fits import open_fits_bytes

    hdr = open_fits_bytes(blob)[0].header
    return {k: v for k, v in hdr.items() if _WCS_FILE_KEY.match(k)}


def _calibration_to_wcs(cal: Dict, width: int, height: int) -> Dict[str, float]:
    """astrometry.net calibration dict -> WCS header keywords."""
    scale_deg = float(cal["pixscale"]) / 3600.0
    theta = math.radians(float(cal.get("orientation", 0.0)))
    parity = -1.0 if cal.get("parity", 1) < 0 else 1.0
    cd = np.array([[parity * scale_deg * math.cos(theta),
                    -scale_deg * math.sin(theta)],
                   [parity * scale_deg * math.sin(theta),
                    scale_deg * math.cos(theta)]])
    return {
        "CRVAL1": float(cal["ra"]), "CRVAL2": float(cal["dec"]),
        "CRPIX1": width / 2.0, "CRPIX2": height / 2.0,
        "CD1_1": cd[0, 0], "CD1_2": cd[0, 1],
        "CD2_1": cd[1, 0], "CD2_2": cd[1, 1],
        "CTYPE1": "RA---TAN", "CTYPE2": "DEC--TAN",
    }


class Astrometry:
    """Plate-solve an image from its source list and stamp the WCS."""

    def __init__(
        self,
        transport: Optional[Transport] = None,
        user_scale: Optional[float] = None,
        scale_err_ratio: float = 1.3,
    ) -> None:
        self._transport = transport
        self._user_scale = user_scale
        self._scale_err_ratio = scale_err_ratio

    def solve(
        self,
        image_path: str,
        srclist_path: str,
        output_path: str,
        xy_extension: str = "AP_XYPOS",
        timeout: float = DEFAULT_TIMEOUT,
    ) -> Optional[TanWCS]:
        """Solve and write the WCS-stamped image + updated source list."""
        img_hdus = open_fits(image_path)
        img_hdu = img_hdus[0]
        src_hdus = open_fits(srclist_path)
        src_hdr = src_hdus[0].header
        # provenance sanity check (reference _sanity_check, :435-453)
        want = src_hdr.get("IMG_FILE")
        if want and os.path.basename(image_path) != str(want):
            logger.warning(
                f"Source list was built from {want!r}, solving "
                f"{os.path.basename(image_path)!r} anyway")
        xy = src_hdus[xy_extension]
        x = np.asarray(xy["X"], float)
        y = np.asarray(xy["Y"], float)
        h, w = img_hdu.data.shape
        hints = generate_hints(src_hdr, self._user_scale,
                               self._scale_err_ratio)
        if self._transport is None:
            raise RuntimeError(
                "No astrometry transport configured; use "
                "nova_transport(api_key) or the local registration path")
        # timeout-resubmission retry (reference core/ApAstrometry.py:
        # 411-425): a first timeout keeps the submission alive and
        # monitors IT once more instead of re-uploading; a second
        # timeout gives up
        wcs_keys = None
        submission_id = None
        try_again = True
        while try_again:
            try:
                if submission_id is None:
                    wcs_keys = self._transport(x, y, w, h, hints,
                                               timeout=timeout)
                else:
                    try_again = False
                    wcs_keys = self._transport(
                        x, y, w, h, hints, timeout=timeout,
                        submission_id=submission_id)
            except SolveTimeout as exc:
                if try_again and submission_id is None \
                        and exc.submission_id is not None:
                    logger.warning(
                        f"Solve (submission {exc.submission_id}) timed "
                        f"out after {timeout} s; monitoring it once more")
                    submission_id = exc.submission_id
                else:
                    logger.error("Plate solve timed out twice")
                    return None
            else:
                try_again = False
        if wcs_keys is None:
            logger.error("Plate solve failed")
            return None
        out_hdr = img_hdu.header.copy()
        for k, v in wcs_keys.items():
            out_hdr[k] = v
        out_hdr["ASTRSOLV"] = (True, "Astrometric solution succeeded")
        out_hdr.add_history("WCS from astrometry.net source-list solve")
        HDUList([ImageHDU(img_hdu.data, out_hdr)]).writeto(output_path)
        wcs = TanWCS.from_header(out_hdr)
        self._update_sourcelist(src_hdus, srclist_path, wcs, xy_extension)
        logger.info(f"Solved {image_path}: center "
                    f"RA={wcs.crval[0]:.5f} Dec={wcs.crval[1]:.5f}, "
                    f"scale {wcs.pixel_scale_arcsec:.3f} arcsec/pix")
        return wcs

    @staticmethod
    def _update_sourcelist(src_hdus: HDUList, srclist_path: str,
                           wcs: TanWCS, xy_extension: str) -> None:
        """Add ra/dec columns to the XY table (reference
        _update_sourcelist, :455-494)."""
        xy = src_hdus[xy_extension]
        ra, dec = wcs.pix2world(np.asarray(xy["X"]), np.asarray(xy["Y"]))
        xy.columns["ra"] = ra
        xy.columns["dec"] = dec
        src_hdus.writeto(srclist_path)


def solve_from_reference(
    ref_wcs: TanWCS,
    sim,  # ops.register.Similarity mapping ref pixels -> target pixels
    sip_order: int = 2,
) -> TanWCS:
    """Absolute WCS for a frame registered against a solved reference.

    Maps a grid of reference pixels through the reference WCS (sky) and
    the similarity (target pixels), then fits a TAN(+SIP) solution —
    the local, network-free plate solve used by the stacking path.
    ``sip_order=2`` matches the SIP order the reference requests from
    the network solve (core/ApAstrometry.py:382-409); it carries any
    reference-frame distortion through to the target WCS.  Pass 0 for a
    pure TAN.
    """
    import torch

    gx, gy = np.meshgrid(np.linspace(1, 2 * ref_wcs.crpix[0], 8),
                         np.linspace(1, 2 * ref_wcs.crpix[1], 8))
    gx = gx.ravel()
    gy = gy.ravel()
    ra, dec = ref_wcs.pix2world(gx, gy)
    # Similarity maps (0-based) ref -> target; convert FITS 1-based.
    # The grid goes through the similarity in float32 on its device, as
    # the JAX package computes it (x64 off), and comes back float32
    dev = sim.scale.device
    tx, ty = sim.apply(torch.from_numpy(gx - 1.0).to(dev, torch.float32),
                       torch.from_numpy(gy - 1.0).to(dev, torch.float32))
    tx = tx.cpu().numpy() + 1.0
    ty = ty.cpu().numpy() + 1.0
    sip_order = sip_order if (ref_wcs.sip_a or ref_wcs.sip_b) else 0
    return TanWCS.fit(tx, ty, ra, dec, sip_order=sip_order)
