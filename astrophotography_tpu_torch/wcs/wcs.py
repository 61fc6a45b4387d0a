"""TAN (gnomonic) world coordinate system with optional SIP distortion.

Replacement for the astropy.wcs usage in the reference
(core/ApAstrometry.py:455-494 ``wcs.all_pix2world`` on astrometry.net
solutions; header keyword conventions CRVAL/CRPIX/CD/CTYPE per the
FITS WCS papers).  Implements:

* pixel -> world (``all_pix2world``-equivalent): SIP forward
  polynomial (A/B coefficients) + CD matrix + gnomonic deprojection;
* world -> pixel via the inverse gnomonic projection and iterative SIP
  inversion;
* round-trip through FITS headers.

Convention: FITS 1-based pixel coordinates at the interface, matching
astropy's ``all_pix2world(x, y, 1)`` usage in the reference.

The JAX package's ``wcs/wcs.py``: pure float64 numpy, kept identical.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.fits import Header

_D2R = math.pi / 180.0


class TanWCS:
    """TAN[-SIP] projection: CRPIX/CRVAL/CD (+ optional A/B SIP polys)."""

    def __init__(
        self,
        crval: Tuple[float, float],
        crpix: Tuple[float, float],
        cd: np.ndarray,
        sip_a: Optional[Dict[Tuple[int, int], float]] = None,
        sip_b: Optional[Dict[Tuple[int, int], float]] = None,
    ) -> None:
        self.crval = (float(crval[0]), float(crval[1]))
        self.crpix = (float(crpix[0]), float(crpix[1]))
        self.cd = np.asarray(cd, dtype=np.float64).reshape(2, 2)
        self.sip_a = dict(sip_a or {})
        self.sip_b = dict(sip_b or {})

    # -- header round trip -------------------------------------------------
    @classmethod
    def from_header(cls, hdr: Header) -> "TanWCS":
        ctype1 = str(hdr.get("CTYPE1", "RA---TAN"))
        if "TAN" not in ctype1:
            raise ValueError(f"unsupported projection {ctype1!r}")
        if "CD1_1" in hdr:
            cd = np.array([[hdr["CD1_1"], hdr.get("CD1_2", 0.0)],
                           [hdr.get("CD2_1", 0.0), hdr["CD2_2"]]], float)
        elif "CDELT1" in hdr:
            rot = float(hdr.get("CROTA2", 0.0)) * _D2R
            cd1, cd2 = float(hdr["CDELT1"]), float(hdr["CDELT2"])
            cd = np.array([[cd1 * math.cos(rot), -cd2 * math.sin(rot)],
                           [cd1 * math.sin(rot), cd2 * math.cos(rot)]])
        else:
            raise ValueError("no CD matrix or CDELT in header")
        sip_a: Dict[Tuple[int, int], float] = {}
        sip_b: Dict[Tuple[int, int], float] = {}
        if "-SIP" in ctype1 or "A_ORDER" in hdr:
            a_order = int(hdr.get("A_ORDER", 0))
            b_order = int(hdr.get("B_ORDER", 0))
            for p in range(a_order + 1):
                for q in range(a_order + 1 - p):
                    key = f"A_{p}_{q}"
                    if key in hdr:
                        sip_a[(p, q)] = float(hdr[key])
            for p in range(b_order + 1):
                for q in range(b_order + 1 - p):
                    key = f"B_{p}_{q}"
                    if key in hdr:
                        sip_b[(p, q)] = float(hdr[key])
        return cls((float(hdr["CRVAL1"]), float(hdr["CRVAL2"])),
                   (float(hdr["CRPIX1"]), float(hdr["CRPIX2"])),
                   cd, sip_a, sip_b)

    def to_header(self, hdr: Optional[Header] = None) -> Header:
        hdr = hdr if hdr is not None else Header()
        sip = "-SIP" if (self.sip_a or self.sip_b) else ""
        hdr["CTYPE1"] = (f"RA---TAN{sip}", "Gnomonic projection")
        hdr["CTYPE2"] = (f"DEC--TAN{sip}", "Gnomonic projection")
        hdr["CRVAL1"] = (self.crval[0], "[deg] RA at reference point")
        hdr["CRVAL2"] = (self.crval[1], "[deg] Dec at reference point")
        hdr["CRPIX1"] = (self.crpix[0], "Reference pixel X (1-based)")
        hdr["CRPIX2"] = (self.crpix[1], "Reference pixel Y (1-based)")
        hdr["CD1_1"] = float(self.cd[0, 0])
        hdr["CD1_2"] = float(self.cd[0, 1])
        hdr["CD2_1"] = float(self.cd[1, 0])
        hdr["CD2_2"] = float(self.cd[1, 1])
        hdr["CUNIT1"] = "deg"
        hdr["CUNIT2"] = "deg"
        hdr["EQUINOX"] = 2000.0
        if self.sip_a or self.sip_b:
            a_ord = max((p + q for p, q in self.sip_a), default=0)
            b_ord = max((p + q for p, q in self.sip_b), default=0)
            hdr["A_ORDER"] = a_ord
            hdr["B_ORDER"] = b_ord
            for (p, q), v in sorted(self.sip_a.items()):
                hdr[f"A_{p}_{q}"] = v
            for (p, q), v in sorted(self.sip_b.items()):
                hdr[f"B_{p}_{q}"] = v
        return hdr

    # -- transforms --------------------------------------------------------
    def _sip_forward(self, u: np.ndarray, v: np.ndarray):
        if not (self.sip_a or self.sip_b):
            return u, v
        du = np.zeros_like(u)
        dv = np.zeros_like(v)
        for (p, q), coef in self.sip_a.items():
            du = du + coef * (u ** p) * (v ** q)
        for (p, q), coef in self.sip_b.items():
            dv = dv + coef * (u ** p) * (v ** q)
        return u + du, v + dv

    def pix2world(self, x, y):
        """FITS 1-based pixel coords -> (ra, dec) in degrees."""
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        u = x - self.crpix[0]
        v = y - self.crpix[1]
        u, v = self._sip_forward(u, v)
        xi = self.cd[0, 0] * u + self.cd[0, 1] * v     # deg
        eta = self.cd[1, 0] * u + self.cd[1, 1] * v
        xi_r = xi * _D2R
        eta_r = eta * _D2R
        ra0 = self.crval[0] * _D2R
        dec0 = self.crval[1] * _D2R
        denom = np.cos(dec0) - eta_r * np.sin(dec0)
        ra = ra0 + np.arctan2(xi_r, denom)
        dec = np.arctan((np.sin(dec0) + eta_r * np.cos(dec0))
                        / np.sqrt(xi_r ** 2 + denom ** 2))
        return (np.degrees(ra) % 360.0), np.degrees(dec)

    def world2pix(self, ra, dec, maxiter: int = 20, tol: float = 1e-10):
        """(ra, dec) degrees -> FITS 1-based pixel coords."""
        ra = np.asarray(ra, dtype=np.float64) * _D2R
        dec = np.asarray(dec, dtype=np.float64) * _D2R
        ra0 = self.crval[0] * _D2R
        dec0 = self.crval[1] * _D2R
        cosc = (np.sin(dec0) * np.sin(dec)
                + np.cos(dec0) * np.cos(dec) * np.cos(ra - ra0))
        xi = np.cos(dec) * np.sin(ra - ra0) / cosc / _D2R
        eta = ((np.cos(dec0) * np.sin(dec)
                - np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)) / cosc / _D2R)
        inv_cd = np.linalg.inv(self.cd)
        U = inv_cd[0, 0] * xi + inv_cd[0, 1] * eta
        V = inv_cd[1, 0] * xi + inv_cd[1, 1] * eta
        # iterative SIP inversion: find (u, v) with sip_forward(u,v) = (U,V)
        u = np.array(U, copy=True)
        v = np.array(V, copy=True)
        if self.sip_a or self.sip_b:
            for _ in range(maxiter):
                fu, fv = self._sip_forward(u, v)
                du = U - fu
                dv = V - fv
                u = u + du
                v = v + dv
                if np.max(np.abs(du)) < tol and np.max(np.abs(dv)) < tol:
                    break
        return u + self.crpix[0], v + self.crpix[1]

    # -- convenience -------------------------------------------------------
    @property
    def pixel_scale_arcsec(self) -> float:
        """Mean plate scale in arcsec/pixel from the CD determinant."""
        return math.sqrt(abs(np.linalg.det(self.cd))) * 3600.0

    @classmethod
    def fit(cls, x, y, ra, dec, crpix=None, sip_order: int = 0) -> "TanWCS":
        """Least-squares TAN(+SIP) fit from matched (pixel, sky) pairs.

        Supports the local plate-solution path: given >= 3 matched stars
        (e.g. from registration against a solved reference frame) solve
        CRVAL + CD so pix2world reproduces the pairs.  ``sip_order >= 2``
        additionally fits forward SIP distortion coefficients A_pq/B_pq
        (terms with 2 <= p+q <= sip_order) on the linear-fit residuals —
        the local analogue of the network solve's SIP order 2 request
        (reference core/ApAstrometry.py:382-409, --use-sip).
        """
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        ra = np.asarray(ra, float)
        dec = np.asarray(dec, float)
        if crpix is None:
            crpix = (float(np.mean(x)), float(np.mean(y)))
        # initial tangent point: mean sky position; refined so the
        # fitted offset vanishes (tangent point at CRPIX exactly)
        ra0, dec0 = float(np.mean(ra)), float(np.mean(dec))
        cd = np.eye(2)
        u = x - crpix[0]
        v = y - crpix[1]
        # The SIP forward model xi = CD@[u,v] + offset + CD@[A(u,v),B(u,v)]
        # is LINEAR in (CD, offset, CD@[A,B] polynomial coefficients):
        # fit everything jointly, then recover A/B as CD^-1 @ E.
        terms = [(p, q)
                 for total in range(2, sip_order + 1)
                 for p in range(total + 1)
                 for q in [total - p]] if sip_order >= 2 else []
        if terms and len(x) < len(terms) + 3:
            terms = []  # underdetermined: fall back to pure TAN
        cols = [u, v, np.ones_like(u)] + [u ** p * v ** q for p, q in terms]
        A = np.stack(cols, axis=1)
        cx = cy = None
        for _ in range(4):
            ra0r, dec0r = ra0 * _D2R, dec0 * _D2R
            rar, decr = ra * _D2R, dec * _D2R
            cosc = (np.sin(dec0r) * np.sin(decr)
                    + np.cos(dec0r) * np.cos(decr) * np.cos(rar - ra0r))
            xi = np.cos(decr) * np.sin(rar - ra0r) / cosc / _D2R
            eta = ((np.cos(dec0r) * np.sin(decr) - np.sin(dec0r)
                    * np.cos(decr) * np.cos(rar - ra0r)) / cosc / _D2R)
            cx, *_ = np.linalg.lstsq(A, xi, rcond=None)
            cy, *_ = np.linalg.lstsq(A, eta, rcond=None)
            cd = np.array([[cx[0], cx[1]], [cy[0], cy[1]]])
            # move CRVAL to the fitted sky position of CRPIX: the fit says
            # sky(crpix) = deproject(offset), i.e. the pixel whose pure-CD
            # model value equals the offset
            duv = np.linalg.solve(cd, np.array([cx[2], cy[2]]))
            w = cls((ra0, dec0), crpix, cd)
            ra_t, dec_t = w.pix2world(crpix[0] + duv[0], crpix[1] + duv[1])
            ra0, dec0 = float(np.asarray(ra_t)), float(np.asarray(dec_t))
        sip_a: Dict[Tuple[int, int], float] = {}
        sip_b: Dict[Tuple[int, int], float] = {}
        if terms:
            e = np.stack([cx[3:], cy[3:]])           # (2, n_terms) = CD@[A;B]
            ab = np.linalg.solve(cd, e)               # (2, n_terms)
            sip_a = dict(zip(terms, (float(c) for c in ab[0])))
            sip_b = dict(zip(terms, (float(c) for c in ab[1])))
        return cls((ra0, dec0), crpix, cd, sip_a, sip_b)
