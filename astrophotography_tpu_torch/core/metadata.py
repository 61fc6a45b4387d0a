"""FITS header enrichment: sites, targets, airmass.

Equivalent of ApAddMetadata (reference core/ApAddMetadata.py:155-537):
iTelescope filename parsing (telescope/observer/target with the
Telescopius mosaic-suffix strip), the hardcoded iTelescope site table
(4 observatories, ~20 telescopes, :155-256), target name resolution,
airmass from site + time + target, ``yamlkeyval`` mode for arbitrary
keywords, and in-place header updates writing OBSERVER/OBSERVAT/
LAT-OBS/LON-OBS/ALT-OBS/TELESCOP/OBJECT/RA-OBJ/DEC-OBJ/AIRMASS.

Astronomy math (astroplan/astropy replacements): Greenwich mean
sidereal time from the standard IAU polynomial, hour angle, alt/az and
airmass = sec(z).  Target resolution uses a built-in catalog of common
deep-sky objects plus user-supplied coordinates; the reference's Simbad
lookup (network) is available as an optional hook.

The JAX package's ``core/metadata.py``, host code only; ``yaml`` is
imported by the one mode that reads a YAML file.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

from ..io.fits import open_fits
from ..utils.logger import get_logger

logger = get_logger("core.metadata")


@dataclasses.dataclass(frozen=True)
class Site:
    name: str
    latitude: float      # deg
    longitude: float     # deg, east positive
    elevation: float     # m


def _dms(d: float, m: float, s: float) -> float:
    sign = -1.0 if d < 0 or (d == 0 and (m < 0 or s < 0)) else 1.0
    return sign * (abs(d) + abs(m) / 60.0 + abs(s) / 3600.0)


#: iTelescope observatories (reference core/ApAddMetadata.py:166-184)
SITES: Dict[str, Site] = {
    "mayhill": Site("iTelescope New Mexico",
                    _dms(32, 54, 11.91), _dms(-105, 31, 43.32), 2222.0),
    "nerpio": Site("iTelescope Astrocamp",
                   _dms(38, 9, 56), _dms(-2, 19, 37), 1607.0),
    "sidingspring": Site("iTelescope Siding Spring",
                         _dms(-31, 16, 24), _dms(149, 4, 11), 1118.0),
    "auberry": Site("iTelescope Sierra Remote",
                    _dms(37, 4, 13), _dms(-119, 24, 47), 1403.0),
}

#: telescope id -> site key (reference :187-206)
TELESCOPE_SITES: Dict[str, str] = {
    **{t: "mayhill" for t in ("t02", "t05", "t11", "t14", "t20", "t21",
                              "t68")},
    "t24": "auberry",
    **{t: "sidingspring" for t in ("t08", "t09", "t12", "t17", "t30",
                                   "t31", "t32", "t33")},
    **{t: "nerpio" for t in ("t07", "t16", "t18")},
}

#: built-in target catalog (J2000 degrees) — offline replacement for the
#: reference's Simbad FixedTarget.from_name; extend via user YAML or
#: explicit coordinates
TARGETS: Dict[str, Tuple[float, float]] = {
    "M31": (10.6847, 41.2690), "M33": (23.4621, 30.6599),
    "M42": (83.8221, -5.3911), "M45": (56.8711, 24.1053),
    "M51": (202.4696, 47.1952), "M57": (283.3963, 33.0292),
    "M63": (198.9554, 42.0293), "M81": (148.8882, 69.0653),
    "M82": (148.9685, 69.6797), "M101": (210.8024, 54.3488),
    "M104": (189.9976, -11.6231),
    "NGC 253": (11.8880, -25.2882), "NGC 891": (35.6392, 42.3491),
    "NGC 2244": (97.9771, 4.9408), "NGC 6888": (303.0604, 38.3553),
    "NGC 7000": (314.6950, 44.5167), "NGC 7293": (337.4108, -20.8372),
    "IC 1396": (324.7458, 57.5008), "IC 434": (85.2458, -2.4583),
    "CYGNUS LOOP": (312.75, 30.67), "VEIL NEBULA": (313.9708, 30.7083),
}

_MOSAIC_RE = re.compile(r" x\d+ y\d+")


def parse_itelescope_filename(filename: str) -> Tuple[str, str, str]:
    """(telescope, observer, target) from an iTelescope filename
    (reference _parse_itelescope_filename, :259-300): dash-separated,
    one field before the telescope, underscores to spaces, Telescopius
    ' xN yM' mosaic suffix stripped."""
    fields = filename.split("-")
    if len(fields) <= 3:
        raise RuntimeError(
            f"Splitting {filename!r} produced only {len(fields)} fields; "
            "expected > 3 for an iTelescope name")
    telescope = fields[1]
    observer = fields[2]
    target = fields[3].replace("_", " ")
    m = _MOSAIC_RE.search(target)
    if m:
        target = target[: m.start()]
    return telescope, observer, target


def get_site(telescope: str) -> Site:
    """Site for an iTelescope telescope id (reference :155-256)."""
    tid = telescope.lower().replace("itelescope ", "")
    if tid not in TELESCOPE_SITES:
        raise RuntimeError(
            f"telescope {tid!r} not in the iTelescope site table")
    return SITES[TELESCOPE_SITES[tid]]


def resolve_target(
    name: str,
    resolver: Optional[callable] = None,
) -> Tuple[float, float]:
    """(ra_deg, dec_deg) for a target name.

    Tries the built-in catalog (case/spacing-insensitive), then the
    optional ``resolver`` callable (e.g. ``simbad_resolver()``).
    """
    key = " ".join(name.upper().split())
    compact = key.replace(" ", "")
    for cand, coords in TARGETS.items():
        if cand == key or cand.replace(" ", "") == compact:
            return coords
    if resolver is not None:
        coords = resolver(name)
        if coords is not None:
            return coords
    raise RuntimeError(
        f"cannot resolve target {name!r}: not in the built-in catalog and "
        "no resolver provided (pass simbad_resolver() / --simbad for a "
        "network SIMBAD lookup)")


#: SIMBAD TAP sync endpoint (CDS Strasbourg)
SIMBAD_TAP_URL = "https://simbad.cds.unistra.fr/simbad/sim-tap/sync"


def simbad_resolver(transport: Optional[callable] = None) -> callable:
    """Name -> (ra_deg, dec_deg) resolver backed by the SIMBAD TAP
    service — the same resolution the reference performs via astroplan's
    ``FixedTarget.from_name`` (core/ApAddMetadata.py:466,483).

    ``transport`` is an injectable ``callable(url: str) -> bytes`` so
    tests and offline batch runs never touch the network (same pattern
    as wcs/astrometry.py's solve transport); the default transport uses
    urllib, imported lazily.
    """

    def resolve(name: str) -> Optional[Tuple[float, float]]:
        import json
        import urllib.parse

        adql = ("SELECT basic.ra, basic.dec FROM basic "
                "JOIN ident ON ident.oidref = basic.oid "
                "WHERE ident.id = '%s'" % name.replace("'", "''"))
        url = SIMBAD_TAP_URL + "?" + urllib.parse.urlencode({
            "REQUEST": "doQuery", "LANG": "ADQL",
            "FORMAT": "json", "QUERY": adql})
        try:
            if transport is not None:
                raw = transport(url)
            else:
                import urllib.request
                with urllib.request.urlopen(url, timeout=30) as resp:
                    raw = resp.read()
            doc = json.loads(raw)
        except Exception as exc:
            logger.warning(f"SIMBAD lookup for {name!r} failed: "
                           f"{type(exc).__name__}: {exc}")
            return None
        rows = doc.get("data") or []
        if not rows or rows[0][0] is None:
            logger.warning(f"SIMBAD returned no position for {name!r}")
            return None
        return float(rows[0][0]), float(rows[0][1])

    return resolve


# -- time / airmass --------------------------------------------------------

def _julian_date(date_obs: str) -> float:
    """JD(UT) from a FITS DATE-OBS string 'YYYY-MM-DD[THH:MM:SS[.s]]'."""
    date_obs = date_obs.strip()
    if "T" in date_obs:
        datepart, timepart = date_obs.split("T")
    else:
        datepart, timepart = date_obs, "00:00:00"
    y, mo, d = (int(v) for v in datepart.split("-"))
    parts = timepart.split(":")
    hh = int(parts[0])
    mm = int(parts[1]) if len(parts) > 1 else 0
    ss = float(parts[2]) if len(parts) > 2 else 0.0
    if mo <= 2:
        y -= 1
        mo += 12
    a = y // 100
    b = 2 - a + a // 4
    jd0 = (math.floor(365.25 * (y + 4716))
           + math.floor(30.6001 * (mo + 1)) + d + b - 1524.5)
    return jd0 + (hh + mm / 60.0 + ss / 3600.0) / 24.0


def _gmst_deg(jd: float) -> float:
    """Greenwich mean sidereal time in degrees (IAU 1982 polynomial)."""
    t = (jd - 2451545.0) / 36525.0
    gmst = (280.46061837 + 360.98564736629 * (jd - 2451545.0)
            + 0.000387933 * t * t - t ** 3 / 38710000.0)
    return gmst % 360.0


def compute_altaz(
    ra_deg: float, dec_deg: float,
    site: Site, date_obs: str,
) -> Tuple[float, float]:
    """(altitude, azimuth) in degrees at the site and UT time."""
    jd = _julian_date(date_obs)
    lst = (_gmst_deg(jd) + site.longitude) % 360.0
    ha = math.radians((lst - ra_deg) % 360.0)
    dec = math.radians(dec_deg)
    lat = math.radians(site.latitude)
    sin_alt = (math.sin(dec) * math.sin(lat)
               + math.cos(dec) * math.cos(lat) * math.cos(ha))
    alt = math.asin(max(-1.0, min(1.0, sin_alt)))
    cos_az = ((math.sin(dec) - math.sin(alt) * math.sin(lat))
              / (math.cos(alt) * math.cos(lat)))
    az = math.acos(max(-1.0, min(1.0, cos_az)))
    if math.sin(ha) > 0:
        az = 2 * math.pi - az
    return math.degrees(alt), math.degrees(az)


def compute_airmass(ra_deg: float, dec_deg: float,
                    site: Site, date_obs: str) -> float:
    """sec(z) airmass (the reference uses astroplan's .secz, :524-530)."""
    alt, _az = compute_altaz(ra_deg, dec_deg, site, date_obs)
    z = math.radians(90.0 - alt)
    if alt <= 0:
        logger.warning(f"Target below horizon (alt={alt:.1f} deg); "
                       "airmass is unphysical")
        return float("inf")
    return 1.0 / math.cos(z)


# -- the engine ------------------------------------------------------------

def add_metadata(
    fitsfile: str,
    mode: str = "iTelescope",
    target: Optional[str] = None,
    yamlfile: Optional[str] = None,
    resolver: Optional[callable] = None,
) -> Dict[str, Tuple]:
    """Enrich a FITS header in place; returns the keywords written
    (reference process(), core/ApAddMetadata.py:420-537)."""
    import os

    kwdict: Dict[str, Tuple] = {}
    telescope_str = observer_str = target_str = None
    site = coords = None

    if mode == "iTelescope":
        telescope_str, observer_str, target_str = \
            parse_itelescope_filename(os.path.basename(fitsfile))
        if target is not None:
            target_str = target
        site = get_site(telescope_str)
        coords = resolve_target(target_str, resolver)
        if "itelescope" not in telescope_str.lower():
            telescope_str = "iTelescope " + telescope_str.upper()
    elif mode == "yamlkeyval":
        if yamlfile is None:
            raise RuntimeError("yamlkeyval mode requires a YAML file")
        import yaml

        with open(yamlfile) as fh:
            pairs = yaml.safe_load(fh) or {}
        for key, val in pairs.items():
            if isinstance(val, (list, tuple, dict)):
                logger.warning(f"Skipping sequence value for key {key}")
                continue
            key_up = str(key).upper()
            kwdict[key_up] = (val, f"From {os.path.basename(yamlfile)}")
            if "TARGET" in key_up:
                target_str = str(val)
                coords = resolve_target(target_str, resolver)
            if "TELESCOP" in key_up:
                site = get_site(str(val))
    else:
        raise RuntimeError(f"unexpected/unsupported mode {mode!r}")

    if observer_str:
        kwdict["OBSERVER"] = (observer_str, "Name of observer")
    if site is not None:
        kwdict["OBSERVAT"] = (site.name, "Observatory.")
        kwdict["LAT-OBS"] = (site.latitude, "[deg] Latitude of observatory.")
        kwdict["LON-OBS"] = (site.longitude, "[deg] Longitude of observatory.")
        kwdict["ALT-OBS"] = (site.elevation, "[m] Height of observatory.")
    if telescope_str:
        kwdict["TELESCOP"] = (telescope_str, "Name of telescope used.")
    if target_str and coords is not None:
        kwdict["OBJECT"] = (target_str, "Target of observation")
        kwdict["OBJNAME"] = kwdict["OBJECT"]
        kwdict["RA-OBJ"] = (coords[0], "[deg] Right Ascension of target")
        kwdict["DEC-OBJ"] = (coords[1], "[deg] Declination of target")

    hdus = open_fits(fitsfile)
    hdr = hdus[0].header
    if coords is not None and site is not None:
        if "DATE-OBS" in hdr:
            airmass = compute_airmass(coords[0], coords[1], site,
                                      str(hdr["DATE-OBS"]))
            if math.isfinite(airmass):
                kwdict["AIRMASS"] = (airmass,
                                     "Airmass at start of observation")
        else:
            logger.warning(
                "Cannot compute AIRMASS without DATE-OBS in the header")
    for k, vc in kwdict.items():
        hdr[k] = vc
    hdus.writeto(fitsfile)
    logger.info(f"Updated {len(kwdict)} keywords in {fitsfile}")
    return kwdict
