"""ap_astrometry: astrometric solution via astrometry.net source lists.

Reference surface (scripts/ap_astrometry.py:55-91): positional image,
srclist, output; --key (API key), --user_scale, --scale_err_ratio,
--xy_extension AP_XYPOS.  ``--device`` (default cuda) is where the
network-free ``--ref`` solve finds and registers stars; the
astrometry.net solve runs on the host.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..wcs.astrometry import Astrometry, nova_transport


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_astrometry",
        description="Plate-solve an image using its detected source list")
    p.add_argument("image", help="input FITS image")
    p.add_argument("srclist", help="FITS source list from ap_find_stars")
    p.add_argument("output", help="output WCS-stamped FITS image")
    p.add_argument("--key", default=os.environ.get("ASTROMETRY_API_KEY"),
                   help="astrometry.net API key (or ASTROMETRY_API_KEY env)")
    p.add_argument("--user_scale", type=float, default=None,
                   help="plate scale hint in arcsec/pixel")
    p.add_argument("--scale_err_ratio", type=float, default=1.3,
                   help="plate scale bound ratio (default 1.3)")
    p.add_argument("--xy_extension", default="AP_XYPOS",
                   help="source list extension with X/Y (default AP_XYPOS)")
    p.add_argument("--timeout", type=float, default=180.0,
                   help="solve timeout in seconds (default 180)")
    p.add_argument("--use-sip", dest="use_sip", action="store_true",
                   help="allow fitting a SIP distortion polynomial of "
                        "order 2 (reference scripts/ap_astrometry.py:"
                        "63-66; some downstream software, e.g. swarp, "
                        "may not handle SIP correctly)")
    p.add_argument("--ref", default=None, metavar="REF_IMAGE",
                   help="network-free mode: derive the WCS by "
                        "registering this image's source list against a "
                        "WCS-bearing reference image (no astrometry.net "
                        "key needed; capability beyond the reference)")
    p.add_argument("--ref_srclist", default=None, metavar="SRC",
                   help="ap_find_stars source list for --ref (default: "
                        "detect on the reference image)")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def _solve_local(ns: argparse.Namespace) -> None:
    """Registration-based solve against a solved reference frame — the
    same path ap_reduce's navigate stage uses without --key."""
    import tempfile

    from ..core.reduce import _read_srclist_stars, _stars_on, _write_nav
    from ..device import resolve_device
    from ..io.fits import open_fits
    from ..ops.register import REJECTED_TRANSLATION, estimate_similarity
    from ..utils.logger import logger
    from ..wcs.astrometry import solve_from_reference
    from ..wcs.wcs import TanWCS

    dev = resolve_device(ns.device)
    ref_wcs = TanWCS.from_header(open_fits(ns.ref)[0].header)
    ref_src = ns.ref_srclist
    tmp_src = None
    if ref_src is None:
        from ..core.star_finder import StarFinder

        fd, tmp_src = tempfile.mkstemp(suffix=".fits", prefix="refsrc_")
        os.close(fd)
        ref_src = tmp_src
        StarFinder(ns.ref, device=dev).write_source_list(ref_src)
    try:
        ref_tables = _read_srclist_stars(ref_src)
    finally:
        if tmp_src is not None:
            os.unlink(tmp_src)
    sim = estimate_similarity(
        *_stars_on(ref_tables, dev),
        *_stars_on(_read_srclist_stars(ns.srclist), dev))
    n_inl = int(sim.n_inliers)
    if n_inl < 4 or abs(float(sim.tx)) >= REJECTED_TRANSLATION / 2:
        raise RuntimeError(
            f"local solve failed: registration against {ns.ref} rejected "
            f"({n_inl} inliers)")
    wcs = solve_from_reference(ref_wcs, sim,
                               sip_order=2 if ns.use_sip else 0)
    _write_nav(ns.image, ns.output, ns.srclist, wcs,
               origin=f"registered to {ns.ref} ({n_inl} inliers, rms "
                      f"{float(sim.rms):.2f} px)")
    logger.info(f"Local WCS solve OK: {n_inl} inliers, "
                f"rms {float(sim.rms):.2f} px")


def run(ns: argparse.Namespace) -> None:
    if ns.ref:
        _solve_local(ns)
        return
    if not ns.key:
        raise RuntimeError(
            "astrometry.net API key required (--key or ASTROMETRY_API_KEY, "
            "or use --ref for a network-free registration solve)")
    ast = Astrometry(transport=nova_transport(ns.key, use_sip=ns.use_sip),
                     user_scale=ns.user_scale,
                     scale_err_ratio=ns.scale_err_ratio)
    wcs = ast.solve(ns.image, ns.srclist, ns.output,
                    xy_extension=ns.xy_extension, timeout=ns.timeout)
    if wcs is None:
        raise RuntimeError("plate solve failed")


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
