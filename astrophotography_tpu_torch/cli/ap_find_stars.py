"""ap_find_stars: detection -> photometry -> PSF -> refined detection.

Reference surface and two-pass workflow (scripts/ap_find_stars.py:76-193):
positional image + source list output; --search_fwhm 3.0 --search_nsigma
7.0 --bitdepth 16 --sat_frac 0.80 --retain_saturated --max_sources;
optional quality report / ds9 region / plot outputs.  The second
detection pass re-runs at the fitted FWHM.  ``--device`` (default cuda)
is where the image is searched and measured.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_device, add_loglevel, cli_main
from ..core.star_finder import StarFinder


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_find_stars",
        description="Detect stars, perform aperture photometry and PSF "
                    "fitting, write a source list")
    p.add_argument("image", help="input FITS image")
    p.add_argument("srclist", help="output FITS source list")
    p.add_argument("--search_fwhm", type=float, default=3.0,
                   help="initial detection FWHM in pixels (default 3.0)")
    p.add_argument("--search_nsigma", type=float, default=7.0,
                   help="detection threshold in background sigma (default 7)")
    p.add_argument("--bitdepth", type=int, default=16,
                   help="detector bit depth (default 16)")
    p.add_argument("--sat_frac", type=float, default=0.80,
                   help="fraction of full range treated as saturated")
    p.add_argument("--retain_saturated", action="store_true",
                   help="do NOT mask saturated stars before detection")
    p.add_argument("--max_sources", type=int, default=None,
                   help="maximum number of sources in outputs")
    p.add_argument("--nofwhm", action="store_true",
                   help="skip PSF FWHM measurement and the refined pass")
    p.add_argument("--quality_report", default=None,
                   help="write a quality report YAML here")
    p.add_argument("--ds9", default=None,
                   help="write a ds9 region file here")
    p.add_argument("--plot", default=None,
                   help="write an annotated detection plot (PNG) here")
    p.add_argument("--fit_plots", default=None,
                   help="write a grid of PSF-fit cutouts (PNG) here")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    finder = StarFinder(
        ns.image, search_fwhm=ns.search_fwhm, search_nsigma=ns.search_nsigma,
        bitdepth=ns.bitdepth, sat_frac=ns.sat_frac,
        max_sources=ns.max_sources, nosatmask=ns.retain_saturated,
        device=ns.device)
    if not ns.nofwhm:
        fwhm_both = finder.measure_fwhm("both")
        fitted = fwhm_both[0]
        if fitted == fitted and fitted > 0:  # not NaN
            # second pass at the fitted FWHM
            # (reference scripts/ap_find_stars.py:158-186)
            finder.source_search(fitted, ns.search_nsigma)
            finder.aperture_photometry()
    finder.write_source_list(ns.srclist)
    if ns.quality_report:
        finder.write_quality_report(ns.quality_report)
    if ns.ds9:
        finder.write_ds9_region_file(ns.ds9)
    if ns.plot:
        finder.plot_image(ns.plot)
    if ns.fit_plots and not ns.nofwhm:
        finder.plot_fits(ns.fit_plots)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
