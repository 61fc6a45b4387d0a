"""Count-once bytes and operations of exact detection (``find_stars``
in 'exact' mode with a global top-k, as the unfused entry runs it): the
yardstick of ``find_roofline``.

Written from shapes alone, like ``counts.py``: the float32 stack read
once, the per-frame thresholds and floors read, and the seven (N,
max_stars) ``Stars`` fields written once (six float32, one bool).  Per
pixel: 2 operations a nonzero tap of DAOFIND's circular footprint (a
multiply and an add; 21 taps at FWHM 3) and 9 for the 3 x 3 peak test
(eight comparisons and the threshold).  The centroids of the max_stars
stars are a few thousand operations a frame and are left out.  This
module imports nothing of the program.
"""

from __future__ import annotations

from stackbench import counts

#: the bytes of one star's row of the Stars tables: x, y, flux, peak,
#: sharpness, roundness (float32) and valid (bool)
STAR_BYTES = 6 * 4 + 1
#: operations of the 3 x 3 peak test a pixel
PEAK_TEST_OPS = 9


def footprint_taps(fwhm: float) -> int:
    """The nonzero taps of the matched filter at ``fwhm``: the offsets
    (dy, dx) with dy^2 + dx^2 <= r^2 + r at the detector's radius r."""
    r = counts.detect_radius(fwhm)
    return sum(1 for dy in range(-r, r + 1) for dx in range(-r, r + 1)
               if dy * dy + dx * dx <= r * r + r)


def find_exact(n: int, h: int, w: int, fwhm: float, max_stars: int) -> tuple:
    """(bytes, operations) of exact detection on a float32 (N, H, W)
    calibrated stack keeping ``max_stars`` stars a frame."""
    n_bytes = n * h * w * 4 + 2 * n * 4 + n * max_stars * STAR_BYTES
    n_ops = n * h * w * (2 * footprint_taps(fwhm) + PEAK_TEST_OPS)
    return n_bytes, n_ops
