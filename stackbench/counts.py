"""Count-once bytes and operations of each layer's work, and the card's
published peaks: the yardstick of every roofline metric.

Copied from ``chip_smoke.py`` (``PEAK_BYTES_S``, ``PEAK_F32_S``,
``_bound``, K1's count in ``check_detect``, ``_k2_bound``) and written
from shapes alone: each input byte is read once and each output byte
written once, whatever a kernel reads again, and the operations are
those the algorithm needs.  The peaks are NVIDIA's data sheet for the
H100 SXM (HBM3 at 3.35 TB/s, float32 outside the tensor cores at 67
TFLOP/s) at its full 700 W; a run states its card's power limit beside
every share.  This module imports nothing of the program.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the bytes at the memory rate
    against the operations at the float32 rate, the larger."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_S)


def detect_radius(fwhm: float) -> int:
    """The matched filter's radius at ``fwhm`` px (the detector's rule:
    1.5 sigma each side of a binned row's FWHM, at least 2)."""
    sigma = fwhm / 2.35482
    return max(2, int(round(1.5 * sigma * 2.35482 / 2)))


def detect(n: int, h: int, w: int, fwhm: float) -> tuple:
    """(bytes, operations) of detection on a raw uint16 (N, H, W) stack
    (K1's work): the raw stack, the flat's reciprocal A and the two
    binned master densities read, the thresholds and exposure ratios,
    four tables of one value a 64 x 256 tile written; per raw pixel the
    2-row binning, the Gaussian and box passes (3 operations a tap), the
    density and the 3 x 3 peak test (9.5 in all)."""
    ntap = 2 * detect_radius(fwhm) + 1
    tiles = n * (h // 64) * (w // 256)
    n_bytes = (n * h * w * 2 + h * w * 4 + 2 * (h // 2) * w * 4
               + 2 * n * 4 + 4 * tiles * 4)
    return n_bytes, n * h * w * (3 * ntap + 9.5)


def warp_combine(n: int, h: int, w: int) -> tuple:
    """(bytes, operations) of the fused calibrate + warp + clip combine
    (K2's work): the raw uint16 stack and the three calibration planes
    read, the float32 image written; per (frame, pixel) 5 operations of
    calibration, 6 horizontal and 6 vertical taps at 2 each, 1 to add
    the sample, and the log2(N) compares of a comparison sort."""
    return (n * h * w * 2 + 3 * h * w * 4 + h * w * 4,
            n * h * w * (30 + math.log2(max(n, 2))))


def warp(n: int, rows: int, w: int) -> tuple:
    """(bytes, operations) of the plain separable warp of one band of
    ``rows`` output rows: the float32 calibrated rows read, the warped
    band and its coverage written; 6 horizontal and 6 vertical taps at
    2 operations each per (frame, pixel)."""
    return 3 * n * rows * w * 4, n * rows * w * 24


def combine(n: int, rows: int, w: int) -> tuple:
    """(bytes, operations) of the plain clip combine of one band: the
    warped band and its coverage read, the image band written; per
    sample two sorts' log2(N) compares and 8 operations of deviation,
    clip and sum."""
    return (2 * n * rows * w * 4 + rows * w * 4,
            n * rows * w * (2 * math.log2(max(n, 2)) + 8))

