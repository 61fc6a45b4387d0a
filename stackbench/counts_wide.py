"""Count-once bytes and operations of K2's 'wide' route with the 'exact'
tap body: the yardstick of ``wide_roofline``.

``chip_smoke._k2_wide_bound``'s rule, written from shapes and the mix
alone: it counts the (frame, pixel) pairs a frame covers, and a frame
of the mix is turned by a size uniform on ``rotation_deg`` (either
sign) about the centre and moved by up to ``dither_px`` each way, so
the covered pixels and tile columns are their mean over that draw
(:func:`mean_cover`).  A pixel is covered where its source point lies
in [2, W - 4] x [2, H - 4], K2's coverage rule; every tile is taken to
pass K2's gate.  Each input byte is read once (the raw uint16 stack and
the three float32 calibration planes) and each output byte written once
(the float32 image).  Per covered (frame, pixel): 5 operations of
calibration, the vertical pass, a reciprocal and the log2(N) compares of
a comparison sort.  Per mid value a covered pixel reads, the horizontal
pass: a tile column of k covered rows reads |m11| (k - 1) + 6 source
rows (6 non-zero taps about a line of slope m11 = cos theta).  A pass is
6 taps at 2 operations, and on a turned frame each tap's weight (the
degree-10 polynomial in t^2: 22 operations) and its sum (1), and a
reciprocal.  Frame 0, the reference, snaps to a translation: its taps
take 2 operations each.  The peaks are ``counts.py``'s.  This module
imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np

#: midpoints of the quadrature over the turn's size, and over each
#: axis of the dither: the mean cover moves by < 1e-5 of itself past them
ANGLES, SHIFTS = 24, 4


def cover(h: int, w: int, tile_rows: int, theta: float, dx: float,
          dy: float) -> tuple:
    """(covered pixels, covered tile columns) of one frame whose source
    point of output pixel (x, y) is its turn by ``theta`` about the
    centre, moved by (dx, dy).  A tile column is one output column of
    one tile of ``tile_rows`` rows; the covered set is convex, so a
    tile's covered columns are the span of its rows' intervals."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    c, s = math.cos(theta), math.sin(theta)
    y = np.arange(h, dtype=np.float64) - cy
    lo = np.zeros(h)
    hi = np.full(h, w - 1.0)
    # source x = c (x - cx) - s y + cx + dx, y = s (x - cx) + c y + cy + dy
    for slope, base, top in ((c, -s * y + cx + dx, w - 4.0),
                             (s, c * y + cy + dy, h - 4.0)):
        if abs(slope) < 1e-15:
            inside = (base >= 2.0) & (base <= top)
            hi = np.where(inside, hi, -1.0)
            continue
        a, b = (2.0 - base) / slope + cx, (top - base) / slope + cx
        lo = np.maximum(lo, np.minimum(a, b))
        hi = np.minimum(hi, np.maximum(a, b))
    first, last = np.ceil(lo - 1e-9), np.floor(hi + 1e-9)
    rows = np.maximum(last - first + 1, 0)
    columns = 0
    for r0 in range(0, h, tile_rows):
        band = rows[r0:r0 + tile_rows] > 0
        if band.any():
            columns += int(last[r0:r0 + tile_rows][band].max()
                           - first[r0:r0 + tile_rows][band].min() + 1)
    return float(rows.sum()), float(columns)


def mean_cover(h: int, w: int, tile_rows: int, rotation_deg,
               dither_px: float) -> tuple:
    """The mean (pixels, tile columns, |cos theta| * (pixels - columns))
    :func:`cover` gives a frame of the mix: a turn whose size is uniform
    on ``rotation_deg`` [lo, hi] degrees (either sign; none without it)
    and a shift uniform on [-dither_px, dither_px] on each axis, by the
    midpoint rule."""
    lo, hi = (math.radians(d) for d in (rotation_deg or (0.0, 0.0)))
    sizes = lo + (hi - lo) * (np.arange(ANGLES) + 0.5) / ANGLES
    shifts = dither_px * (2 * (np.arange(SHIFTS) + 0.5) / SHIFTS - 1)
    total = np.zeros(3)
    cases = 0
    for size in sizes:
        for theta in (size, -size):
            for dx in shifts:
                for dy in shifts:
                    px, cols = cover(h, w, tile_rows, theta, dx, dy)
                    total += (px, cols, abs(math.cos(theta)) * (px - cols))
                    cases += 1
    return tuple(total / cases)


def wide_exact(n: int, h: int, w: int, tile_rows: int, rotation_deg,
               dither_px: float = 0.0) -> tuple:
    """(bytes, operations) of K2's 'wide' route, 'exact' body, on a raw
    uint16 (N, H, W) stack with masters, in tiles of ``tile_rows``
    output rows, frame 0 the reference and every other frame drawn from
    the mix (:func:`mean_cover`)."""
    sort = math.log2(max(n, 2))

    def frame(tap: float, pixels: float, columns: float,
              slanted: float) -> float:
        mids = slanted + 6 * columns
        return pixels * (5 + 6 * tap + 1 + sort) + mids * (6 * tap + 1)

    px0, cols0 = cover(h, w, tile_rows, 0.0, 0.0, 0.0)
    ops = (frame(2, px0, cols0, px0 - cols0)
           + (n - 1) * frame(25, *mean_cover(h, w, tile_rows, rotation_deg,
                                              dither_px)))
    pixels = h * w
    return n * pixels * 2 + 3 * pixels * 4 + pixels * 4, ops
