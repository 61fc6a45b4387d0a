"""Count-once bytes and operations of calibration (``calibrate_batch``
with a bias, a dark and a flat, as the unfused entry runs it): the
yardstick of ``calibrate_roofline``.

Written from shapes alone, like ``counts.py``: the raw stack read once
(``in_bytes`` a pixel: 2 for uint16), the three (H, W) float32 masters
read once, the N float32 exposure ratios read, and the float32 stack
written once.  Per pixel: 5 operations (the bias subtracted, the ratio
times the dark, that subtracted, the flat compared with 0, the
division).  The dark less the bias is H * W operations, once, and is
left out.  This module imports nothing of the program.
"""

from __future__ import annotations

#: operations a pixel of a frame
OPS_PER_PIXEL = 5
#: float32 (H, W) masters: bias, dark, flat
MASTERS = 3


def calibrate(n: int, h: int, w: int, in_bytes: int) -> tuple:
    """(bytes, operations) of calibrating an (N, H, W) stack of
    ``in_bytes`` a pixel into float32 against the three masters."""
    n_bytes = (n * h * w * in_bytes + MASTERS * h * w * 4 + n * 4
               + n * h * w * 4)
    return n_bytes, n * h * w * OPS_PER_PIXEL
