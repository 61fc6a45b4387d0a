"""Bad-pixel detection and repair (the JAX package's ``ops/badpix.py``).

* :func:`fix_bad_pixels`: every bad pixel becomes the median of the good
  pixels within +-``deltapix``.  The median is taken from the ORIGINAL
  data (not partially repaired data), only good pixels inside the image
  count, and a pixel is repaired only if at least ``min_valid`` good
  neighbours exist.  The (2d+1)^2 neighbourhood of every pixel is a stack
  of shifted planes, and the masked median runs for all pixels at once.
* :func:`sigmaclip_badpix_mask`: pixels outside median +- sigma * std of
  the sigma-clipped statistics of a master dark or bias.
* :func:`auto_badcols`: columns (or rows) whose median deviates from the
  clipped mean of a sliding window along the median vector.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import numpy_inputs, resolve_device, to_float32
from .stats import (masked_mean_std, masked_median, sigma_clip_mask,
                    sigma_clipped_stats)

#: Bad-pixel mask values
MASK_GOOD = 0
MASK_AUTO_BAD = 1
MASK_USER_BAD = 2


def _neighbor_stack(img: torch.Tensor, deltapix: int) -> torch.Tensor:
    """(K, H, W) stack of every pixel's (2d+1)^2 box neighbourhood,
    zero beyond the image; the mask stack built the same way marks those
    positions invalid."""
    p = deltapix
    h, w = img.shape
    padded = F.pad(img, (p, p, p, p))
    return torch.stack([padded[dy:dy + h, dx:dx + w]
                        for dy in range(2 * p + 1)
                        for dx in range(2 * p + 1)], dim=0)


@numpy_inputs("img", "badmask")
def fix_bad_pixels(
    img: torch.Tensor,
    badmask: torch.Tensor,
    deltapix: int = 1,
    min_valid: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace bad pixels by the median of good pixels within +-deltapix.

    Returns ``(fixed_image, still_bad_mask)``; ``still_bad_mask`` is True
    for bad pixels that had fewer than ``min_valid`` good neighbours and
    were left untouched."""
    img = to_float32(img)
    bad = badmask.to(torch.bool)
    vals = _neighbor_stack(img, deltapix)
    # valid = inside the image AND good: the zero padding is invalid
    valid = _neighbor_stack((~bad).to(torch.float32), deltapix) > 0.5
    n_good = valid.sum(dim=0)
    med = masked_median(vals, valid, axis=0)
    can_fix = bad & (n_good >= min_valid)
    fixed = torch.where(can_fix, med, img)
    return fixed, bad & ~can_fix


@numpy_inputs("data")
def sigmaclip_badpix_mask(data: torch.Tensor, sigma: float = 4.0
                          ) -> torch.Tensor:
    """Bad-pixel mask from the sigma-clipped stats of a master dark or
    bias: pixels strictly outside median +- sigma * std.  Returns uint8
    (1 = AUTO_BAD)."""
    _mean, med, std = sigma_clipped_stats(data, sigma=sigma)
    lo = med - sigma * std
    hi = med + sigma * std
    return ((data < lo) | (data > hi)).to(torch.uint8)


def _sliding_windows_1d(vec: torch.Tensor, window: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, window) matrix of centred sliding windows and the mask of the
    slots inside the vector (windows shorten at the ends; the slots
    beyond hold the clamped end value and are invalid)."""
    n = vec.shape[0]
    half = window // 2
    idx = torch.arange(n, device=vec.device)[:, None] \
        + (torch.arange(window, device=vec.device) - half)[None, :]
    in_range = (idx >= 0) & (idx < n)
    return vec[idx.clamp(0, n - 1)], in_range


@numpy_inputs("img")
def auto_badcols(
    img: torch.Tensor,
    window: int = 11,
    sigma: float = 5.0,
    axis: int = 0,
) -> torch.Tensor:
    """Detect bad columns (axis=0) or rows (axis=1) of a master frame:
    per-column medians, then a centred sliding window along the median
    vector whose local mean and std come from a 3-sigma clip; a column is
    bad when it deviates from its window's mean by >= ``sigma`` times the
    window's std.  Returns a boolean vector over columns (axis=0) or rows
    (axis=1)."""
    med = masked_median(img, torch.ones_like(img, dtype=torch.bool),
                        axis=axis)
    wins, valid = _sliding_windows_1d(med, window)
    keep = sigma_clip_mask(wins, valid, sigma_lower=3.0, sigma_upper=3.0,
                           maxiters=5, axis=1)
    mean, std = masked_mean_std(wins, keep, axis=1)
    return (med - mean).abs() >= sigma * std


def combine_user_badpix(
    shape: Tuple[int, int],
    bad_columns=(),
    bad_rows=(),
    bad_rectangles=(),
    device=None,
) -> torch.Tensor:
    """Rasterize user-specified bad regions to a USER_BAD uint8 mask on
    ``device`` (CUDA when not given).  Coordinates are 1-based with
    inclusive ranges; rectangles are (xmin, xmax, ymin, ymax)."""
    dev = resolve_device(device)
    mask = np.zeros(shape, dtype=np.uint8)
    for col in bad_columns:
        mask[:, int(col) - 1] = MASK_USER_BAD
    for row in bad_rows:
        mask[int(row) - 1, :] = MASK_USER_BAD
    for rect in bad_rectangles:
        xmin, xmax, ymin, ymax = (int(v) for v in rect)
        mask[ymin - 1:ymax, xmin - 1:xmax] = MASK_USER_BAD
    return torch.from_numpy(mask).to(dev)
