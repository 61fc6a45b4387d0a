"""Large-scale 2-D sky background modelling (the JAX package's
``ops/background.py``).

The equivalent of photutils' Background2D: a coarse box grid, per-box
sigma-clipped median with source-masked pixels excluded, an
exclude-percentile guard, a median filter over the box grid, then
upsampling to full resolution; and the segmentation-style source mask
built from sigma-clipped thresholding and binary dilation.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import numpy_inputs, to_float32
from .cosmic import _median_filter
from .stats import masked_median, sigma_clip_mask, sigma_clipped_stats


def _bspline3(s: np.ndarray) -> np.ndarray:
    """Cubic B-spline kernel values (support |s| < 2)."""
    s = np.abs(np.asarray(s, np.float64))
    return np.where(s < 1.0, 2.0 / 3.0 - s * s + 0.5 * s ** 3,
                    np.where(s < 2.0, (2.0 - s) ** 3 / 6.0, 0.0))


def _reflect_idx(p: np.ndarray, n: int) -> np.ndarray:
    """scipy 'reflect'/'grid-mirror' index extension:
    (d c b a | a b c d | d c b a)."""
    if n == 1:
        return np.zeros_like(p)
    period = 2 * n
    p = np.mod(p, period)
    return np.where(p >= n, period - 1 - p, p)


@functools.lru_cache(maxsize=64)
def _spline_zoom_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 matrix realizing scipy.ndimage.zoom's 1-D
    order-3 spline zoom with mode='reflect', grid_mode=True.  The
    separable 2-D zoom is then two small matrix products
    (My @ grid @ Mx.T), photutils' BkgZoomInterpolator.

    Construction: the cubic-spline prefilter is the inverse of the
    B-spline collocation matrix (rows: 1/6, 4/6, 1/6 with reflect
    boundary folding) and the evaluation matrix carries the B-spline
    weights at the zoomed grid-centre coordinates
    x = (i + 0.5) * n_in / n_out - 0.5."""
    coll = np.zeros((n_in, n_in))
    for i in range(n_in):
        for off, wgt in ((-1, 1.0 / 6.0), (0, 4.0 / 6.0), (1, 1.0 / 6.0)):
            j = int(_reflect_idx(np.asarray(i + off), n_in))
            coll[i, j] += wgt
    prefilter = np.linalg.inv(coll)
    x = (np.arange(n_out, dtype=np.float64) + 0.5) * n_in / n_out - 0.5
    base = np.floor(x).astype(int)
    ev = np.zeros((n_out, n_in))
    for k in range(-1, 3):
        idx = base + k
        w = _bspline3(x - idx)
        j = _reflect_idx(idx, n_in)
        for i in range(n_out):
            ev[i, int(j[i])] += w[i]
    return ev @ prefilter


def _window_any(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Binary dilation of an (H, W) bool mask by a size x size square
    (False beyond the image), as two 1-D passes."""
    half = size // 2
    x = mask.to(torch.float32)[None, None]
    x = F.max_pool2d(x, (size, 1), stride=1, padding=(half, 0))
    x = F.max_pool2d(x, (1, size), stride=1, padding=(0, half))
    return x[0, 0] > 0.5


@numpy_inputs("data")
def source_mask(
    data: torch.Tensor,
    nsigma: float = 3.0,
    npixels: int = 5,
    dilate: int = 11,
) -> torch.Tensor:
    """Boolean mask of source-contaminated pixels: threshold at median +
    nsigma * std (sigma-clipped), require >= npixels pixels above the
    threshold in the 3x3 neighbourhood (a stand-in for the minimum
    source size), then dilate by a ``dilate`` x ``dilate`` square."""
    _, med, std = sigma_clipped_stats(data, sigma=3.0)
    above = data > (med + nsigma * std)
    h, w = data.shape
    pad = F.pad(above.to(torch.float32), (1, 1, 1, 1))
    count = torch.zeros_like(pad[1:-1, 1:-1])
    for dy in range(3):
        for dx in range(3):
            count = count + pad[dy:dy + h, dx:dx + w]
    seed = above & (count >= min(npixels, 9))
    return _window_any(seed, dilate)


def _boxes(x: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """(H, W) -> (ny, nx, by * bx): the pixels of each box."""
    h, w = x.shape
    by, bx = h // ny, w // nx
    return x.reshape(ny, by, nx, bx).permute(0, 2, 1, 3) \
        .reshape(ny, nx, by * bx)


@numpy_inputs("data", "mask")
def background2d(
    data: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    nboxes_y: int = 16,
    nboxes_x: int = 16,
    filter_size: int = 3,
    sigma: float = 3.0,
    exclude_percentile: float = 25.0,
    upsample: str = "bilinear",
) -> torch.Tensor:
    """Full-resolution background model from a coarse box grid.

    Per box: the sigma-clipped median of the unmasked pixels (``mask``
    True = excluded); boxes whose good fraction is under
    ``exclude_percentile`` % take the median of the accepted boxes.  The
    grid is smoothed with a (filter_size x filter_size) median filter and
    upsampled to full resolution: ``upsample='bilinear'`` (one pass over
    the output) or ``'spline'`` (order-3 B-spline zoom with scipy's
    grid-mode semantics, as two matrix products).

    The image must be evenly divisible by the box grid."""
    if upsample not in ("bilinear", "spline"):
        raise ValueError(f"unknown upsample '{upsample}'")
    data = to_float32(data)
    dev = data.device
    h, w = data.shape
    if h % nboxes_y or w % nboxes_x:
        raise ValueError(
            f"image {h}x{w} not divisible by box grid {nboxes_y}x{nboxes_x}")
    by, bx = h // nboxes_y, w // nboxes_x
    boxes = _boxes(data, nboxes_y, nboxes_x)
    good = torch.ones_like(boxes, dtype=torch.bool) if mask is None else \
        _boxes(~mask.to(torch.bool), nboxes_y, nboxes_x)

    keep = sigma_clip_mask(boxes, good, sigma_lower=sigma, sigma_upper=sigma,
                           maxiters=5, axis=2)
    box_med = masked_median(boxes, keep, axis=2)
    good_frac = good.to(torch.float32).mean(dim=2)
    ok = good_frac >= (exclude_percentile / 100.0)
    # fill rejected boxes with the median of accepted boxes
    global_fill = masked_median(box_med.reshape(-1), ok.reshape(-1))
    box_med = torch.where(ok, box_med, global_fill)

    # median filter over the box grid, edge-replicated
    box_med = _median_filter(box_med, filter_size)

    if upsample == "spline":
        my = torch.from_numpy(_spline_zoom_matrix(nboxes_y, h)) \
            .to(torch.float32).to(dev)
        mx = torch.from_numpy(_spline_zoom_matrix(nboxes_x, w)) \
            .to(torch.float32).to(dev)
        return my @ box_med @ mx.T

    # bilinear upsample box centres -> full resolution
    yc = (torch.arange(h, dtype=torch.float32, device=dev)
          - (by - 1) / 2.0) / by
    xc = (torch.arange(w, dtype=torch.float32, device=dev)
          - (bx - 1) / 2.0) / bx
    y0 = torch.floor(yc).long().clamp(0, nboxes_y - 1)
    x0 = torch.floor(xc).long().clamp(0, nboxes_x - 1)
    y1 = (y0 + 1).clamp(0, nboxes_y - 1)
    x1 = (x0 + 1).clamp(0, nboxes_x - 1)
    fy = (yc - y0).clamp(0.0, 1.0)[:, None]
    fx = (xc - x0).clamp(0.0, 1.0)[None, :]
    g00 = box_med[y0[:, None], x0[None, :]]
    g01 = box_med[y0[:, None], x1[None, :]]
    g10 = box_med[y1[:, None], x0[None, :]]
    g11 = box_med[y1[:, None], x1[None, :]]
    return ((1 - fy) * (1 - fx) * g00 + (1 - fy) * fx * g01
            + fy * (1 - fx) * g10 + fy * fx * g11)
