"""DAOFIND-style detection pieces the lean path needs (the JAX
package's ``ops/detect.py``): the kernel radius, the fixed-capacity
``Stars`` table, and the separable square-footprint density that
``master_densities`` applies to the bias and dark masters.

:func:`fast_density` rounds through bfloat16 by default, operation by
operation, exactly as the JAX ``_fast_density`` does (PyTorch's bf16
elementwise ops round like XLA's, so the master densities agree bit for
bit); the detection kernel's own density is float32 (``dtype``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

FWHM_TO_SIGMA = 1.0 / 2.35482


class Stars(NamedTuple):
    """Fixed-capacity detected-star tables, (N, max_stars) each."""

    x: torch.Tensor          # centroid column (0-based)
    y: torch.Tensor          # centroid row (0-based)
    flux: torch.Tensor       # density-image amplitude at the peak
    peak: torch.Tensor       # peak pixel value (zeros on the lean path)
    sharpness: torch.Tensor
    roundness: torch.Tensor
    valid: torch.Tensor      # bool

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)


def _kernel_radius(fwhm: float) -> int:
    sigma = fwhm * FWHM_TO_SIGMA
    return max(2, int(round(1.5 * sigma * 2.35482 / 2)))


def _separable_taps(fwhm: float, row_sigma_scale: float = 1.0):
    """(gr, gc, r, mean_w, inv_den): the column taps ``gr`` (along rows),
    row taps ``gc`` (along columns), radius, and the lowered-Gaussian
    normalisation of the square-footprint matched filter."""
    r = _kernel_radius(fwhm)
    sigma = fwhm * FWHM_TO_SIGMA
    d = np.arange(-r, r + 1, dtype=np.float32)
    gc = np.exp(-0.5 * d * d / sigma ** 2)
    # row axis may be 2x-binned: the PSF is row_sigma_scale as wide there
    gr = np.exp(-0.5 * d * d / (sigma * row_sigma_scale) ** 2)
    n = float((2 * r + 1) ** 2)
    gsum = float(np.sum(gr)) * float(np.sum(gc))
    gsq = float(np.sum(gr * gr)) * float(np.sum(gc * gc))
    denom = gsq - gsum * gsum / n
    return gr, gc, r, gsum / n, 1.0 / denom


def _conv_rows(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Zero-padded correlation along axis -2 with ``taps`` (summed in
    tap order, in x's dtype)."""
    k = taps.shape[0]
    h = x.shape[-2]
    p = torch.nn.functional.pad(x, (0, 0, k // 2, k // 2))
    out = torch.zeros_like(x)
    for dy in range(k):
        out = out + taps[dy] * p[..., dy:dy + h, :]
    return out


def _conv_cols(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Zero-padded correlation along axis -1 with ``taps``."""
    k = taps.shape[0]
    w = x.shape[-1]
    p = torch.nn.functional.pad(x, (k // 2, k // 2))
    out = torch.zeros_like(x)
    for dx in range(k):
        out = out + taps[dx] * p[..., dx:dx + w]
    return out


def fast_density(data: torch.Tensor, fwhm: float,
                 row_sigma_scale: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Registration-grade DAOFIND density with a square footprint: the
    lowered-Gaussian matched filter over the full (2r+1)^2 square is
    exactly a separable Gaussian minus a constant times a separable box
    sum, so it runs as four 1-D passes (column pass first).  Computed
    and returned in ``dtype``, taps and constants rounded to it first.
    Works on (..., H, W)."""
    gr, gc, r, mean_w, inv_den = _separable_taps(fwhm, row_sigma_scale)
    x = data.to(dtype)

    def const(v):
        return torch.as_tensor(v, dtype=dtype, device=x.device)

    gct = const(gc)
    ones = torch.ones_like(gct)
    gconv = _conv_cols(_conv_rows(x, const(gr)), gct)
    box = _conv_cols(_conv_rows(x, ones), ones)
    return (gconv - const(mean_w) * box) * const(inv_den)
