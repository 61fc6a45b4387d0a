"""Masked and sigma-clipped statistics with a fixed number of clip
iterations (the JAX package's ``ops/stats.py``).

Semantics follow astropy's ``sigma_clipped_stats`` / ``mad_std``:
centre = median, deviation = std, ``maxiters`` clip rounds (a mask that
stops changing gives astropy's converged result).  ``mask`` is True for
*valid* entries.  Medians sort with +inf sentinels in place of invalid
entries, so every shape is static and no boolean indexing happens.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import numpy_inputs

_MAD_TO_STD = 1.482602218505602  # 1/Phi^-1(3/4), astropy.stats.mad_std scale


def _move_axis_last(x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    if axis is None:
        return x.reshape(-1)
    return torch.movedim(x, axis, -1)


@numpy_inputs("x", "mask")
def masked_median(x: torch.Tensor, mask: torch.Tensor,
                  axis: Optional[int] = None) -> torch.Tensor:
    """Median of the elements where ``mask`` is True along ``axis``
    (``np.median`` of the selected values: the mean of the two central
    order statistics for an even count).  NaN where nothing is valid."""
    xv = _move_axis_last(x, axis)
    mv = _move_axis_last(mask, axis)
    srt = torch.sort(torch.where(mv, xv, torch.inf), dim=-1).values
    n = mv.sum(dim=-1)
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), min=0)
    lo_val = torch.gather(srt, -1, lo[..., None])[..., 0]
    hi_val = torch.gather(srt, -1, hi[..., None])[..., 0]
    med = 0.5 * (lo_val + hi_val)
    return torch.where(n > 0, med, torch.nan)


@numpy_inputs("x", "mask")
def masked_mean_std(x: torch.Tensor, mask: torch.Tensor,
                    axis: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std over the elements where ``mask`` is True
    (NaN where nothing is valid).  An invalid element adds exactly 0,
    even an inf or NaN one: the reference's ``x * mask`` compiles to that
    select under XLA."""
    xv = _move_axis_last(x, axis)
    mv = _move_axis_last(mask, axis)
    n = mv.to(xv.dtype).sum(dim=-1)
    n_safe = torch.clamp(n, min=1.0)
    mean = torch.where(mv, xv, 0.0).sum(dim=-1) / n_safe
    var = torch.where(mv, (xv - mean[..., None]) ** 2, 0.0).sum(dim=-1) \
        / n_safe
    std = torch.sqrt(var)
    empty = n == 0
    return (torch.where(empty, torch.nan, mean),
            torch.where(empty, torch.nan, std))


@numpy_inputs("x", "mask")
def mad_std(x: torch.Tensor, mask: Optional[torch.Tensor] = None,
            axis: Optional[int] = None) -> torch.Tensor:
    """Robust sigma: 1.4826 * median(|x - median(x)|)."""
    if mask is None:
        mask = torch.ones_like(x, dtype=torch.bool)
    med = masked_median(x, mask, axis=axis)
    dev = (x - (med if axis is None else med.unsqueeze(axis))).abs()
    return _MAD_TO_STD * masked_median(dev, mask, axis=axis)


@numpy_inputs("x", "mask")
def sigma_clip_mask(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    sigma_lower: float = 3.0,
    sigma_upper: float = 3.0,
    maxiters: int = 5,
    axis: Optional[int] = None,
    cenfunc: str = "median",
    stdfunc: str = "std",
) -> torch.Tensor:
    """Iterative sigma clip; returns the mask of surviving values (True =
    keep).  ``cenfunc`` 'median' (else the mean) and ``stdfunc`` 'std'
    (else mad_std) cover astropy's defaults and ccdproc.combine's.  The
    mask only shrinks: once clipped, a value stays clipped."""
    keep = torch.ones_like(x, dtype=torch.bool) if mask is None else mask
    for _ in range(maxiters):
        if cenfunc == "median":
            center = masked_median(x, keep, axis=axis)
        else:
            center, _ = masked_mean_std(x, keep, axis=axis)
        if stdfunc == "std":
            _, std = masked_mean_std(x, keep, axis=axis)
        else:
            std = mad_std(x, keep, axis=axis)
        if axis is not None:
            center = center.unsqueeze(axis)
            std = std.unsqueeze(axis)
        within = (x >= center - sigma_lower * std) \
            & (x <= center + sigma_upper * std)
        keep = keep & within
    return keep


@numpy_inputs("x", "mask")
def sigma_clipped_stats(
    x: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    sigma: float = 3.0,
    maxiters: int = 5,
    axis: Optional[int] = None,
    cenfunc: str = "median",
    stdfunc: str = "std",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, median, std) of the sigma-clipped data, astropy-compatible
    (``mask`` True = valid, the inverse of astropy's convention)."""
    keep = sigma_clip_mask(x, mask, sigma_lower=sigma, sigma_upper=sigma,
                           maxiters=maxiters, axis=axis, cenfunc=cenfunc,
                           stdfunc=stdfunc)
    mean, std = masked_mean_std(x, keep, axis=axis)
    median = masked_median(x, keep, axis=axis)
    if stdfunc == "mad_std":
        std = mad_std(x, keep, axis=axis)
    return mean, median, std
