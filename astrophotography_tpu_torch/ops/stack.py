"""Sigma-clipped combination of a stack over its frame axis (the JAX
package's ``ops/stack.py``): ccdproc.combine's clip (centre = masked
median, deviation = mad_std) followed by a masked mean, median or sum."""

from __future__ import annotations

from typing import Optional

import torch

from ..device import numpy_inputs
from .stats import (_MAD_TO_STD, masked_mean_std, masked_median,
                    sigma_clip_mask)


@numpy_inputs("stack", "mask", "weights")
def sigma_clip_combine(
    stack: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    method: str = "average",
    sigma_lower: float = 5.0,
    sigma_upper: float = 5.0,
    maxiters: int = 1,
) -> torch.Tensor:
    """Combine an (N, ...) stack along axis 0 with per-pixel sigma
    clipping: |x - median| against sigma * mad_std per pixel column
    (``maxiters`` rounds; ccdproc runs one), then the masked mean
    ('average', optionally weighted by per-frame ``weights`` (N,)), the
    masked median ('median') or the masked sum ('sum').  ``mask`` True =
    valid.  Pixels with nothing kept are NaN (0 for 'sum')."""
    stack = stack.to(torch.float32)
    keep = torch.ones_like(stack, dtype=torch.bool) if mask is None else mask
    if maxiters == 1:
        # exactly two sorts (median and MAD) and elementwise work
        med = masked_median(stack, keep, axis=0)
        dev = (stack - med[None]).abs()
        mad = masked_median(dev, keep, axis=0)
        std = _MAD_TO_STD * mad
        keep = keep & (stack >= (med - sigma_lower * std)[None]) \
            & (stack <= (med + sigma_upper * std)[None])
    else:
        keep = sigma_clip_mask(stack, keep, sigma_lower=sigma_lower,
                               sigma_upper=sigma_upper, maxiters=maxiters,
                               axis=0, cenfunc="median", stdfunc="mad_std")
    if method == "median":
        return masked_median(stack, keep, axis=0)
    if method == "sum":
        return torch.where(keep, stack, 0.0).sum(dim=0)
    if method == "average":
        if weights is None:
            mean, _ = masked_mean_std(stack, keep, axis=0)
            return mean
        w = weights.to(device=stack.device, dtype=torch.float32) \
            .reshape((-1,) + (1,) * (stack.dim() - 1))
        wm = torch.where(keep, w, 0.0)
        denom = wm.sum(dim=0)
        return (stack * wm).sum(dim=0) / torch.clamp(denom, min=1e-30)
    raise ValueError(f"unknown combine method {method!r}")
