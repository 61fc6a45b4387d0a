"""Circular-aperture photometry of all stars at once (the JAX package's
``ops/photometry.py``).

Per-star cutouts are gathered by index, aperture coverage is the exact
circle / pixel overlap area (photutils' exact mode) or an anti-aliased
+-0.5 px linear edge, and the annulus background is a sigma-clipped
median over the cutout's ring.

Geometry: aperture radius = ceil(2 * fwhm), annulus from that radius to
ceil(1.5 * radius), background counted as median * pi * r^2.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..device import numpy_inputs, to_float32
from .psf import extract_cutouts
from .stats import masked_median, sigma_clip_mask


class Photometry(NamedTuple):
    """Per-star photometry (fixed capacity, aligned with the Stars table)."""

    aperture_sum: torch.Tensor    # background-corrected ADU in aperture
    bgmed_per_pix: torch.Tensor   # sigma-clipped annulus median per pixel
    adu_per_sec: torch.Tensor
    magnitude: torch.Tensor       # instrumental: -2.5 log10(adu_per_sec)
    valid: torch.Tensor


def aperture_radii(fwhm: float, ap_fwhm_mult: float = 2.0):
    """(r_aperture, r_outer) of the aperture and its annulus."""
    r_ap = math.ceil(ap_fwhm_mult * fwhm)
    return r_ap, math.ceil(1.5 * r_ap)


def _disk_quadrant_area(x: torch.Tensor, y: torch.Tensor, r) -> torch.Tensor:
    """Area of {X <= x, Y <= y, X^2 + Y^2 <= r^2} for a disk of radius
    ``r`` centred at the origin (closed form; elementwise).

    Building block of the exact circle / pixel overlap: the disk-pixel
    intersection area is the 2-D inclusion-exclusion of this quadrant
    integral over the pixel corners."""
    r = float(r)
    xh = x.clamp(-r, r)
    yh = y.clamp(-r, r)

    def anti(u):
        # antiderivative of sqrt(r^2 - X^2)
        s = torch.sqrt(torch.clamp(r * r - u * u, min=0.0))
        return 0.5 * (u * s + r * r * torch.asin((u / r).clamp(-1.0, 1.0)))

    def seg(a, b):
        # integral of sqrt(r^2 - X^2) dX over [a, b] (a, b in [-r, r])
        b = torch.maximum(b, a)
        return anti(b) - anti(a)

    t = torch.sqrt(torch.clamp(r * r - yh * yh, min=0.0))
    mr = torch.full_like(xh, -r)
    # integral of clamp(yh, -s(X), s(X)) over [-r, xh]: the |X| > t
    # flanks contribute sign(yh) * s(X), the middle contributes yh
    sgn = torch.sign(yh)
    c = (sgn * seg(mr, torch.minimum(xh, -t))
         + yh * torch.clamp(torch.minimum(xh, t) + t, min=0.0)
         + sgn * seg(t, torch.maximum(xh, t)))
    return c + seg(mr, xh)


def _exact_cover(dx: torch.Tensor, dy: torch.Tensor, r) -> torch.Tensor:
    """Exact disk / pixel overlap area for pixels centred at (dx, dy)."""
    f = _disk_quadrant_area
    return (f(dx + 0.5, dy + 0.5, r) - f(dx - 0.5, dy + 0.5, r)
            - f(dx + 0.5, dy - 0.5, r) + f(dx - 0.5, dy - 0.5, r))


@numpy_inputs("data", "x", "y", "valid")
def aperture_photometry(
    data: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    valid: torch.Tensor,
    r_ap: int,
    r_out: int,
    exposure: float = 1.0,
    edge_method: str = "exact",
) -> Photometry:
    """Photometer all stars at (x, y) in one vectorized pass.

    ``data`` is the image WITHOUT background subtraction: the annulus
    median is subtracted here.  ``edge_method``: 'exact' (default) uses
    the closed-form circle / pixel overlap area; 'ramp' is the cheaper
    +-0.5 px linear-edge approximation (<= 0.5 % flux error)."""
    data = to_float32(data)
    dev = data.device
    box = 2 * (r_out + 1) + 1
    cx = x.to(torch.float32)
    cy = y.to(torch.float32)
    cut, ix, iy = extract_cutouts(data, cx, cy, box)
    df = torch.arange(box, dtype=torch.float32, device=dev)
    dy = df[None, :, None] + iy.to(torch.float32)[:, None, None] \
        - cy[:, None, None]                                  # (S, box, 1)
    dx = df[None, None, :] + ix.to(torch.float32)[:, None, None] \
        - cx[:, None, None]                                  # (S, 1, box)
    dist = torch.sqrt(dy * dy + dx * dx)
    if edge_method == "exact":
        dxb, dyb = torch.broadcast_tensors(dx, dy)
        cover = _exact_cover(dxb, dyb, r_ap)
    else:
        # anti-aliased coverage: 1 inside, 0 outside, linear edge
        cover = (r_ap + 0.5 - dist).clamp(0.0, 1.0)
    ap_sums = (cut * cover).sum(dim=(1, 2))
    # annulus ring, pixel-centre test (photutils method='center')
    ring = (dist >= r_ap) & (dist < r_out)
    flat = cut.reshape(cut.shape[0], -1)
    keep = sigma_clip_mask(flat, ring.reshape(flat.shape), sigma_lower=3.0,
                           sigma_upper=3.0, maxiters=5, axis=1)
    bgmeds = masked_median(flat, keep, axis=1)

    area = math.pi * r_ap * r_ap
    corrected = ap_sums - bgmeds * area
    adu_per_sec = corrected / float(exposure)
    magnitude = -2.5 * torch.log10(adu_per_sec.clamp(min=1e-12))
    zero = torch.zeros_like(ap_sums)
    valid = valid.to(torch.bool)
    return Photometry(
        aperture_sum=torch.where(valid, corrected, zero),
        bgmed_per_pix=torch.where(valid, bgmeds, zero),
        adu_per_sec=torch.where(valid, adu_per_sec, zero),
        magnitude=torch.where(valid, magnitude, zero),
        valid=valid,
    )
