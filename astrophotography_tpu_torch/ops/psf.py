"""Batched 2-D Gaussian PSF fitting by Levenberg-Marquardt (the JAX
package's ``ops/psf.py``).

All stars are fitted at once: fixed-size cutouts stacked into an
(N, box, box) tensor, a fixed number of LM steps with per-star damping
and acceptance, and a batched 7x7 normal-equation solve.  The model is a
rotated Gaussian plus a constant, weighted by 1 / sqrt(counts);
FWHM = 2.35482 * sigma, with the axial ratio and a 3-sigma circularity
test.  The Jacobian of the residuals is written out by hand.

Also the isolation filter: each star's distance to its nearest valid
neighbour by brute-force pairwise distances.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..device import numpy_inputs, to_float32
from .stats import mad_std, masked_median, sigma_clip_mask

FWHM_PER_SIGMA = 2.35482
#: the widths the model clamps sigma_x, sigma_y to from below
_MIN_SIGMA = 0.3


class PSFFits(NamedTuple):
    """Per-star fit results (fixed capacity)."""

    amplitude: torch.Tensor
    x0: torch.Tensor            # absolute image coords
    y0: torch.Tensor
    fwhm_x: torch.Tensor
    fwhm_y: torch.Tensor
    theta: torch.Tensor
    background: torch.Tensor
    chi2_red: torch.Tensor
    fwhm_x_err: torch.Tensor
    fwhm_y_err: torch.Tensor
    axial_ratio: torch.Tensor   # max/min fwhm, >= 1
    circular: torch.Tensor      # bool: |fx-fy| < 3*sqrt(errx^2+erry^2)
    valid: torch.Tensor


@numpy_inputs("data", "x", "y")
def extract_cutouts(
    data: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    box: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, box, box) cutout stack centred (to the pixel) on each star,
    with origins clamped so every cutout lies inside the image.

    Returns (cutouts, x_origin, y_origin)."""
    h, w = data.shape
    half = box // 2
    d = torch.arange(box, device=data.device)
    iy = (torch.round(y.to(torch.float32)).to(torch.int64) - half) \
        .clamp(0, h - box)
    ix = (torch.round(x.to(torch.float32)).to(torch.int64) - half) \
        .clamp(0, w - box)
    cuts = data[iy[:, None, None] + d[:, None], ix[:, None, None] + d[None, :]]
    return cuts, ix.to(torch.int32), iy.to(torch.int32)


def _gauss2d_terms(params: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor):
    """The pieces of the model for (N, 7) ``params`` on the (box, box)
    grids: the exponential E (N, box, box), the offsets dx, dy, the
    quadratic form's a, b, c (N, 1, 1), the clamped sigmas, cos and sin
    of theta."""
    amp, x0, y0, sx, sy, theta, bg = (params[:, k, None, None]
                                      for k in range(7))
    sx = sx.clamp(min=_MIN_SIGMA)
    sy = sy.clamp(min=_MIN_SIGMA)
    ct, st = torch.cos(theta), torch.sin(theta)
    a = ct ** 2 / (2 * sx ** 2) + st ** 2 / (2 * sy ** 2)
    b = st * ct * (1.0 / (2 * sx ** 2) - 1.0 / (2 * sy ** 2))
    c = st ** 2 / (2 * sx ** 2) + ct ** 2 / (2 * sy ** 2)
    dx = xx - x0
    dy = yy - y0
    e = torch.exp(-(a * dx * dx + 2 * b * dx * dy + c * dy * dy))
    return e, dx, dy, a, b, c, sx, sy, ct, st


def _gauss2d(params: torch.Tensor, xx: torch.Tensor, yy: torch.Tensor
             ) -> torch.Tensor:
    """Rotated Gaussian plus a constant for (N, 7) parameter rows
    (amp, x0, y0, sigma_x, sigma_y, theta, bg) -> (N, box, box)."""
    e = _gauss2d_terms(params, xx, yy)[0]
    return params[:, 0, None, None] * e + params[:, 6, None, None]


def _residuals_jacobian(params, cut, w, xx, yy):
    """Weighted residuals r (N, M) and their Jacobian J = dr/dp
    (N, M, 7), M = box^2.  Below the sigma clamp the derivative with
    respect to that sigma is zero."""
    n = params.shape[0]
    e, dx, dy, a, b, c, sx, sy, ct, st = _gauss2d_terms(params, xx, yy)
    amp = params[:, 0, None, None]
    bg = params[:, 6, None, None]
    r = ((cut - (amp * e + bg)) * w).reshape(n, -1)
    ae = amp * e
    free_x = (params[:, 3, None, None] > _MIN_SIGMA).to(e.dtype)
    free_y = (params[:, 4, None, None] > _MIN_SIGMA).to(e.dtype)
    isx3, isy3 = 1.0 / sx ** 3, 1.0 / sy ** 3
    dxx, dxy, dyy = dx * dx, dx * dy, dy * dy
    # d(model)/dp, then J = -w * d(model)/dp
    d_amp = e
    d_x0 = ae * (2 * a * dx + 2 * b * dy)
    d_y0 = ae * (2 * b * dx + 2 * c * dy)
    d_sx = ae * isx3 * (ct ** 2 * dxx + 2 * st * ct * dxy + st ** 2 * dyy) \
        * free_x
    d_sy = ae * isy3 * (st ** 2 * dxx - 2 * st * ct * dxy + ct ** 2 * dyy) \
        * free_y
    k = 1.0 / (2 * sx ** 2) - 1.0 / (2 * sy ** 2)
    d_th = -ae * (-2 * st * ct * k * dxx
                  + 2 * (ct ** 2 - st ** 2) * k * dxy
                  + 2 * st * ct * k * dyy)
    d_bg = torch.ones_like(e)
    jac = torch.stack([d_amp, d_x0, d_y0, d_sx, d_sy, d_th, d_bg], dim=-1)
    jac = -(jac * w[..., None]).reshape(n, -1, 7)
    return r, jac


@numpy_inputs("cutouts", "valid", "x_origin", "y_origin")
def fit_gaussian2d(
    cutouts: torch.Tensor,
    valid: torch.Tensor,
    x_origin: torch.Tensor,
    y_origin: torch.Tensor,
    init_fwhm: float = 3.0,
    box: int = 16,
    iters: int = 40,
) -> PSFFits:
    """LM-fit a Gaussian plus a constant to every cutout at once.

    Weights are 1 / sqrt(max(counts, 1)); the step count is fixed, with a
    per-star acceptance of each step.  A singular normal system gives
    non-finite steps, which are never accepted, and a non-finite
    ``chi2_red`` makes the fit invalid."""
    n = cutouts.shape[0]
    dev = cutouts.device
    cutouts = to_float32(cutouts)
    ax = torch.arange(box, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")

    wgt = 1.0 / torch.sqrt(cutouts.clamp(min=1.0))

    # initial parameters per star; the median of an even count is the
    # mean of the two middle values
    srt = torch.sort(cutouts.reshape(n, -1), dim=1).values
    m = box * box
    bg0 = 0.5 * (srt[:, (m - 1) // 2] + srt[:, m // 2])
    amp0 = srt[:, -1] - bg0
    sig0 = init_fwhm / FWHM_PER_SIGMA
    # centroid of the background-subtracted counts as the first position
    pos = (cutouts - bg0[:, None, None]).clamp(min=0.0)
    tot = pos.sum(dim=(1, 2)).clamp(min=1e-9)
    cx0 = (pos * xx[None]).sum(dim=(1, 2)) / tot
    cy0 = (pos * yy[None]).sum(dim=(1, 2)) / tot
    sig = torch.full((n,), sig0, dtype=torch.float32, device=dev)
    params = torch.stack([amp0, cx0, cy0, sig, sig, torch.zeros_like(sig),
                          bg0], dim=1)                        # (N, 7)
    lam = torch.full((n,), 1e-3, dtype=torch.float32, device=dev)
    eye = torch.eye(7, dtype=torch.float32, device=dev)

    def cost(p):
        r = ((cutouts - _gauss2d(p, xx, yy)) * wgt).reshape(n, -1)
        return (r * r).sum(dim=1)

    for _ in range(iters):
        r, jac = _residuals_jacobian(params, cutouts, wgt, xx, yy)
        g = torch.einsum("nmk,nm->nk", jac, r)
        hess = torch.einsum("nmk,nml->nkl", jac, jac)
        hd = hess + lam[:, None, None] * torch.diag_embed(
            torch.diagonal(hess, dim1=1, dim2=2)) + 1e-8 * eye
        delta = torch.linalg.solve_ex(hd, g[..., None]).result[..., 0]
        new_p = params - delta
        accept = cost(new_p) < (r * r).sum(dim=1)
        params = torch.where(accept[:, None], new_p, params)
        lam = torch.where(accept, (lam * 0.33).clamp(min=1e-7),
                          (lam * 4.0).clamp(max=1e6))

    # covariance from the final Gauss-Newton Hessian, scaled by the
    # reduced chi^2
    r, jac = _residuals_jacobian(params, cutouts, wgt, xx, yy)
    hess = torch.einsum("nmk,nml->nkl", jac, jac) + 1e-8 * eye
    cov = torch.linalg.inv_ex(hess).inverse
    chi2r = (r * r).sum(dim=1) / (box * box - 7)
    perr = torch.sqrt((torch.diagonal(cov, dim1=1, dim2=2)
                       * chi2r[:, None]).clamp(min=0.0))

    amp, cx, cy, sx, sy, theta, bg = params.unbind(1)
    fwhm_x = FWHM_PER_SIGMA * sx.abs()
    fwhm_y = FWHM_PER_SIGMA * sy.abs()
    fx_err = FWHM_PER_SIGMA * perr[:, 3]
    fy_err = FWHM_PER_SIGMA * perr[:, 4]
    axial = torch.maximum(fwhm_x, fwhm_y) \
        / torch.minimum(fwhm_x, fwhm_y).clamp(min=1e-6)
    # circularity: FWHMs consistent within 3 sigma
    circ = (fwhm_x - fwhm_y).abs() < 3.0 * torch.sqrt(fx_err ** 2
                                                       + fy_err ** 2)
    ok = valid.to(torch.bool) & (amp > 0) & torch.isfinite(chi2r)
    return PSFFits(
        amplitude=amp,
        x0=cx + x_origin.to(torch.float32),
        y0=cy + y_origin.to(torch.float32),
        fwhm_x=fwhm_x, fwhm_y=fwhm_y, theta=theta, background=bg,
        chi2_red=chi2r, fwhm_x_err=fx_err, fwhm_y_err=fy_err,
        axial_ratio=axial, circular=circ, valid=ok)


@numpy_inputs("data", "x", "y", "valid")
def measure_fwhm(
    data: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    valid: torch.Tensor,
    init_fwhm: float = 3.0,
    box: int = 16,
) -> PSFFits:
    """Cutouts and the batched fit at the given star positions."""
    cuts, ixs, iys = extract_cutouts(data, x, y, box)
    return fit_gaussian2d(cuts, valid, ixs, iys, init_fwhm=init_fwhm, box=box)


@numpy_inputs("x", "y", "valid")
def nearest_neighbor_dist(x: torch.Tensor, y: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Distance to each star's nearest valid neighbour (brute force,
    O(N^2)); inf where there is none."""
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    d2 = dx * dx + dy * dy
    valid = valid.to(torch.bool)
    pair = valid[None, :] & valid[:, None] \
        & ~torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    return torch.sqrt(torch.where(pair, d2, torch.inf).amin(dim=1))


@numpy_inputs("x", "y", "valid")
def isolated_mask(x: torch.Tensor, y: torch.Tensor, valid: torch.Tensor,
                  min_sep: float) -> torch.Tensor:
    """True for stars whose nearest neighbour is at least ``min_sep``
    away."""
    return valid.to(torch.bool) \
        & (nearest_neighbor_dist(x, y, valid) >= min_sep)


def median_fwhm(fits: PSFFits, sigma: float = 3.0):
    """Sigma-clipped median FWHM (x and y) over the accepted fits: a
    ``sigma`` clip about the median with the MAD-std as deviation.

    Returns ((med_fx, madstd_fx), (med_fy, madstd_fy))."""
    out = []
    for vals in (fits.fwhm_x, fits.fwhm_y):
        keep = sigma_clip_mask(vals, fits.valid, sigma_lower=sigma,
                               sigma_upper=sigma, maxiters=5,
                               cenfunc="median", stdfunc="mad_std")
        out.append((masked_median(vals, keep), mad_std(vals, keep)))
    return tuple(out)
