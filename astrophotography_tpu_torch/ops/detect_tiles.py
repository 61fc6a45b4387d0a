"""Raw frames -> per-tile star candidates (the counterpart of the JAX
package's ``ops/pallas_detect.py``).

From raw uint16 (or float) frames, in one pass: 2x row binning of
raw*A (A = 1/flat, applied per ORIGINAL row), the separable
square-footprint DAOFIND density of the binned rows, minus the binned
master densities MF(B) + r*MF(C) (the filter is linear with zero DC
response, so this equals the density of the calibrated frame), a 3x3
local-maximum test with the raster tie-break, the per-frame threshold
and the border mask, and per (32 binned rows x 256 columns) tile the
strongest peak, its position and its sub-pixel parabola offsets.

:func:`detect_tiles` runs the hand-written CUDA kernel
(``csrc/detect_tiles.cu``) for CUDA tensors and
:func:`detect_tiles_plain` for CPU tensors.  Both compute in float32
(the TPU kernel's bfloat16 lane pass is a matrix-unit device).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import numpy_inputs, to_float32
from .detect import (FWHM_TO_SIGMA, _kernel_radius, _separable_taps,
                     fast_density)

#: binned tile geometry: (64, 256) raw-pixel tiles at 2x row binning
_TTY = 32
_TTX = 256
_BIN = 2
#: score of a position that is not a peak, and of an empty tile
_NEG = -3.0e38


def _filter_taps(fwhm: float):
    """(gr, gc, r, gsum/n, 1/denom) of the separable square-footprint
    lowered Gaussian with row_sigma_scale=0.5 (the 2x-binned-row PSF)."""
    return _separable_taps(fwhm, row_sigma_scale=0.5)


@functools.lru_cache(maxsize=None)
def _paroff_calibration(fwhm: float):
    """Odd-quintic corrections ((cy1, cy3, cy5), (cx1, cx3, cx5))
    mapping the raw 3-point-parabola peak-offset estimate back to the
    true sub-sample offset, fitted numerically against the matched
    filter's exact response to a point source at this fwhm (the
    box-subtracted, row-binned profile is not Gaussian, so the plain
    parabola is ~0.1 bin biased in y at fwhm 3)."""
    r = _kernel_radius(fwhm)
    sigma = fwhm * FWHM_TO_SIGMA
    d = np.arange(-r, r + 1, dtype=np.float64)
    gr = np.exp(-0.5 * d * d / (sigma * 0.5) ** 2)
    gc = np.exp(-0.5 * d * d / sigma ** 2)
    nbox = float((2 * r + 1) ** 2)
    mean_w = float(np.sum(gr)) * float(np.sum(gc)) / nbox

    def est_from_triple(a, b, c):
        den = a - 2.0 * b + c
        if abs(den) < 1e-12:
            return 0.0
        return float(np.clip(0.5 * (a - c) / den, -0.5, 0.5))

    # cross-axis constants at zero phase
    a1 = float(np.sum(gc * np.exp(-0.5 * d * d / sigma ** 2)))
    a2 = float(np.sum(np.exp(-0.5 * d * d / sigma ** 2)))

    def response_y(p):
        # binned row b averages full-res rows 2b, 2b+1; y_true = 2*p
        # relative to the b0 bin center
        b = np.arange(-r - 3, r + 4, dtype=np.float64)
        y0 = 2.0 * p
        s = 0.5 * (np.exp(-0.5 * (2 * b - 0.5 - y0) ** 2 / sigma ** 2)
                   + np.exp(-0.5 * (2 * b + 0.5 - y0) ** 2 / sigma ** 2))
        gy = np.correlate(s, gr, mode="same")
        by = np.correlate(s, np.ones_like(gr), mode="same")
        dens = gy * a1 - mean_w * by * a2
        c0 = len(b) // 2
        return dens[c0 - 1], dens[c0], dens[c0 + 1]

    def response_x(q):
        c = np.arange(-r - 3, r + 4, dtype=np.float64)
        s = np.exp(-0.5 * (c - q) ** 2 / sigma ** 2)
        gx = np.correlate(s, gc, mode="same")
        bx = np.correlate(s, np.ones_like(gc), mode="same")
        # cross-axis (y) constants at zero phase, binned profile
        b = np.arange(-r - 3, r + 4, dtype=np.float64)
        sy = 0.5 * (np.exp(-0.5 * (2 * b - 0.5) ** 2 / sigma ** 2)
                    + np.exp(-0.5 * (2 * b + 0.5) ** 2 / sigma ** 2))
        b1 = float(np.sum(gr * sy[len(b) // 2 - r:len(b) // 2 + r + 1]))
        b2 = float(np.sum(sy[len(b) // 2 - r:len(b) // 2 + r + 1]))
        dens = gx * b1 - mean_w * bx * b2
        c0 = len(c) // 2
        return dens[c0 - 1], dens[c0], dens[c0 + 1]

    def fit(responder):
        ps = np.linspace(-0.49, 0.49, 197)
        es = np.array([est_from_triple(*responder(p)) for p in ps])
        A = np.stack([es, es ** 3, es ** 5], axis=1)
        c1, c3, c5 = np.linalg.lstsq(A, ps, rcond=None)[0]
        return float(c1), float(c3), float(c5)

    return fit(response_y), fit(response_x)


@functools.lru_cache(maxsize=None)
def _kernel_params(fwhm: float):
    """(params, r) for the kernel: the float32 taps gr, gc, then mean_w,
    1/denom and the six parabola-offset corrections, as a tuple of
    floats; fitted once per fwhm, as the JAX wrapper fits once per
    trace."""
    gr, gc, r, mean_w, inv_den = _filter_taps(fwhm)
    cal_y, cal_x = _paroff_calibration(fwhm)
    params = np.concatenate([gr, gc, np.asarray(
        [mean_w, inv_den, *cal_y, *cal_x], np.float32)]).astype(np.float32)
    return tuple(params.tolist()), r


@numpy_inputs("bias", "dark_used", "flat")
def master_densities(bias: torch.Tensor, dark_used: torch.Tensor,
                     flat: Optional[torch.Tensor],
                     fwhm: float = 3.0) -> torch.Tensor:
    """(2, H//2, W) float32: the binned densities of B = bias/flat and
    C = dark_used/flat — what the detector subtracts from
    density(raw * A) to get the density of the calibrated frame.  B and
    C are binned per ORIGINAL row after the multiply by A, exactly as
    the kernel bins raw * A.  The densities round through bfloat16 as
    the JAX package's do (:func:`~.detect.fast_density`)."""
    bias = bias.to(torch.float32)
    dark_used = dark_used.to(torch.float32)
    if flat is not None:
        a = 1.0 / flat.to(torch.float32)
        bias = bias * a
        dark_used = dark_used * a
    b2 = 0.5 * (bias[0::2, :] + bias[1::2, :])
    c2 = 0.5 * (dark_used[0::2, :] + dark_used[1::2, :])
    return torch.stack([fast_density(b2, fwhm, row_sigma_scale=0.5),
                        fast_density(c2, fwhm, row_sigma_scale=0.5)]) \
        .to(torch.float32)


def _check_geometry(frames: torch.Tensor) -> None:
    if frames.dim() != 3:
        raise ValueError(f"frames must be (N, H, W), got {tuple(frames.shape)}")
    _n, h, w = frames.shape
    if h % (_BIN * _TTY) or w % _TTX:
        raise ValueError(f"geometry {tuple(frames.shape)} needs H % "
                         f"{_BIN * _TTY} == 0 and W % {_TTX} == 0")


def _paroff(a, b, c, coef):
    """Calibrated 3-point parabola offset through (a, b, c), b the peak;
    0 for empty tiles (b = the -3e38 sentinel)."""
    valid = b > -1e37
    a = torch.where(valid, a, 0.0)
    b = torch.where(valid, b, 0.0)
    c = torch.where(valid, c, 0.0)
    den = a - 2.0 * b + c
    safe = valid & (den.abs() > 1e-12)
    off = torch.where(safe, 0.5 * (a - c) / torch.where(safe, den, 1.0), 0.0)
    e = off.clamp(-0.5, 0.5)
    e2 = e * e
    c1, c3, c5 = (float(np.float32(v)) for v in coef)
    return (e * (c1 + e2 * (c3 + e2 * c5))).clamp(-0.5, 0.5)


@numpy_inputs("frames", "thresholds", "mf_bc", "a_plane", "exp_ratios")
def detect_tiles_plain(
    frames: torch.Tensor,
    thresholds: torch.Tensor,
    mf_bc: Optional[torch.Tensor] = None,
    a_plane: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    fwhm: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the detection kernel, one frame at a time,
    on any device.  Same arguments and results as :func:`detect_tiles`."""
    _check_geometry(frames)
    n, h, w = frames.shape
    h2 = h // _BIN
    dev = frames.device
    gr, gc, r, _mean_w, _inv_den = _filter_taps(fwhm)
    cal_y, cal_x = _paroff_calibration(fwhm)
    if exp_ratios is None:
        exp_ratios = torch.ones((n,), dtype=torch.float32, device=dev)
    thr = thresholds.to(torch.float32)
    er = exp_ratios.to(torch.float32)
    tyn, txn = h2 // _TTY, w // _TTX
    rows = torch.arange(h2, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    border = ((rows >= r + 1) & (rows < h2 - r - 1)
              & (cols >= 2 + r) & (cols < w - 2 - r))
    lidx = (torch.arange(_TTY, device=dev)[:, None] * _TTX
            + torch.arange(_TTX, device=dev)[None, :]) \
        .reshape(1, _TTY, 1, _TTX)
    outs = []
    for f in range(n):
        x = to_float32(frames[f])
        if a_plane is not None:
            x = x * a_plane
        binned = 0.5 * (x[0::2, :] + x[1::2, :])
        dens = fast_density(binned, fwhm, row_sigma_scale=0.5,
                            dtype=torch.float32)
        if mf_bc is not None:
            dens = dens - (mf_bc[0] + er[f] * mf_bc[1])
        # 3x3 local maximum, raster tie-break: strict > against the
        # raster-earlier neighbours, >= against the later ones
        p = torch.nn.functional.pad(dens, (1, 1, 1, 1), value=_NEG)
        nb = [p[dy:dy + h2, dx:dx + w] for dy in range(3) for dx in range(3)]
        earlier = torch.stack(nb[0:4]).amax(dim=0)
        later = torch.stack(nb[5:9]).amax(dim=0)
        is_peak = (dens > earlier) & (dens >= later) & (dens > thr[f]) & border
        score = torch.where(is_peak, dens, _NEG)
        s4 = score.reshape(tyn, _TTY, txn, _TTX)
        m = s4.amax(dim=(1, 3))
        hit = s4 >= m[:, None, :, None]
        loc = torch.where(hit, lidx, 2 ** 30).amin(dim=(1, 3))
        # sub-pixel offsets from the winner's cross neighbourhood
        ly, lx = loc // _TTX, loc % _TTX
        gy = torch.arange(tyn, device=dev)[:, None] * _TTY + ly
        gx = torch.arange(txn, device=dev)[None, :] * _TTX + lx
        pd = torch.nn.functional.pad(dens, (1, 1, 1, 1))
        du = pd[gy, gx + 1]
        dd = pd[gy + 2, gx + 1]
        dl = pd[gy + 1, gx]
        dr = pd[gy + 1, gx + 2]
        yoff = _paroff(du, m, dd, cal_y)
        xoff = _paroff(dl, m, dr, cal_x)
        outs.append((m, loc.to(torch.int32), yoff, xoff))
    return tuple(torch.stack([o[k] for o in outs]) for k in range(4))


@numpy_inputs("frames", "thresholds", "mf_bc", "a_plane", "exp_ratios")
def detect_tiles(
    frames: torch.Tensor,
    thresholds: torch.Tensor,
    mf_bc: Optional[torch.Tensor] = None,
    a_plane: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    fwhm: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-tile strongest calibrated-density peak from raw frames.

    ``frames`` (N, H, W) uint16 or float32 raw; ``thresholds`` (N,)
    density thresholds (nsigma * std); ``mf_bc`` (2, H//2, W) from
    :func:`master_densities` (None = no additive masters); ``a_plane``
    (H, W) 1/flat (None = no flat); ``exp_ratios`` (N,) dark scalings.
    Returns ``(maxv, idx, yoff, xoff)``, each (N, H//64, W//256): the
    tile's strongest peak density (-3e38 where the tile has none), its
    row-major position in the (32, 256) binned tile (lowest on ties; 0
    for empty tiles), and its calibrated parabola offsets in binned
    rows / full-resolution columns, clipped to +-0.5.  Needs
    H % 64 == 0 and W % 256 == 0.

    CUDA tensors run the hand-written kernel; CPU tensors run
    :func:`detect_tiles_plain`."""
    _check_geometry(frames)
    if frames.device.type == "cpu":
        return detect_tiles_plain(frames, thresholds, mf_bc=mf_bc,
                                  a_plane=a_plane, exp_ratios=exp_ratios,
                                  fwhm=fwhm)
    if frames.device.type != "cuda":
        raise ValueError(f"no detection kernel for device {frames.device}")
    from .. import kernels

    params, r = _kernel_params(float(fwhm))
    return kernels.detect_tiles_cuda(frames, thresholds, mf_bc, a_plane,
                                     exp_ratios, params, r)
