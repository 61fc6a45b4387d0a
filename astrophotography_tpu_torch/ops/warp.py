"""Inverse-mapped affine image warps with Lanczos3 or bilinear
interpolation (the JAX package's ``ops/warp.py``).

Transforms are (2, 3) matrices [A | t] mapping output (x, y) to input
coordinates, as ``Similarity.matrix()`` gives them.  Every warp takes one
(H, W) image with a (2, 3) matrix, or an (N, H, W) batch with (N, 2, 3)
matrices, and returns (warped, coverage) of the output shape (with the
batch axis when one was given).  Batches run in chunks of frames so that
no temporary holds more than about ``_CHUNK_ELEMS`` values; on a CUDA
tensor the separable warp is one hand-written kernel instead
(``csrc/warp_separable.cu``).

:func:`lanczos3_poly` evaluates every separable-warp and warp+combine tap
weight with the degree-10 polynomial in t², never with ``sinc``, so the
port's weights are the reference's to float32 rounding.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..device import numpy_inputs, to_float32
from ..utils.timing import host_read

LANCZOS_A = 3

#: minimax-style polynomial of lanczos3(t) in u = t^2 on [0, 9]
#: (max abs error 2.8e-6)
_L3_POLY = (
    9.999994525888e-01,
    -1.827688926461e+00,
    1.122335944632e+00,
    -3.557261514981e-01,
    6.945395735140e-02,
    -9.185528553885e-03,
    8.680491817837e-04,
    -5.970731138175e-05,
    2.910034981863e-06,
    -9.078439824764e-08,
    1.359070044584e-09,
)

#: values per temporary of a chunk of frames (~512 MB in float32)
_CHUNK_ELEMS = 1 << 27


def lanczos3_poly(t: torch.Tensor) -> torch.Tensor:
    """lanczos3 weight via the polynomial in t^2 (zero for |t| >= 3)."""
    u = t * t
    acc = torch.full_like(u, _L3_POLY[-1])
    for c in _L3_POLY[-2::-1]:
        acc = acc * u + c
    return torch.where(u < 9.0, acc, 0.0)


def _lanczos_weights(frac: torch.Tensor, a: int = LANCZOS_A) -> torch.Tensor:
    """(..., 2a) separable Lanczos weights (sinc form) for the tap
    offsets -a+1 .. a of a fractional coordinate in [0, 1)."""
    offsets = torch.arange(-a + 1, a + 1, dtype=torch.float32,
                           device=frac.device)
    x = frac[..., None] - offsets
    eps = 1e-6
    small = x.abs() < eps
    safe = torch.where(small, 1.0, x)
    sinc = torch.where(small, 1.0,
                       torch.sin(math.pi * safe) / (math.pi * safe))
    sinc_a = torch.where(small, 1.0, torch.sin(math.pi * safe / a)
                         / (math.pi * safe / a))
    return torch.where(x.abs() < a, sinc * sinc_a, 0.0)


def _batched(img: torch.Tensor, matrix: torch.Tensor):
    """(images (N, H, W) float32, matrices (N, 2, 3) float32, single)."""
    single = img.dim() == 2
    imgs = to_float32(img)
    mats = matrix.to(device=imgs.device, dtype=torch.float32)
    if single:
        imgs, mats = imgs[None], mats[None]
    if mats.shape != (imgs.shape[0], 2, 3):
        raise ValueError(f"matrices must be ({imgs.shape[0]}, 2, 3), got "
                         f"{tuple(mats.shape)}")
    return imgs, mats, single


def _chunked(fn, imgs, mats, single, per_frame: int):
    """Run ``fn`` over chunks of frames and join its (warped, coverage)."""
    n = imgs.shape[0]
    step = max(1, _CHUNK_ELEMS // max(per_frame, 1))
    parts = [fn(imgs[k:k + step], mats[k:k + step])
             for k in range(0, n, step)]
    out = torch.cat([p[0] for p in parts])
    cov = torch.cat([p[1] for p in parts])
    return (out[0], cov[0]) if single else (out, cov)


def _grid(mats: torch.Tensor, out_shape):
    """Source coordinates (sx, sy), each (N, H_out, W_out), of the
    output grid."""
    h_out, w_out = out_shape
    dev = mats.device
    ys = torch.arange(h_out, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w_out, dtype=torch.float32, device=dev)[None, :]
    m = mats[:, :, :, None, None]
    sx = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    sy = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    return sx, sy


def _floor_index(c: torch.Tensor, size: int) -> torch.Tensor:
    """floor(c) as int64, clamped to [-8, size + 8] first: every tap of
    a clamped coordinate is still outside the image, and a far-off
    coordinate (a rejected frame's 1e9 translation) cannot overflow."""
    return torch.clamp(torch.floor(c), -8.0, size + 8.0).to(torch.int64)


def _gather_taps(imgs: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor):
    """(values, in-bounds) of imgs[f, ty, tx] with indices clamped to the
    image."""
    n, h_in, w_in = imgs.shape
    inb = (ty >= 0) & (ty < h_in) & (tx >= 0) & (tx < w_in)
    idx = torch.clamp(ty, 0, h_in - 1) * w_in + torch.clamp(tx, 0, w_in - 1)
    vals = torch.gather(imgs.reshape(n, -1), 1, idx.reshape(n, -1))
    return vals.reshape(idx.shape), inb.to(torch.float32)


@numpy_inputs("img", "matrix")
def warp_affine_lanczos3(img: torch.Tensor, matrix: torch.Tensor,
                         out_shape: Tuple[int, int]):
    """Direct 6x6 Lanczos3 warp onto an (H_out, W_out) grid.  Returns
    (warped, weight): weight is the in-bounds kernel coverage in [0, 1]
    (0 outside the source), the swarp-style weight map; values are
    renormalised by the in-bounds weight."""
    imgs, mats, single = _batched(img, matrix)
    h_in, w_in = imgs.shape[1:]
    a = LANCZOS_A

    def run(im, mt):
        sx, sy = _grid(mt, out_shape)
        x0 = torch.floor(sx)
        y0 = torch.floor(sy)
        wx = _lanczos_weights(sx - x0)
        wy = _lanczos_weights(sy - y0)
        x0i = _floor_index(sx, w_in)
        y0i = _floor_index(sy, h_in)
        acc = torch.zeros_like(sx)
        wacc = torch.zeros_like(sx)
        for dy in range(2 * a):
            for dx in range(2 * a):
                vals, inb = _gather_taps(im, y0i + (dy - a + 1),
                                         x0i + (dx - a + 1))
                wgt = wy[..., dy] * wx[..., dx]
                acc = acc + wgt * inb * vals
                wacc = wacc + wgt * inb
        total_w = wy.sum(dim=-1) * wx.sum(dim=-1)
        coverage = wacc / torch.clamp(total_w, min=1e-9)
        nz = wacc != 0.0
        out = torch.where(nz, acc / torch.where(nz, wacc, 1.0), 0.0)
        return out, torch.clamp(coverage, 0.0, 1.0)

    per = out_shape[0] * out_shape[1] * 4 * a
    return _chunked(run, imgs, mats, single, per)


@numpy_inputs("img", "matrix")
def warp_affine_bilinear(img: torch.Tensor, matrix: torch.Tensor,
                         out_shape: Tuple[int, int]):
    """Bilinear warp (swarp's quick-look analogue); returns (warped,
    in-bounds weight clipped to [0, 1])."""
    imgs, mats, single = _batched(img, matrix)
    h_in, w_in = imgs.shape[1:]

    def run(im, mt):
        sx, sy = _grid(mt, out_shape)
        fx = sx - torch.floor(sx)
        fy = sy - torch.floor(sy)
        x0i = _floor_index(sx, w_in)
        y0i = _floor_index(sy, h_in)
        acc = torch.zeros_like(sx)
        wacc = torch.zeros_like(sx)
        for dy, dx, wgt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                            (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            vals, inb = _gather_taps(im, y0i + dy, x0i + dx)
            acc = acc + wgt * inb * vals
            wacc = wacc + wgt * inb
        out = torch.where(wacc > 0, acc / torch.clamp(wacc, min=1e-9), 0.0)
        return out, torch.clamp(wacc, 0.0, 1.0)

    per = out_shape[0] * out_shape[1] * 8
    return _chunked(run, imgs, mats, single, per)


def _slice_start(base: torch.Tensor, pad: int, padded: int,
                 length: int) -> torch.Tensor:
    """Source index of a window that starts at ``base`` in an axis padded
    by ``pad`` on the low side to ``padded`` values, with the start
    clamped as ``dynamic_slice`` clamps it to keep ``length`` values."""
    return torch.clamp(base + pad, 0, padded - length) - pad


def _clipped_base(c: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """floor(min c over the last two axes) - 3, clipped to [lo, hi], as
    int64 (clamped in float first: no overflow on far-off frames)."""
    m = torch.floor(c.amin(dim=(-2, -1)))
    return torch.clamp(m, lo - 8.0, hi + 8.0).to(torch.int64).sub(3) \
        .clamp(lo, hi)


def _resample_terms(coord, idx_f, block_at, span: int) -> torch.Tensor:
    """sum_s w(s) * block(s) / sum_s w(s), with w(s) the Lanczos3 weight
    of the distance from ``coord`` to block index ``idx_f + s``; 0 where
    the weight sum is not above 1e-3.  ``coord`` (c, nb, rows, cols),
    blocks (c, C, nb, rows, cols)."""
    acc = wsum = None
    for s in range(span):
        wt = lanczos3_poly(coord - (idx_f + s))
        term = wt[:, None] * block_at(s)
        acc = term if acc is None else acc + term
        wsum = wt if wsum is None else wsum + wt
    safe = wsum.abs() > 1e-3
    return torch.where(safe[:, None],
                       acc / torch.where(safe, wsum, 1.0)[:, None], 0.0)


def _separable_geometry(h_in: int, out_shape, band: int, span: int,
                        translation_budget):
    """(band, pad, pad_t) of a separable warp: the band cut to the
    source and output heights, and the low-side pads of the reference's
    padded source along columns and rows (the window starts' clamps)."""
    h_out, w_out = out_shape
    band = min(band, h_in, h_out)
    if translation_budget is not None:
        if translation_budget < span + 5:
            raise ValueError("translation_budget must exceed span + 4")
        pad = translation_budget + span + 4
    else:
        pad = w_out + span + 4
    pad_t = pad if translation_budget is not None else h_out + span + 4
    return band, pad, pad_t


@numpy_inputs("img", "matrix")
def warp_affine_separable(
    img: torch.Tensor,
    matrix: torch.Tensor,
    out_shape: Tuple[int, int],
    band: int = 64,
    span: int = 24,
    analytic_coverage: bool = False,
    translation_budget: "int | None" = None,
):
    """Two-pass separable Lanczos3 affine warp (Heckbert): a horizontal
    resample along source rows, then a vertical one, ``band`` rows at a
    time.  Each band's taps come from a window that starts at the band's
    integer base offset floor(min coord) - 3 and spans ``span`` shifts;
    the weight of shift s is lanczos3 of the distance to that window
    index, renormalised by the weight sum.

    Domain: the in-band spread of the source offset must fit in span - 6
    (|gx-1|*W + |gy|*band for pass 1, |m10|*W + |m11-1|*band for pass
    2); outside it pixels degrade to zero coverage, not wrong values.
    ``analytic_coverage`` gives coverage 1 iff the full 6-tap footprint
    of the source coordinate is inside the frame (else a warped ones
    channel is the coverage).  ``translation_budget`` bounds |shift|:
    frames beyond budget - span - 4 are excluded from analytic coverage.

    CUDA tensors run the hand-written kernel (``csrc/warp_separable.cu``,
    one launch a call on its 'smem' route), bit for bit
    :func:`warp_affine_separable_plain`, which CPU tensors run."""
    if img.device.type == "cpu":
        return warp_affine_separable_plain(img, matrix, out_shape, band,
                                           span, analytic_coverage,
                                           translation_budget)
    if img.device.type != "cuda":
        raise ValueError(f"no warp_separable kernel for device "
                         f"{img.device}")
    from .. import kernels

    imgs, mats, single = _batched(img, matrix)
    band, pad, pad_t = _separable_geometry(imgs.shape[1], out_shape, band,
                                           span, translation_budget)
    out, cov = kernels.warp_separable_cuda(imgs, mats, out_shape, band, span,
                                           analytic_coverage,
                                           translation_budget, pad, pad_t)
    return (out[0], cov[0]) if single else (out, cov)


@numpy_inputs("img", "matrix")
def warp_affine_separable_plain(
    img: torch.Tensor,
    matrix: torch.Tensor,
    out_shape: Tuple[int, int],
    band: int = 64,
    span: int = 24,
    analytic_coverage: bool = False,
    translation_budget: "int | None" = None,
):
    """Plain PyTorch twin of the separable warp kernel, on any device,
    in the kernel's operation order.  Same arguments and result as
    :func:`warp_affine_separable`.

    The JAX version zero-pads the source by w_out + span + 4 per side;
    here taps outside the image read 0 through clamped indices, and the
    horizontal pass only runs on the source rows the vertical pass
    reads, so its values are the same without those copies."""
    imgs, mats, single = _batched(img, matrix)
    h_in = imgs.shape[1]
    band, pad, pad_t = _separable_geometry(h_in, out_shape, band, span,
                                           translation_budget)
    h_out, w_out = out_shape

    def run(im, mt):
        return _separable_chunk(im, mt, out_shape, band, span,
                                analytic_coverage, translation_budget, pad,
                                pad_t)

    nchan = 1 if analytic_coverage else 2
    per = nchan * (h_in + h_out) * (w_out + span)
    return _chunked(run, imgs, mats, single, per)


def _separable_coeffs(mats: torch.Tensor):
    """(m00, m01, m02, m10, m11, m12, gx, gy, g0), each (c, 1, 1, 1), of
    (c, 2, 3) matrices: the exact decomposition out[y, x] = mid[sy(x, y),
    x] with mid[y', x] = in[y', g(x, y')] and g(x, sy(x, y)) == sx(x, y),
    g(x, y') = gx * x + gy * y' + g0."""
    m = mats.reshape(mats.shape[0], 6)[:, :, None, None, None]
    m00, m01, m02, m10, m11, m12 = m.unbind(1)
    inv_m11 = 1.0 / m11
    gx = m00 - m01 * m10 * inv_m11
    gy = m01 * inv_m11
    g0 = m02 - m01 * m12 * inv_m11
    return m00, m01, m02, m10, m11, m12, gx, gy, g0


def _separable_chunk(imgs, mats, out_shape, band, span, analytic_coverage,
                     translation_budget, pad, pad_t):
    c, h_in, w_in = imgs.shape
    h_out, w_out = out_shape
    dev = imgs.device
    m00, m01, m02, m10, m11, m12, gx, gy, g0 = _separable_coeffs(mats)
    xs = torch.arange(w_out, dtype=torch.float32, device=dev)
    src = imgs[:, None] if analytic_coverage else \
        torch.stack([imgs, torch.ones_like(imgs)], dim=1)     # (c, C, H, W)

    # vertical-pass geometry first: it decides which mid rows are read
    n_b2 = -(-h_out // band)
    rows2 = torch.arange(n_b2 * band, dtype=torch.float32,
                         device=dev).reshape(n_b2, band, 1)
    v = m10 * xs + m11 * rows2 + m12                  # (c, nb2, band, w_out)
    hp2 = pad_t + h_in + band + span + 4
    base2 = _clipped_base(v, -pad_t, h_in + 3)        # (c, nb2)
    start2 = _slice_start(base2, pad_t, hp2, band + span)
    with host_read(start2, reads=2):
        row_lo = max(int(start2.min()), 0)
        row_hi = min(int(start2.max()) + band + span, h_in)

    # horizontal pass over the bands holding those rows
    b_lo = row_lo // band
    b_hi = max(-(-row_hi // band), b_lo + 1)
    rows1 = torch.arange(b_lo * band, b_hi * band, dtype=torch.float32,
                         device=dev).reshape(b_hi - b_lo, band, 1)
    u = gx * xs + gy * rows1 + g0                     # (c, nb1, band, w_out)
    base1 = _clipped_base(u, -pad, w_in + 3)
    start1 = _slice_start(base1, pad, w_in + 2 * pad, w_out + span)
    # one zero row below and a zero column each side stand in for the pads
    srcz = F.pad(src, (1, 1, 0, 1))
    ri = torch.clamp(rows1.to(torch.int64), max=h_in)[None, None]
    ci = (torch.clamp(start1[:, :, None, None]
                      + torch.arange(w_out + span, device=dev), -1, w_in)
          + 1)[:, None]
    fi = torch.arange(c, device=dev)[:, None, None, None, None]
    chi = torch.arange(src.shape[1], device=dev)[None, :, None, None, None]
    block1 = srcz[fi, chi, ri, ci]                    # (c, C, nb1, band, W')
    mid = _resample_terms(u - base1[:, :, None, None].to(torch.float32), xs,
                          lambda s: block1[..., s:s + w_out], span)
    del block1, u
    nchan = src.shape[1]
    r0, r1 = b_lo * band, min(b_hi * band, h_in)
    mid = mid.reshape(c, nchan, -1, w_out)[:, :, :r1 - r0]
    midz = F.pad(mid, (0, 0, 1, 1))                   # zero row each side

    # vertical pass: out[y, x] = mid[v(x, y), x]
    rr = start2[:, :, None, None] + torch.arange(band + span, device=dev)[:, None]
    ri2 = (torch.clamp(rr, r0 - 1, r1) - (r0 - 1))[:, None]
    xi = torch.arange(w_out, device=dev)
    block2 = midz[fi, chi, ri2, xi]                   # (c, C, nb2, band+span, w_out)
    del mid, midz
    ri_band = torch.arange(band, dtype=torch.float32, device=dev)[:, None]
    out2 = _resample_terms(v - base2[:, :, None, None].to(torch.float32),
                           ri_band, lambda s: block2[:, :, :, s:s + band],
                           span)
    del block2, v
    out2 = out2.reshape(c, nchan, n_b2 * band, w_out)[:, :, :h_out]
    if analytic_coverage:
        # covered iff the full 6-tap footprint stays inside the source
        sx, sy = _grid(mats, out_shape)
        cov_b = ((sx >= 2.0) & (sx <= w_in - 4.0)
                 & (sy >= 2.0) & (sy <= h_in - 4.0))
        if translation_budget is not None:
            b_eff = float(translation_budget - span - 4)
            ys_o = torch.arange(h_out, dtype=torch.float32, device=dev)[:, None]
            cov_b = cov_b & ((sx - xs).abs() <= b_eff) \
                & ((sy - ys_o).abs() <= b_eff)
        cover = cov_b.to(torch.float32)
        return out2[:, 0] * cover, cover
    data, cover = out2[:, 0], out2[:, 1]
    ok = cover > 1e-6
    out = torch.where(ok, data / torch.where(ok, cover, 1.0), 0.0)
    return out, torch.clamp(cover, 0.0, 1.0)


@numpy_inputs("matrices", "frame_weights")
def coverage_weight_map(matrices: torch.Tensor, in_shape: Tuple[int, int],
                        out_shape: Tuple[int, int],
                        frame_weights: torch.Tensor) -> torch.Tensor:
    """swarp-style coadd weight map on the output grid: per pixel, the
    sum over frames of ``frame_weights[i]`` times frame i's analytic
    Lanczos3 footprint coverage (the separable warp's analytic
    criterion).  Rejected frames (translation 1e9) cover nothing."""
    h_in, w_in = (float(v) for v in in_shape)
    mats = matrices.to(torch.float32)
    wts = frame_weights.to(device=mats.device, dtype=torch.float32)
    out = torch.zeros(out_shape, dtype=torch.float32, device=mats.device)
    for i in range(mats.shape[0]):
        sx, sy = _grid(mats[i:i + 1], out_shape)
        cov = ((sx[0] >= 2.0) & (sx[0] <= w_in - 4.0)
               & (sy[0] >= 2.0) & (sy[0] <= h_in - 4.0))
        out = out + cov.to(torch.float32) * wts[i]
    return out
