"""DAOFIND-style star detection as fixed-capacity device ops (the JAX
package's ``ops/detect.py``).

:func:`find_stars` is Stetson's DAOFIND as photutils runs it: a lowered
Gaussian matched filter (the "density"), 3x3 local maxima above a
threshold, a top-k of the peaks, then centre-of-mass centroids and
optional sharpness / roundness per star.  Results have a static length
``max_stars`` with a boolean ``valid`` mask.  It takes one (H, W) frame
or an (N, H, W) batch with per-frame thresholds and floors.

:func:`fast_density` is the separable square-footprint density.  It
rounds through bfloat16 by default, operation by operation, exactly as
the JAX ``_fast_density`` does (PyTorch's bf16 elementwise ops round like
XLA's, so the master densities agree bit for bit); the detection
kernel's own density is float32 (``dtype``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import numpy_inputs, to_float32
from ..utils.timing import host_read
from .stencil import conv2d_static

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


@numpy_inputs("data")
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
        with host_read(x):             # a copy from pageable host memory
            return torch.as_tensor(v, dtype=dtype, device=x.device)

    gct = const(gc)
    ones = torch.ones_like(gct)
    gconv = _conv_separable_same(x, const(gr), gct)
    box = _conv_separable_same(x, ones, ones)
    return (gconv - const(mean_w) * box) * const(inv_den)


def daofind_kernel(fwhm: float) -> Tuple[np.ndarray, torch.Tensor, int]:
    """(kernel, footprint, radius): the lowered Gaussian matched filter
    over DAOFIND's circular footprint, normalised so that correlating
    it with data gives the least-squares amplitude of a Gaussian plus a
    constant.  The kernel is host-side float32 (its zero taps are
    skipped); the footprint is a float32 CPU tensor."""
    r = _kernel_radius(fwhm)
    sigma = fwhm * FWHM_TO_SIGMA
    yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
    d2 = (xx ** 2 + yy ** 2).astype(np.float32)
    foot = (d2 <= r * r + r).astype(np.float32)
    g = np.exp(-0.5 * d2 / sigma ** 2) * foot
    n = np.sum(foot)
    gsum = np.sum(g)
    gsq = np.sum(g * g)
    denom = gsq - gsum * gsum / n
    kernel = (g - (gsum / n)) * foot / denom
    return kernel.astype(np.float32), torch.from_numpy(foot), r


def _conv2d_same(img: torch.Tensor, kernel) -> torch.Tensor:
    """Zero-padded 2-D correlation by static shifted adds."""
    return conv2d_static(img, np.asarray(kernel), pad_mode="zero")


def _conv_separable_same(img: torch.Tensor, col: torch.Tensor,
                         row: torch.Tensor) -> torch.Tensor:
    """Zero-padded separable correlation with the rank-1 kernel col x
    row: the column pass first, then the row pass."""
    return _conv_cols(_conv_rows(img, col), row)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis in descending order,
    equal values in ascending index order, as ``jax.lax.top_k`` returns
    them (``torch.topk`` promises no order among ties).  Ties are
    resolved only at the k-th value's boundary, so no full sort of the
    row happens."""
    xf = x.to(torch.float32)        # bf16 values are exact in float32
    m = xf.shape[-1]
    flat = xf.reshape(-1, m)
    kth = torch.topk(flat, k, dim=-1).values[:, -1:]
    above = flat > kth
    tie = flat == kth
    need = k - above.sum(dim=-1, keepdim=True)
    take = above | (tie & (torch.cumsum(tie.to(torch.int32), dim=-1,
                                        dtype=torch.int32) <= need))
    with host_read(take):              # nonzero reads its count
        idx = torch.nonzero(take)[:, 1].reshape(-1, k)  # ascending per row
    vals = torch.gather(flat, 1, idx)
    order = torch.sort(vals, dim=1, descending=True, stable=True).indices
    vals = torch.gather(vals, 1, order).to(x.dtype)
    idx = torch.gather(idx, 1, order)
    return vals.reshape(*x.shape[:-1], k), idx.reshape(*x.shape[:-1], k)


def _per_frame(v, n: int, device) -> torch.Tensor:
    """A scalar or (N,) value as an (N,) float32 tensor on ``device``."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    return t.expand(n) if t.numel() == 1 else t


def _take(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img[f, y[f, ...], x[f, ...]] for an (N, H, W) image."""
    n, _h, w = img.shape
    idx = (y * w + x).reshape(n, -1)
    return torch.gather(img.reshape(n, -1), 1, idx).reshape(y.shape)


@numpy_inputs("data", "threshold", "mask")
def find_stars(
    data: torch.Tensor,
    fwhm: float = 3.0,
    threshold: "torch.Tensor | float" = 100.0,
    max_stars: int = 1024,
    mask: "torch.Tensor | None" = None,
    border: int = 2,
    topk_mode: str = "global",
    mode: str = "exact",
    stats: bool = True,
    bin_rows: bool = False,
    floor: "torch.Tensor | float" = 0.0,
) -> Stars:
    """Detect star-like sources in background-subtracted data.

    ``data`` is one (H, W) frame or an (N, H, W) batch; ``threshold``
    (density units: ``nsigma * bg_stddev``) and ``floor`` are scalars or
    (N,).  ``floor`` is a background level subtracted only where the
    offset matters (centroid cutouts, peak values): the matched filter
    has no DC response, so ``floor=center`` equals passing
    ``frame - center``.  ``mask`` (H, W) or (N, H, W), True = excluded.

    ``topk_mode`` 'global' ranks every peak; 'tile' keeps the strongest
    peak per 64x256 tile first (when the frame has at least
    ``max_stars`` tiles).  ``mode`` 'exact' is the circular-footprint
    float32 filter, 'fast' the separable square-footprint bf16 one.
    ``stats=False`` skips peak / sharpness / roundness (zeros).
    ``bin_rows`` (fast mode, stats=False): detect on 2x row-binned data.

    On a CUDA tensor the exact filter, its peaks and their top-k are one
    hand-written kernel pair (``csrc/find_exact.cu``) where
    :func:`_find_route` says 'kernel', bit for bit
    :func:`find_stars_plain`, which CPU tensors and the other routes run.

    Returns :class:`Stars` with (max_stars,) fields for one frame, or
    (N, max_stars) for a batch."""
    args = (data, fwhm, threshold, max_stars, mask, border, topk_mode, mode,
            stats, bin_rows, floor)
    if data.device.type == "cpu":
        return find_stars_plain(*args)
    if data.device.type != "cuda":
        raise ValueError(f"no find_exact kernel for device {data.device}")
    kernel, foot, r = daofind_kernel(fwhm)
    if _find_route(data.shape, max_stars, topk_mode, mode, kernel, foot,
                   r) != "kernel":
        return find_stars_plain(*args)
    from .. import kernels

    single, data, floor_f = _frames(data, floor)
    n = data.shape[0]
    thr = _per_frame(threshold, n, data.device)
    top_vals, py, px, dens = kernels.find_exact_cuda(
        data, kernel, r, thr, mask, max_stars, border, stats)
    return _measure(data, top_vals, py, px, dens, foot, r, 1, stats,
                    floor_f, single)


def _tile_topk(topk_mode: str, hd: int, w: int, max_stars: int,
               bin_r: int = 1) -> bool:
    """Whether the top-k keeps the strongest peak of each (64 / bin_r,
    256) tile first: ``topk_mode`` 'tile' on a frame of whole tiles, at
    least ``max_stars`` of them."""
    tth, ttw = 64 // bin_r, 256
    return (topk_mode == "tile" and hd % tth == 0 and w % ttw == 0
            and (hd // tth) * (w // ttw) >= max_stars)


def _find_route(shape, max_stars: int, topk_mode: str, mode: str,
                kernel: np.ndarray, foot: torch.Tensor, r: int) -> str:
    """How :func:`find_stars` detects on a CUDA stack of ``shape`` ((H, W)
    or (N, H, W)) with ``daofind_kernel``'s (kernel, foot, r): 'kernel'
    (``kernels.find_exact_cuda``), else the composed route the twin runs:
    'fast' (mode 'fast'), 'tile' (the tile top-k applies), 'radius' (no
    instance of the kernel past radius 8, fwhm from 11.33), 'taps' (a tap
    inside the circular footprint is 0, which an instance would not
    skip), 'max_stars' (more than 2048, or more than the twin ranks, where
    its top-k raises)."""
    from .. import kernels

    if mode == "fast":
        return "fast"
    h, w = shape[-2:]
    if _tile_topk(topk_mode, h, w, max_stars):
        return "tile"
    if r not in kernels._FIND_RADII:
        return "radius"
    if not np.array_equal(kernel != 0, foot.numpy() > 0):
        return "taps"
    ranked = (h // 2) * w if h % 2 == 0 else h * w
    if not 1 <= max_stars <= min(kernels._FIND_MAX_STARS, ranked):
        return "max_stars"
    return "kernel"


def _frames(data: torch.Tensor, floor):
    """(single, float32 (N, H, W) data, (N,) floor)."""
    single = data.dim() == 2
    data = to_float32(data)
    if single:
        data = data[None]
    return single, data, _per_frame(floor, data.shape[0], data.device)


@numpy_inputs("data", "threshold", "mask")
def find_stars_plain(
    data: torch.Tensor,
    fwhm: float = 3.0,
    threshold: "torch.Tensor | float" = 100.0,
    max_stars: int = 1024,
    mask: "torch.Tensor | None" = None,
    border: int = 2,
    topk_mode: str = "global",
    mode: str = "exact",
    stats: bool = True,
    bin_rows: bool = False,
    floor: "torch.Tensor | float" = 0.0,
) -> Stars:
    """Plain PyTorch twin of :func:`find_stars`, on any device, composed
    of whole-tensor operations: the filter tap by tap, the peak test by
    shifted maxima, the top-k by ``_top_k``.  Same arguments and result;
    the exact route's kernel is held to it bit for bit."""
    single, data, floor_f = _frames(data, floor)
    n, h, w = data.shape
    dev = data.device
    kernel, foot, r = daofind_kernel(fwhm)
    bin_r = 2 if (bin_rows and mode == "fast" and h % 2 == 0) else 1
    if bin_r > 1:
        if stats:
            raise ValueError("bin_rows requires stats=False (the "
                             "binned density has no per-star statistics)")
        det = 0.5 * (data[:, 0::2, :] + data[:, 1::2, :])
        dens = fast_density(det, fwhm, row_sigma_scale=0.5)
    elif mode == "fast":
        dens = fast_density(data, fwhm)
    else:
        dens = _conv2d_same(data, kernel)
    hd = h // bin_r
    if mask is not None:
        mask_d = (mask[..., 0::2, :] | mask[..., 1::2, :]) if bin_r > 1 \
            else mask
        dens = torch.where(mask_d, -torch.inf, dens).to(dens.dtype)
    thr = _per_frame(threshold, n, dev).to(dens.dtype)[:, None, None]

    # 3x3 local maxima above threshold, off the borders.  Plateau
    # tie-break: strict > against raster-earlier neighbours, >= against
    # later ones, so a flat 2-pixel peak yields exactly one detection
    pad = F.pad(dens, (1, 1, 1, 1), value=-torch.inf)
    nm_earlier = torch.full_like(dens, -torch.inf)
    nm_later = torch.full_like(dens, -torch.inf)
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            shifted = pad[:, dy:dy + hd, dx:dx + w]
            if dy * 3 + dx < 4:     # before the centre in raster order
                nm_earlier = torch.maximum(nm_earlier, shifted)
            else:
                nm_later = torch.maximum(nm_later, shifted)
    rows = torch.arange(hd, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    edge = (border + r + bin_r - 1) // bin_r
    bmask = ((rows >= edge) & (rows < hd - edge)
             & (cols >= border + r) & (cols < w - border - r))
    is_peak = ((dens > nm_earlier) & (dens >= nm_later) & (dens > thr)
               & bmask)
    score = torch.where(is_peak, dens, -torch.inf)
    del pad, nm_earlier, nm_later, is_peak

    tth, ttw = 64 // bin_r, 256
    if _tile_topk(topk_mode, hd, w, max_stars, bin_r):
        # strongest peak per (64, 256) tile (lowest raster index on
        # ties), then the top-k over the tiles
        s4 = score.reshape(n, hd // tth, tth, w // ttw, ttw)
        m = s4.amax(dim=(2, 4))
        ly = torch.arange(tth, dtype=torch.int32, device=dev)[:, None, None]
        lx = torch.arange(ttw, dtype=torch.int32, device=dev)
        hit = s4 == m[:, :, None, :, None]
        enc = torch.where(hit, ly * ttw + lx, 2 ** 30)
        loc = enc.amin(dim=(2, 4))
        top_vals, tidx = _top_k(m.reshape(n, -1), max_stars)
        ntj = w // ttw
        loc_k = torch.gather(loc.reshape(n, -1), 1, tidx).long()
        py = ((tidx // ntj) * tth + loc_k // ttw) * bin_r
        px = (tidx % ntj) * ttw + loc_k % ttw
    elif hd % 2 == 0:
        # two vertically adjacent strict maxima are impossible, so a
        # pairwise row max halves the top-k input losing no candidate
        r0 = score[:, 0::2, :]
        r1 = score[:, 1::2, :]
        bmax = torch.maximum(r0, r1)
        from_r1 = (r1 > r0).reshape(n, -1)
        top_vals, bidx = _top_k(bmax.reshape(n, -1), max_stars)
        py = ((bidx // w) * 2 + torch.gather(from_r1, 1, bidx).long()) * bin_r
        px = bidx % w
    else:
        top_vals, top_idx = _top_k(score.reshape(n, -1), max_stars)
        py = (top_idx // w) * bin_r
        px = top_idx % w
    del score
    return _measure(data, top_vals, py, px, dens, foot, r, bin_r, stats,
                    floor_f, single)


def _measure(data: torch.Tensor, top_vals: torch.Tensor, py: torch.Tensor,
             px: torch.Tensor, dens: "torch.Tensor | None",
             foot: torch.Tensor, r: int, bin_r: int, stats: bool,
             floor_f: torch.Tensor, single: bool) -> Stars:
    """The Stars tables of the (N, S) candidates (``top_vals`` at rows
    ``py``, columns ``px``; -inf = no star) of an (N, H, W) float32 stack:
    centre-of-mass centroids in the (2r + 1)^2 box and, with ``stats``,
    peak / sharpness / roundness from the density plane ``dens``."""
    n, h, w = data.shape
    max_stars = top_vals.shape[1]
    dev = data.device
    top_vals = top_vals.to(torch.float32)
    valid = torch.isfinite(top_vals)

    if bin_r > 1:
        # the binned peak row is only even-resolved: take the brighter of
        # its two full-resolution rows so the centroid box is centred
        py_alt = torch.clamp(py + 1, 0, h - 1)
        py = torch.where(_take(data, py_alt, px) > _take(data, py, px),
                         py_alt, py)

    box = 2 * r + 1
    y0 = torch.clamp(py - r, 0, h - box)
    x0 = torch.clamp(px - r, 0, w - box)
    d = torch.arange(box, device=dev)
    yy = y0[..., None, None] + d[:, None]            # (N, S, box, 1)
    xx = x0[..., None, None] + d[None, :]            # (N, S, 1, box)
    yy, xx = torch.broadcast_tensors(yy, xx)
    cut = _take(data, yy, xx)                        # (N, S, box, box)
    zero = torch.zeros((n, max_stars), dtype=torch.float32, device=dev)
    if stats:
        # sharpness: (peak pixel - footprint mean without the centre) /
        # density; floor-invariant, so taken on the raw values
        footd = foot.to(dev)
        center_raw = _take(data, py, px)
        foot_n = footd.sum() - 1.0
        foot_mean = ((cut * footd).sum(dim=(-2, -1)) - center_raw) / foot_n
        dens_peak = _take(dens, py, px).to(torch.float32)
        sharp = (center_raw - foot_mean) / torch.clamp(dens_peak, min=1e-12)
        peaks = center_raw - floor_f[:, None]
        # roundness: asymmetry of the 4-fold symmetric density sum
        dcut = _take(dens, yy, xx).to(torch.float32)
        sym2 = dcut + dcut.flip(-2, -1)
        hx = sym2.sum(dim=-2)
        hy = sym2.sum(dim=-1)
        sx = (hx - hx.flip(-1)).abs().sum(dim=-1)
        sy = (hy - hy.flip(-1)).abs().sum(dim=-1)
        tot = sym2.abs().sum(dim=(-2, -1)) + 1e-12
        rounds = (sx - sy) / tot
    else:
        peaks = sharp = rounds = zero
    # centre of mass on the positive floor-subtracted data in the box
    pos = torch.clamp(cut - floor_f[:, None, None, None], min=0.0)
    ds = d.to(torch.float32)
    wsum = torch.clamp(pos.sum(dim=(-2, -1)), min=1e-12)
    cy = (pos * ds[:, None]).sum(dim=(-2, -1)) / wsum + y0
    cx = (pos * ds[None, :]).sum(dim=(-2, -1)) / wsum + x0
    stars = Stars(
        x=torch.where(valid, cx, zero), y=torch.where(valid, cy, zero),
        flux=torch.where(valid, top_vals, zero),
        peak=torch.where(valid, peaks, zero),
        sharpness=torch.where(valid, sharp, zero),
        roundness=torch.where(valid, rounds, zero), valid=valid)
    return Stars(*(f[0] for f in stars)) if single else stars


@numpy_inputs("data")
def find_saturated(
    data: torch.Tensor,
    sat_thresh: float,
    max_peaks: int = 256,
    box: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local maxima (>= every neighbour of the ``box`` x ``box``
    neighbourhood) above the saturation threshold, strongest first and in
    raster order among equal values, so a saturated plateau is listed
    from its first pixel on.

    Returns (x, y, valid) fixed-capacity (max_peaks,) tensors."""
    data = to_float32(data)
    h, w = data.shape
    half = box // 2
    pad = F.pad(data, (half, half, half, half), value=-torch.inf)
    neigh_max = torch.full_like(data, -torch.inf)
    for dy in range(box):
        for dx in range(box):
            if dy == half and dx == half:
                continue
            neigh_max = torch.maximum(neigh_max, pad[dy:dy + h, dx:dx + w])
    is_peak = (data >= neigh_max) & (data > sat_thresh)
    score = torch.where(is_peak, data, -torch.inf).reshape(-1)
    vals, idx = _top_k(score, max_peaks)
    valid = torch.isfinite(vals)
    return ((idx % w).to(torch.float32),
            torch.div(idx, w, rounding_mode="floor").to(torch.float32), valid)


@numpy_inputs("xs", "ys", "valid")
def mask_boxes(
    shape: Tuple[int, int],
    xs: torch.Tensor,
    ys: torch.Tensor,
    valid: torch.Tensor,
    half_width: int,
) -> torch.Tensor:
    """Boolean (H, W) mask with a (2 * half_width + 1)^2 box set around
    each valid point: pixel (row, col) is set when |row - y| and
    |col - x| are both <= half_width for some point.  Built as a 2-D
    difference array (four corner marks per box) and two running sums,
    so no (H, W, K) intermediate exists."""
    h, w = shape
    dev = xs.device
    ok = valid.to(torch.bool)

    def span(c, size):
        c = torch.where(ok, c.to(torch.float32), 0.0)
        lo = torch.ceil(c - half_width).clamp(0, size).long()
        hi = (torch.floor(c + half_width) + 1).clamp(0, size).long()
        return lo, hi

    r0, r1 = span(ys, h)
    c0, c1 = span(xs, w)
    one = ok.to(torch.int32)
    grid = torch.zeros(((h + 1) * (w + 1),), dtype=torch.int32, device=dev)
    for rr, cc, sign in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1),
                         (r1, c1, 1)):
        grid.index_add_(0, rr * (w + 1) + cc, sign * one)
    grid = grid.reshape(h + 1, w + 1).cumsum(dim=0).cumsum(dim=1)
    return grid[:h, :w] > 0
