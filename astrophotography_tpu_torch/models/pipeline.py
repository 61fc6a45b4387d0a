"""The stacking pipelines: calibrate -> detect -> register -> warp ->
sigma-clip stack over an (N, H, W) light stack (the JAX package's
``models/pipeline.py``).  Work runs on the device of ``frames``.

:func:`calibrate_register_stack` is the unfused path: it calibrates the
whole stack to float32, detects stars on every calibrated frame
(``ops/detect.find_stars``), registers every frame to the reference, then
warps the stack band by band (``ops/warp``) and sigma-clip combines each
band (:func:`combine_band`: the K3 kernel ``ops/clip_combine`` for
'average' under both 'xla' and 'pallas', ``ops/stack`` for 'median' and
'sum'), or hands the calibrated stack to the fused warp+combine kernel
(``combine_impl='fused'``).

:func:`calibrate_register_stack_lean` never holds a calibrated stack:
detection runs the fused raw->candidate kernel (``ops/detect_tiles``)
with the calibration folded in algebraically, or calibrates chunk by
chunk for ``find_stars``; the fused warp+combine kernel
(``ops/warp_combine``) calibrates raw taps on the fly.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import on_device, to_float32
from ..ops.calibrate import calibrate_batch
from ..ops.clip_combine import clip_combine
from ..ops.detect import Stars, _kernel_radius, find_stars
from ..ops.detect_tiles import (_BIN, _TTX, _TTY, detect_tiles,
                                master_densities)
from ..ops.register import (Similarity, estimate_similarity,
                            solve_turned, turned_past)
from ..ops.stack import sigma_clip_combine
from ..ops.stats import masked_median
from ..ops.warp import (warp_affine_bilinear, warp_affine_lanczos3,
                        warp_affine_separable)
from ..ops.warp_combine import warp_combine
from ..utils.timing import count, host_read, span
from .config import PipelineConfig


def _noise_row_stride(h: int) -> int:
    """Row stride of the noise-stat subsample: ~64 full rows on large
    frames, denser on small frames so tiny images keep a sample."""
    return max(8, min(64, h // 64))


def _sample_rows(x: torch.Tensor, st: int) -> torch.Tensor:
    """Every st-th row of an (..., H, W) tensor (a strided view)."""
    return x[..., ::st, :]


def frame_noise_stats(frames: torch.Tensor, center: str = "mean"):
    """Per-frame (center, robust std) of an (N, H, W) float32 stack, on
    every :func:`_noise_row_stride`-th row: the detection thresholds."""
    st = _noise_row_stride(frames.shape[1])
    sub = _sample_rows(frames, st).reshape(frames.shape[0], -1)
    return _noise_stats_from_sub(sub, center)


def _row_sums(x: torch.Tensor) -> torch.Tensor:
    """The sum of each row of an (N, M) float32 tensor, by folding the
    row's halves together (zero-padded to a power of two).  Only
    element-wise adds: a frame's sum does not depend on how many frames
    are summed at once, as a reduction kernel's order does on the card,
    so a frame-sharded caller gets the one-device statistics."""
    m = x.shape[1]
    p = 1 << max(m - 1, 0).bit_length()
    if p != m:
        x = torch.nn.functional.pad(x, (0, p - m))
    while x.shape[1] > 1:
        half = x.shape[1] // 2
        x = x[:, :half] + x[:, half:]
    return x[:, 0]


def _row_mean_std(sub: torch.Tensor, keep: torch.Tensor):
    """``ops.stats.masked_mean_std(sub, keep, axis=1)`` with its two sums
    folded by :func:`_row_sums`: the mean and population std of each
    row's kept entries, NaN where a row keeps none."""
    n = keep.sum(dim=1).to(torch.float32)
    n_safe = torch.clamp(n, min=1.0)
    mean = _row_sums(torch.where(keep, sub, 0.0)) / n_safe
    var = _row_sums(torch.where(keep, (sub - mean[:, None]) ** 2, 0.0)) \
        / n_safe
    empty = n == 0
    return (torch.where(empty, torch.nan, mean),
            torch.where(empty, torch.nan, torch.sqrt(var)))


def _clipped_median_std(sub: torch.Tensor):
    """``sigma_clipped_stats(sub, sigma=3, maxiters=3, axis=1)``'s median
    and std: the same three rounds of clipping about the median at 3
    std and the same median (a sort of each row), with the std's sums
    folded (:func:`_row_mean_std`), so no batch size changes them."""
    keep = torch.ones_like(sub, dtype=torch.bool)
    for _ in range(3):
        center = masked_median(sub, keep, axis=1)[:, None]
        std = _row_mean_std(sub, keep)[1][:, None]
        keep = keep & (sub >= center - 3.0 * std) & (sub <= center + 3.0 * std)
    return masked_median(sub, keep, axis=1), _row_mean_std(sub, keep)[1]


def _noise_stats_from_sub(sub: torch.Tensor, center: str):
    """(center, std) per row of an (N, M) float32 subsample: 'mean' = 3
    rounds of mean/std clipping at 3 sigma (no sorts); 'median' =
    ``sigma_clipped_stats(sigma=3, maxiters=3)``'s median and std
    (:func:`_clipped_median_std`).  Both fold their sums, so a frame's
    statistics do not depend on the frames beside it."""
    if center == "median":
        return _clipped_median_std(sub)
    keep = torch.ones_like(sub, dtype=torch.bool)
    for _ in range(3):
        nk = torch.clamp(keep.sum(dim=1), min=1).to(torch.float32)
        cen = _row_sums(torch.where(keep, sub, 0.0)) / nk
        var = _row_sums(torch.where(keep, (sub - cen[:, None]) ** 2,
                                    0.0)) / nk
        std = torch.sqrt(var)
        keep = keep & ((sub - cen[:, None]).abs() < 3.0 * std[:, None])
    return cen, std


def _calibration_planes(bias, dark, flat, dark_still_biased: bool, h, w,
                        device):
    """Combined calibration planes for ``cal = raw * A - B - r * C``.

    Returns ``(a_full, b_plane, c_plane, bias_t, dark_use, has_masters)``;
    ``a_full`` is None without a flat, ``b_plane`` / ``c_plane`` are None
    without a bias / dark.  With ``dark_still_biased`` the dark master
    still contains the bias, which is taken out here."""
    has_masters = any(m is not None for m in (bias, dark, flat))
    a_full = (1.0 / flat).to(torch.float32) if flat is not None else None
    bias_t = bias if bias is not None else \
        torch.zeros((h, w), dtype=torch.float32, device=device)
    if dark is not None:
        dark_use = dark - bias_t if (dark_still_biased
                                     and bias is not None) else dark
    else:
        dark_use = torch.zeros((h, w), dtype=torch.float32, device=device)
    af = a_full if a_full is not None else 1.0
    b_plane = (bias_t * af).to(torch.float32) if bias is not None else None
    c_plane = (dark_use * af).to(torch.float32) if dark is not None else None
    return a_full, b_plane, c_plane, bias_t, dark_use, has_masters


def _fused_detect_ok(config: PipelineConfig, h: int, w: int) -> bool:
    """The fused detector implements exactly the lean semantics (fast
    filter, 2x row bin, tile top-k) on this geometry."""
    return (config.detect_fast and config.detect_bin_rows
            and config.detect_topk == "tile"
            and h % 64 == 0 and w % 256 == 0 and (h // 2) % 32 == 0)


def _detect_stars_fused(frames, bias, dark, flat, exp_ratios,
                        config: PipelineConfig) -> Stars:
    """Registration-grade Stars tables (N, max_stars) from the fused
    raw->candidate detector: per-frame noise stats on calibrated
    subsampled rows, one detection pass over the raw stack, the top-k of
    the tile maxima, then either the detector's parabola offsets
    (centroid='kernel') or a centre of mass on calibrated 5x5 cutouts
    (centroid='com')."""
    n, h, w = frames.shape
    dev = frames.device
    with span("apt.detect.planes"):
        a_full, b_plane, c_plane, bias_t, dark_use, has_masters = \
            _calibration_planes(bias, dark, flat, config.dark_still_biased,
                                h, w, dev)

    # per-frame noise stats on calibrated SUBSAMPLED rows only
    with span("apt.detect.noise"):
        st = _noise_row_stride(h)
        cal_sub = to_float32(_sample_rows(frames, st))
        if a_full is not None:
            cal_sub = cal_sub * _sample_rows(a_full, st)
        if b_plane is not None:
            cal_sub = cal_sub - _sample_rows(b_plane, st)
        if c_plane is not None:
            cal_sub = cal_sub - exp_ratios[:, None, None] \
                * _sample_rows(c_plane, st)
        ce, std = _noise_stats_from_sub(cal_sub.reshape(n, -1),
                                        config.noise_center)

    with span("apt.detect.planes"):
        mf = master_densities(bias_t, dark_use, flat, fwhm=config.fwhm) \
            if has_masters else None
    with span("apt.detect.k1"):
        maxv, idxv, yoffv, xoffv = detect_tiles(
            frames, config.detect_nsigma * std, mf_bc=mf, a_plane=a_full,
            exp_ratios=exp_ratios, fwhm=config.fwhm)
    with span("apt.detect.select"):
        tx_n = maxv.shape[2]
        n_tiles = maxv.shape[1] * maxv.shape[2]
        k = min(config.max_stars, n_tiles)
        order = torch.sort(maxv.reshape(n, -1), dim=1, descending=True,
                           stable=True)
        top_vals, top_t = order.values[:, :k], order.indices[:, :k]
        if k < config.max_stars:
            # small frames have fewer tiles than the star capacity; pad
            pad = config.max_stars - k
            top_vals = torch.nn.functional.pad(top_vals, (0, pad),
                                               value=-3.0e38)
            top_t = torch.nn.functional.pad(top_t, (0, pad))
        valid = top_vals > -1.0e37
        loc = torch.gather(idxv.reshape(n, -1), 1, top_t).long()
        rb = (top_t // tx_n) * _TTY + loc // _TTX      # binned peak row
        py = rb * _BIN
        px = (top_t % tx_n) * _TTX + loc % _TTX
        zero = torch.zeros((n, config.max_stars), dtype=torch.float32,
                           device=dev)

        if config.centroid == "kernel":
            # the detector's calibrated parabola offsets (binned rows /
            # full-res columns); binned row b covers rows 2b..2b+1
            yo = torch.gather(yoffv.reshape(n, -1), 1, top_t)
            xo = torch.gather(xoffv.reshape(n, -1), 1, top_t)
            cx = px.to(torch.float32) + xo
            cy = (rb.to(torch.float32) + yo) * _BIN + 0.5
        else:
            cx, cy = _com_centroids(frames, py, px, ce, exp_ratios, a_full,
                                    b_plane, c_plane,
                                    _kernel_radius(config.fwhm))
        return Stars(x=torch.where(valid, cx, zero),
                     y=torch.where(valid, cy, zero),
                     flux=torch.where(valid, top_vals, zero), peak=zero,
                     sharpness=zero, roundness=zero, valid=valid)


def _com_centroids(frames, py, px, ce, exp_ratios, a_full, b_plane, c_plane,
                   r: int):
    """Centre of mass on CALIBRATED (2r+1)^2 cutouts around each peak,
    after picking the brighter of the peak's two full-resolution rows."""
    n, h, w = frames.shape
    box = 2 * r + 1
    fi = torch.arange(n, device=frames.device)[:, None]
    r_f = exp_ratios[:, None]
    # gather uint16 through an int16 view (uint16 indexing is only partly
    # implemented for CUDA tensors)
    src = frames.view(torch.int16) if frames.dtype == torch.uint16 else frames

    def calpix(y, x, fidx, rf):
        v = src[fidx, y, x]
        if frames.dtype == torch.uint16:
            v = v.to(torch.int32).bitwise_and_(0xFFFF)
        v = v.to(torch.float32)
        if a_full is not None:
            v = v * a_full[y, x]
        if b_plane is not None:
            v = v - b_plane[y, x]
        if c_plane is not None:
            v = v - rf * c_plane[y, x]
        return v

    py1 = torch.clamp(py + 1, 0, h - 1)
    take = calpix(py1, px, fi, r_f) > calpix(py, px, fi, r_f)
    cyr = torch.where(take, py1, py)
    y0 = torch.clamp(cyr - r, 0, h - box)
    x0 = torch.clamp(px - r, 0, w - box)
    d = torch.arange(box, device=frames.device)
    yy = (y0[..., None, None] + d[:, None])           # (N, S, box, 1)
    xx = (x0[..., None, None] + d[None, :])           # (N, S, 1, box)
    cut = calpix(yy, xx, fi[..., None, None], r_f[..., None, None])
    pos = torch.clamp(cut - ce[:, None, None, None], min=0.0)
    ds = d.to(torch.float32)
    wsum = torch.clamp(pos.sum(dim=(-2, -1)), min=1e-12)
    cy = (pos * ds[:, None]).sum(dim=(-2, -1)) / wsum + y0
    cx = (pos * ds[None, :]).sum(dim=(-2, -1)) / wsum + x0
    return cx, cy


def _ref_index(stars: Stars, config: PipelineConfig) -> int:
    """Registration reference frame: a fixed index, or 'auto' = the frame
    with the most detected stars (first on ties)."""
    if config.ref_frame == "auto":
        with host_read(stars.valid):
            return int(torch.argmax(stars.valid.sum(dim=1)))
    n = stars.valid.shape[0]
    idx = int(config.ref_frame)
    if not -n <= idx < n:
        raise ValueError(f"ref_frame {idx} out of range for {n} frames")
    return idx % n


def _solve_frame_similarities(stars: Stars, n: int, config: PipelineConfig):
    """Reference choice, every frame's similarity solve (solved again by
    ``solve_turned`` where the vote turns some frame past 2 deg), and the
    exact identity for the reference.  Returns (sims, matrices (N, 2,
    3), ref index)."""
    idx_ref = _ref_index(stars, config)
    tables = (stars.x[idx_ref], stars.y[idx_ref], stars.flux[idx_ref],
              stars.valid[idx_ref], stars.x, stars.y, stars.flux,
              stars.valid)
    sims = estimate_similarity(*tables, k=config.match_k)
    # the one wait for the device in the solve
    with host_read(stars.x):
        turned = bool(turned_past(sims))
    if turned:
        sims = solve_turned(*tables, k=config.match_k)
    # the reference's exact identity, selected on the device (a store of
    # a host value would copy it into the stream: a wait each)
    is_ref = torch.arange(n, device=sims.tx.device) == idx_ref
    ident = (1.0, 0.0, 0.0, 0.0, config.max_stars, 0.0)
    sims = Similarity(*(torch.where(is_ref, idv, v)
                        for v, idv in zip(sims, ident)))
    return sims, sims.matrix(), idx_ref


def _find_stars(cal: torch.Tensor, center: torch.Tensor, std: torch.Tensor,
                config: PipelineConfig) -> Stars:
    """Registration-grade stars of calibrated frames (x / y / flux only).
    ``floor=center`` instead of ``cal - center``: the matched filter has
    no DC response, so no subtracted copy is made."""
    return find_stars(cal, fwhm=config.fwhm,
                      threshold=config.detect_nsigma * std,
                      max_stars=config.max_stars,
                      topk_mode=config.detect_topk,
                      mode="fast" if config.detect_fast else "exact",
                      stats=False, bin_rows=config.detect_bin_rows,
                      floor=center)


def _concat_stars(parts) -> Stars:
    return Stars(*(torch.cat(fields, dim=0) for fields in zip(*parts)))


def detect_calibrated(cal: torch.Tensor, config: PipelineConfig) -> Stars:
    """Stars tables (N, max_stars) of an (N, H, W) calibrated stack: the
    noise stats of the whole stack, then detection of all frames at once
    ('vmap') or ``detect_chunk`` frames at a time ('chunked')."""
    n = cal.shape[0]
    with span("apt.detect.noise"):
        center, std = frame_noise_stats(cal, center=config.noise_center)
    c = n
    if config.detect_mode == "chunked" and n > config.detect_chunk:
        c = config.detect_chunk
        if n % c:
            raise ValueError(f"frame count {n} not divisible by "
                             f"detect_chunk {c}")
    parts = []
    for k in range(0, n, c):
        with span("apt.detect.find"):
            parts.append(_find_stars(cal[k:k + c], center[k:k + c],
                                     std[k:k + c], config))
    return parts[0] if len(parts) == 1 else _concat_stars(parts)


def register_frames(cal: torch.Tensor,
                    config: PipelineConfig = PipelineConfig()):
    """Detect stars and solve every frame->reference similarity of an
    (N, H, W) CALIBRATED stack: the registration half of
    :func:`calibrate_register_stack`.

    Returns (stars, sims, matrices (N, 2, 3), ref_idx)."""
    with span("apt.detect"):
        stars = detect_calibrated(cal, config)
        count("detect.stars", _fewest_stars(stars))
    return (stars, *_register(stars, cal.shape[0], config))


def _fewest_stars(stars: Stars):
    """``detect.stars``: the valid stars of the frame with the fewest,
    read with the span records."""
    return lambda: int(stars.valid.sum(dim=1).min())


def _register(stars: Stars, n: int, config: PipelineConfig):
    """:func:`_solve_frame_similarities` as the span ``apt.register``,
    with ``register.inliers``: the distinct matched stars of the frame
    with the fewest, read with the span records."""
    with span("apt.register"):
        sims, matrices, ref_idx = _solve_frame_similarities(stars, n, config)
        inliers = sims.n_inliers
        count("register.inliers", lambda: int(inliers.min()))
    return sims, matrices, ref_idx


def band_matrices(matrices: torch.Tensor, y0: float) -> torch.Tensor:
    """The warp matrices of an output band starting at row ``y0``: output
    (x, y + y0) maps to input A @ (x, y + y0) + t, so A @ (0, y0) joins
    t, in float32 and in the reference's operation order."""
    out = matrices.clone()
    out[:, 0, 2] = matrices[:, 0, 2] + matrices[:, 0, 1] * y0
    out[:, 1, 2] = matrices[:, 1, 2] + matrices[:, 1, 1] * y0
    return out


_WARPS = {"lanczos3": warp_affine_lanczos3, "bilinear": warp_affine_bilinear}


def warp_band(cal: torch.Tensor, matrices: torch.Tensor, band_h: int,
              config: PipelineConfig):
    """(warped, weights), each (N, band_h, W): every frame warped onto
    one output band by ``config.interp``."""
    out_shape = (band_h, cal.shape[2])
    if config.interp == "separable":
        # analytic coverage: the combine masks coverage <= 0.5 anyway
        return warp_affine_separable(cal, matrices, out_shape,
                                     span=config.warp_span,
                                     analytic_coverage=True)
    if config.interp not in _WARPS:
        raise ValueError(f"unknown interp {config.interp!r}")
    return _WARPS[config.interp](cal, matrices, out_shape)


def combine_band(warped: torch.Tensor, weights: torch.Tensor,
                 config: PipelineConfig) -> torch.Tensor:
    """Sigma-clip combine one warped band: 'average' by ``clip_combine``
    (K3 on the card, its plain twin on the CPU) under 'xla' and 'pallas'
    alike, 'median' and 'sum' by ``sigma_clip_combine`` (K3 computes only
    the mean).  Pixels no frame covers are 0 (swarp weight-map
    semantics), not NaN."""
    mask = weights > 0.5
    if config.combine == "average":
        out = clip_combine(warped, mask=mask, sigma_lower=config.sigma_lower,
                           sigma_upper=config.sigma_upper)
    else:
        out = sigma_clip_combine(warped, mask=mask,
                                 sigma_lower=config.sigma_lower,
                                 sigma_upper=config.sigma_upper,
                                 method=config.combine)
    return torch.where(torch.isnan(out), 0.0, out)


@span("apt.stack", entry="unfused")
def calibrate_register_stack(
    frames: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dark: Optional[torch.Tensor] = None,
    flat: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    badpix_mask: Optional[torch.Tensor] = None,
    flux_scales: Optional[torch.Tensor] = None,
    config: PipelineConfig = PipelineConfig(),
):
    """Calibrate, register and sigma-clip stack an (N, H, W) light
    stack through a float32 calibrated stack.

    ``frames`` is a uint16 or float32 tensor; the work runs on its
    device, and the masters (H, W), ``exp_ratios`` (N,) and
    ``flux_scales`` (N,) (multiplying each calibrated frame: swarp's
    FSCALE) may be tensors on that device or numpy arrays.
    ``badpix_mask`` (H, W), True or non-zero = bad, repairs every
    calibrated frame by the median of the good pixels within +-2
    (``ops/badpix.fix_bad_pixels``) before detection.
    ``config.combine_impl`` is 'xla' or 'pallas', which share
    :func:`combine_band` (the K3 kernel for 'average'), or 'fused' (the
    warp+combine kernel on the calibrated stack); the non-fused paths warp
    ``config.n_bands`` horizontal bands one after another.

    Returns (stacked (H, W) float32, diagnostics dict of per-frame
    scale, theta, tx, ty, n_inliers, rms, n_stars, the reference frame
    index and the (N, 2, 3) matrices)."""
    if not isinstance(frames, torch.Tensor):
        raise TypeError("frames must be a torch.Tensor; its device is "
                        "where the pipeline runs")
    dev = frames.device
    with span("apt.calibrate"):
        bias, dark, flat = (on_device(m, dev, torch.float32)
                            for m in (bias, dark, flat))
        exp_ratios = on_device(exp_ratios, dev, torch.float32)
        flux_scales = on_device(flux_scales, dev, torch.float32)
        badpix_mask = on_device(badpix_mask, dev)
        cal = calibrate_batch(frames, bias, dark, flat, exp_ratios,
                              dark_still_biased=config.dark_still_biased,
                              badpix_mask=badpix_mask)
        if flux_scales is not None:
            cal = cal * flux_scales[:, None, None]

    stars, sims, matrices, ref_idx = register_frames(cal, config)
    return (stack_registered(cal, matrices, config),
            diagnostics(stars, sims, matrices, ref_idx))


def diagnostics(stars: Stars, sims: Similarity, matrices: torch.Tensor,
                ref_idx: int) -> dict:
    """The diagnostics dict of :func:`calibrate_register_stack` from what
    :func:`register_frames` returns."""
    return {
        "scale": sims.scale, "theta": sims.theta,
        "tx": sims.tx, "ty": sims.ty,
        "n_inliers": sims.n_inliers, "rms": sims.rms,
        "n_stars": stars.valid.sum(dim=1),
        "ref_frame": ref_idx,
        "matrices": matrices,
    }


def stack_registered(cal: torch.Tensor, matrices: torch.Tensor,
                     config: PipelineConfig = PipelineConfig()) -> torch.Tensor:
    """The stacking half of :func:`calibrate_register_stack`: warp an
    (N, H, W) calibrated stack by its (N, 2, 3) matrices and sigma-clip
    combine it, with the fused warp+combine kernel
    (``combine_impl='fused'``) or band by band (``config.n_bands``)."""
    _n, h, w = cal.shape
    if config.combine_impl == "fused":
        if config.n_bands > 1:
            raise ValueError("combine_impl='fused' subsumes banding; "
                             "use n_bands=1")
        return warp_combine(cal, matrices,
                            **lean_kernel_kwargs(config, h, w))

    n_bands = max(config.n_bands, 1)
    if h % n_bands:
        raise ValueError(f"height {h} not divisible by n_bands {n_bands}")
    band_h = h // n_bands
    bands = []
    for b in range(n_bands):
        with span("apt.warp", band=b):
            warped, weights = warp_band(
                cal, band_matrices(matrices, float(b * band_h)), band_h,
                config)
        with span("apt.combine", band=b):
            bands.append(combine_band(warped, weights, config))
        del warped, weights
    return torch.cat(bands, dim=0)


def lean_detect_fused(config: PipelineConfig, h: int, w: int) -> bool:
    """Whether the lean path detects an (H, W) stack with the fused
    raw->candidate kernel (K1): always under detect_impl='fused' (which
    raises where the geometry or the config does not allow it), under
    'auto' where they allow it and the frame has at least ``max_stars``
    tiles."""
    ok = _fused_detect_ok(config, h, w)
    if config.detect_impl == "fused" and not ok:
        raise ValueError("detect_impl='fused' needs detect_fast + "
                         "detect_bin_rows + detect_topk='tile' and "
                         "H % 64 == 0, W % 256 == 0")
    return (config.detect_impl == "fused"
            or (config.detect_impl == "auto" and ok
                and (h // 64) * (w // 256) >= config.max_stars))


def detect_lean(frames: torch.Tensor, bias, dark, flat,
                exp_ratios: torch.Tensor, config: PipelineConfig) -> Stars:
    """The lean path's Stars tables (N, max_stars) of a raw (N, H, W)
    stack: the fused raw->candidate kernel (K1) where the config and the
    geometry allow it, else calibration and ``find_stars`` chunk by chunk
    (at most ``detect_chunk`` calibrated frames exist at a time).  Every
    frame is detected on its own, so a frame-sharded caller gets the same
    rows."""
    n, h, w = frames.shape
    c = config.detect_chunk if config.detect_mode == "chunked" else n
    if n % c:
        raise ValueError(f"frame count {n} not divisible by chunk {c}")
    if lean_detect_fused(config, h, w):
        return _detect_stars_fused(frames, bias, dark, flat, exp_ratios,
                                   config)
    parts = []
    for k in range(0, n, c):
        with span("apt.detect.find"):
            calc = calibrate_batch(frames[k:k + c], bias, dark, flat,
                                   exp_ratios[k:k + c],
                                   dark_still_biased=config.dark_still_biased)
            ce, s = frame_noise_stats(calc, center=config.noise_center)
            parts.append(_find_stars(calc, ce, s, config))
            del calc
    return _concat_stars(parts)


def lean_masters(bias, dark, flat, config: PipelineConfig, h: int, w: int,
                 dev: torch.device) -> torch.Tensor:
    """The (3, H, W) calibration planes (A, B, C) on ``dev`` that the fused
    warp+combine kernel calibrates raw taps with (ones / zeros for a
    missing master)."""
    a_pl, b_pl, c_pl, _bias_t, _dark_use, _has = _calibration_planes(
        bias, dark, flat, config.dark_still_biased, h, w, dev)
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    zeros = torch.zeros((h, w), dtype=torch.float32, device=dev)
    return torch.stack([a_pl if a_pl is not None else ones,
                        b_pl if b_pl is not None else zeros,
                        c_pl if c_pl is not None else zeros])


def lean_kernel_kwargs(config: PipelineConfig, h: int, w: int) -> dict:
    """The fused warp+combine kernel's arguments under ``config`` for an
    (H, W) image.  Apron-free needs >= 3 tile blocks per axis: small
    frames have no memory pressure, so they keep the apron, and so does
    a frame that a given ``fused_tile`` cuts into fewer blocks on either
    axis (2048^2 in tiles of 320 x 1024)."""
    narrow = config.fused_tile is not None and (
        -(-h // config.fused_tile[0]) < 3 or -(-w // config.fused_tile[1]) < 3)
    return dict(span=config.warp_span, tile=config.fused_tile,
                sigma_lower=config.sigma_lower,
                sigma_upper=config.sigma_upper,
                apron=config.fused_apron or h < 96 or w < 768 or narrow,
                combine=config.combine, dither_budget=config.dither_budget,
                general_taps=config.general_taps)


@span("apt.stack", entry="lean")
def calibrate_register_stack_lean(
    frames: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dark: Optional[torch.Tensor] = None,
    flat: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    flux_scales: Optional[torch.Tensor] = None,
    config: PipelineConfig = PipelineConfig(),
):
    """Calibrate, register and sigma-clip stack a raw (N, H, W) light
    stack without ever holding a calibrated or warped stack.

    ``frames`` is a uint16 or float32 tensor; the work runs on its
    device, and the masters (H, W) (bias, dark, flat), ``exp_ratios``
    (N,) light/dark exposure ratios and ``flux_scales`` (N,) swarp-style
    FSCALE multipliers may be tensors on that device or numpy arrays.
    cal = raw*A - B - r*C with A=1/flat, B=bias/flat, C=dark_used/flat.
    ``config.combine`` is 'average', 'median', 'sum' or 'mean'.

    Returns (stacked (H, W) float32, diagnostics dict of per-frame
    scale, theta, tx, ty, n_inliers, rms, n_stars and the reference
    frame index)."""
    if not isinstance(frames, torch.Tensor):
        raise TypeError("frames must be a torch.Tensor; its device is "
                        "where the pipeline runs")
    dev = frames.device
    bias, dark, flat = (on_device(m, dev, torch.float32)
                        for m in (bias, dark, flat))
    n, h, w = frames.shape
    exp_ratios = torch.ones((n,), dtype=torch.float32, device=dev) \
        if exp_ratios is None else on_device(exp_ratios, dev, torch.float32)
    flux_scales = on_device(flux_scales, dev, torch.float32)

    with span("apt.detect"):
        stars = detect_lean(frames, bias, dark, flat, exp_ratios, config)
        count("detect.stars", _fewest_stars(stars))
    sims, matrices, ref_idx = _register(stars, n, config)
    with span("apt.masters"):
        masters = lean_masters(bias, dark, flat, config, h, w, dev)
    stacked = warp_combine(
        frames, matrices, masters=masters,
        exp_ratios=exp_ratios, flux_scales=flux_scales,
        **lean_kernel_kwargs(config, h, w))
    diagnostics = {
        "scale": sims.scale, "theta": sims.theta,
        "tx": sims.tx, "ty": sims.ty,
        "n_inliers": sims.n_inliers, "rms": sims.rms,
        "n_stars": stars.valid.sum(dim=1),
        "ref_frame": ref_idx,
    }
    return stacked, diagnostics
