"""The lean stacking pipeline: calibrate -> detect -> register -> warp ->
sigma-clip stack over a raw (N, H, W) light stack (the JAX package's
``models/pipeline.py:calibrate_register_stack_lean``).

The float32 calibrated stack never exists.  Detection runs the fused
raw->candidate kernel (``ops/detect_tiles``) with the calibration folded
in algebraically; registration solves every frame against the reference
from the star tables; the fused warp+combine kernel
(``ops/warp_combine``) calibrates raw taps on the fly.  Work runs on the
device of ``frames``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import on_device, to_float32
from ..ops.detect import Stars, _kernel_radius
from ..ops.detect_tiles import (_BIN, _TTX, _TTY, detect_tiles,
                                master_densities)
from ..ops.register import Similarity, estimate_similarity
from ..ops.warp_combine import warp_combine
from .config import PipelineConfig

#: where the unported detection paths are queued
_ROADMAP_ITEM = "ROADMAP.md, 'Remaining port work', item 1"


def _noise_row_stride(h: int) -> int:
    """Row stride of the noise-stat subsample: ~64 full rows on large
    frames, denser on small frames so tiny images keep a sample."""
    return max(8, min(64, h // 64))


def _sample_rows(x: torch.Tensor, st: int) -> torch.Tensor:
    """Every st-th row of an (..., H, W) tensor (a strided view)."""
    return x[..., ::st, :]


def _noise_stats_from_sub(sub: torch.Tensor, center: str):
    """(center, std) per row of an (N, M) float32 subsample: 3 rounds of
    mean/std clipping at 3 sigma (the 'mean' centre)."""
    if center == "median":
        raise NotImplementedError(
            "noise_center='median' needs sigma_clipped_stats, not ported "
            f"yet: {_ROADMAP_ITEM}")
    keep = torch.ones_like(sub, dtype=torch.bool)
    for _ in range(3):
        nk = torch.clamp(keep.sum(dim=1), min=1).to(torch.float32)
        cen = torch.where(keep, sub, 0.0).sum(dim=1) / nk
        var = torch.where(keep, (sub - cen[:, None]) ** 2, 0.0).sum(dim=1) / nk
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
    a_full, b_plane, c_plane, bias_t, dark_use, has_masters = \
        _calibration_planes(bias, dark, flat, config.dark_still_biased, h, w,
                            dev)

    # per-frame noise stats on calibrated SUBSAMPLED rows only
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

    mf = master_densities(bias_t, dark_use, flat, fwhm=config.fwhm) \
        if has_masters else None
    maxv, idxv, yoffv, xoffv = detect_tiles(
        frames, config.detect_nsigma * std, mf_bc=mf, a_plane=a_full,
        exp_ratios=exp_ratios, fwhm=config.fwhm)

    tx_n = maxv.shape[2]
    n_tiles = maxv.shape[1] * maxv.shape[2]
    k = min(config.max_stars, n_tiles)
    order = torch.sort(maxv.reshape(n, -1), dim=1, descending=True,
                       stable=True)
    top_vals, top_t = order.values[:, :k], order.indices[:, :k]
    if k < config.max_stars:
        # small frames have fewer tiles than the star capacity; pad
        pad = config.max_stars - k
        top_vals = torch.nn.functional.pad(top_vals, (0, pad), value=-3.0e38)
        top_t = torch.nn.functional.pad(top_t, (0, pad))
    valid = top_vals > -1.0e37
    loc = torch.gather(idxv.reshape(n, -1), 1, top_t).long()
    rb = (top_t // tx_n) * _TTY + loc // _TTX      # binned peak row
    py = rb * _BIN
    px = (top_t % tx_n) * _TTX + loc % _TTX
    zero = torch.zeros((n, config.max_stars), dtype=torch.float32, device=dev)

    if config.centroid == "kernel":
        # the detector's calibrated parabola offsets (binned rows /
        # full-res columns); binned row b covers rows 2b..2b+1
        yo = torch.gather(yoffv.reshape(n, -1), 1, top_t)
        xo = torch.gather(xoffv.reshape(n, -1), 1, top_t)
        cx = px.to(torch.float32) + xo
        cy = (rb.to(torch.float32) + yo) * _BIN + 0.5
    else:
        cx, cy = _com_centroids(frames, py, px, ce, exp_ratios, a_full,
                                b_plane, c_plane, _kernel_radius(config.fwhm))
    return Stars(x=torch.where(valid, cx, zero), y=torch.where(valid, cy, zero),
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
        return int(torch.argmax(stars.valid.sum(dim=1)))
    n = stars.valid.shape[0]
    idx = int(config.ref_frame)
    if not -n <= idx < n:
        raise ValueError(f"ref_frame {idx} out of range for {n} frames")
    return idx % n


def _solve_frame_similarities(stars: Stars, n: int, config: PipelineConfig):
    """Reference choice, every frame's similarity solve, and the exact
    identity for the reference.  Returns (sims, matrices (N, 2, 3),
    ref index)."""
    idx_ref = _ref_index(stars, config)
    sims = estimate_similarity(
        stars.x[idx_ref], stars.y[idx_ref], stars.flux[idx_ref],
        stars.valid[idx_ref], stars.x, stars.y, stars.flux, stars.valid,
        k=config.match_k)
    ident = (1.0, 0.0, 0.0, 0.0, config.max_stars, 0.0)
    fields = []
    for v, idv in zip(sims, ident):
        v = v.clone()
        v[idx_ref] = idv
        fields.append(v)
    sims = Similarity(*fields)
    return sims, sims.matrix(), idx_ref


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
    c = config.detect_chunk if config.detect_mode == "chunked" else n
    if n % c:
        raise ValueError(f"frame count {n} not divisible by chunk {c}")
    exp_ratios = torch.ones((n,), dtype=torch.float32, device=dev) \
        if exp_ratios is None else on_device(exp_ratios, dev, torch.float32)
    flux_scales = on_device(flux_scales, dev, torch.float32)

    ok = _fused_detect_ok(config, h, w)
    if config.detect_impl == "fused" and not ok:
        raise ValueError("detect_impl='fused' needs detect_fast + "
                         "detect_bin_rows + detect_topk='tile' and "
                         "H % 64 == 0, W % 256 == 0")
    use_fused = (config.detect_impl == "fused"
                 or (config.detect_impl == "auto" and ok
                     and (h // 64) * (w // 256) >= config.max_stars))
    if not use_fused:
        raise NotImplementedError(
            "only the fused detector is ported; detect_impl='chunked' (or "
            "'auto' on a geometry the fused detector cannot take) is "
            f"queued: {_ROADMAP_ITEM}")
    stars = _detect_stars_fused(frames, bias, dark, flat, exp_ratios, config)
    sims, matrices, ref_idx = _solve_frame_similarities(stars, n, config)

    a_pl, b_pl, c_pl, _bias_t, _dark_use, _has = _calibration_planes(
        bias, dark, flat, config.dark_still_biased, h, w, dev)
    ones = torch.ones((h, w), dtype=torch.float32, device=dev)
    zeros = torch.zeros((h, w), dtype=torch.float32, device=dev)
    masters = torch.stack([a_pl if a_pl is not None else ones,
                           b_pl if b_pl is not None else zeros,
                           c_pl if c_pl is not None else zeros])
    apron = config.fused_apron or h < 96 or w < 768
    stacked = warp_combine(
        frames, matrices, masters=masters, exp_ratios=exp_ratios,
        flux_scales=flux_scales, span=config.warp_span,
        tile=config.fused_tile, sigma_lower=config.sigma_lower,
        sigma_upper=config.sigma_upper, apron=apron, combine=config.combine,
        dither_budget=config.dither_budget, general_taps=config.general_taps)
    diagnostics = {
        "scale": sims.scale, "theta": sims.theta,
        "tx": sims.tx, "ty": sims.ty,
        "n_inliers": sims.n_inliers, "rms": sims.rms,
        "n_stars": stars.valid.sum(dim=1),
        "ref_frame": ref_idx,
    }
    return stacked, diagnostics
