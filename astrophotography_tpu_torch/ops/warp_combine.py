"""Fused calibrate + Lanczos3 warp + sigma-clip combine (the
counterpart of the JAX package's ``ops/pallas_warp_combine.py``).

Every frame is calibrated on the fly (cal = (raw*A - B - r*C) * fscale,
or raw * fscale for pre-calibrated input), resampled onto the reference
grid by a separable two-pass Lanczos3 with polynomial weights, and the
N samples of each output pixel are sigma-clip combined — no calibrated
or warped stack is ever stored.

The TPU kernel streams each output tile's source through a window
shared by all frames; which frames a tile may use depends on that
window's quantisation (``base_ok``), and the lowrank and span gates
depend on the tile size.  The port keeps that geometry exactly — the
same auto tile, delivery blocks, window extents, median-centred window
origins and translation snap — and folds it into two small tables:

* per frame (N, 16) float32: columns 0-10 are the TPU kernel's (N, 11)
  table (the snapped 2x3 matrix, exp ratio, flux scale, translation
  flag, source-row bounds), then gx, gy, g0 of the separable
  decomposition and the frame's span / lowrank gate;
* per (frame, tile) (N, n_ti * n_tj, 3) int32: the tap-range bases
  vbase, ubase and base_ok.

Taps outside the image read zero (the TPU kernel's zero apron); for a
covered pixel every tap with non-zero weight is inside the image or the
apron, so the two agree.  :func:`warp_combine` runs the hand-written
CUDA kernel (``csrc/warp_combine.cu``) on CUDA tensors and
:func:`warp_combine_plain` on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..device import numpy_inputs, to_float32
from ..utils.timing import annotate, count, span as _span
from .warp import lanczos3_poly

_MAD_TO_STD = 1.482602218505602
#: sentinel of an uncovered (frame, pixel) sample
_BIG = 3.4e38
_COMBINES = ("average", "median", "sum", "mean")
_SP_EPS = 0.01


class WarpPlan(NamedTuple):
    """Geometry and tables shared by the kernel and its plain twin."""

    th: int
    tw: int
    bh: int
    bw: int
    vb: int
    hb: int
    n_ti: int
    n_tj: int
    span: int
    byp: torch.Tensor     # (n_ti, n_tj) int32 window origin, padded blocks
    bxp: torch.Tensor
    table: torch.Tensor   # (N, 16) float32
    tiles: torch.Tensor   # (N, n_ti * n_tj, 3) int32: vbase, ubase, base_ok


def _auto_tile(n: int, w0: int) -> Tuple[int, int]:
    """The TPU kernel's auto tile (its VMEM budget picks the height)."""
    tw = 1024 if w0 >= 3072 else (512 if w0 >= 1536 else 256)
    budget = 27_000_000 if tw >= 1024 else 23_000_000
    cap = 64 if tw >= 1024 else 112
    th = min(cap, max(16, (budget // (max(n, 1) * tw * 4)) // 8 * 8))
    return th, tw


def _block_div(th: int, tw: int) -> Tuple[int, int]:
    """The TPU kernel's auto delivery-block split of a tile."""
    if tw >= 1024 and tw % 256 == 0:
        ky, kx = (2, 2) if th % 32 == 0 else (1, 2)
    else:
        ky, kx = 1, 1
    if th % ky or (ky > 1 and (th // ky) % 16):
        raise ValueError(f"block_div {(ky, kx)}: tile height {th} must "
                         f"split into multiples of 16")
    if tw % kx or (kx > 1 and (tw // kx) % 128):
        raise ValueError(f"block_div {(ky, kx)}: tile width {tw} must "
                         f"split into multiples of 128")
    return ky, kx


def _bases(m6: torch.Tensor, ti: torch.Tensor, tj: torch.Tensor,
           th: int, tw: int, span: int):
    """Per-(frame, tile) tap-range bases vbase, ubase (the TPU kernel's
    ``_frame_bases``, vectorised); ``ti``/``tj`` are the tiles' first
    output row / column as float32, broadcastable against (N, 1, 1)."""
    m10, m11, m12 = (m6[:, k, None, None] for k in (3, 4, 5))
    inv_m11 = 1.0 / m11
    gx = m6[:, 0, None, None] - m6[:, 1, None, None] * m10 * inv_m11
    gy = m6[:, 1, None, None] * inv_m11
    g0 = m6[:, 2, None, None] - m6[:, 1, None, None] * m12 * inv_m11
    vmin = None
    for dy in (0.0, th - 1.0):
        for dx in (0.0, tw - 1.0):
            cand = m10 * (tj + dx) + m11 * (ti + dy) + m12
            vmin = cand if vmin is None else torch.minimum(vmin, cand)
    umin = None
    for dy in (-3.0, float(th + span)):
        for dx in (0.0, tw - 1.0):
            cand = gx * (tj + dx) + gy * (vmin + dy) + g0
            umin = cand if umin is None else torch.minimum(umin, cand)
    vbase = torch.floor(vmin).to(torch.int32) - 3
    ubase = torch.floor(umin).to(torch.int32) - 3
    return vbase, ubase


def _median_int(x: torch.Tensor) -> torch.Tensor:
    """Median over axis 0 of an int tensor as jnp.median(...).astype(
    int32) gives it: the mean of the two middle values for an even
    count, truncated toward zero."""
    s = torch.sort(x, dim=0).values
    n = x.shape[0]
    mid = (s[(n - 1) // 2].to(torch.float64) + s[n // 2].to(torch.float64)) / 2
    return torch.trunc(mid).to(torch.int32)


def _vector(x, size: int, name: str, device) -> torch.Tensor:
    """``x`` as a (size,) float32 tensor on ``device``."""
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    if tuple(t.shape) != (size,):
        raise ValueError(f"{name} must have shape ({size},), got "
                         f"{tuple(t.shape)}")
    return t


@numpy_inputs("matrices", "exp_ratios", "flux_scales", "v_bounds", "snap_geom")
def plan_warp_combine(
    shape: Tuple[int, int, int],
    matrices: torch.Tensor,
    exp_ratios: Optional[torch.Tensor] = None,
    flux_scales: Optional[torch.Tensor] = None,
    tile: "Tuple[int, int] | None" = None,
    span: int = 12,
    apron: bool = True,
    dither_budget: int = 64,
    snap_tol: float = 0.05,
    general_taps: str = "exact",
    v_bounds: Optional[torch.Tensor] = None,
    snap_geom: Optional[torch.Tensor] = None,
) -> WarpPlan:
    """Host prep of the warp+combine: the TPU kernel's tile, delivery
    blocks, window extents and origins, translation snap and tables,
    ported exactly (see the module docstring).  ``matrices`` (N, 2, 3)
    output->source maps; the tables land on its device.  ``v_bounds``
    (2,) = (vlo, vhi) source-row coverage bounds (default (2, H - 4)) and
    ``snap_geom`` (4,) = (cx, cy, rx, ry), the snap centre and
    half-extents (default the frame's centre twice), let a caller that
    works on a row band keep the whole image's coverage and snap."""
    if general_taps not in ("exact", "lowrank"):
        raise ValueError(f"unknown general_taps '{general_taps}'")
    if general_taps == "lowrank" and not snap_tol > 0.0:
        raise ValueError("general_taps='lowrank' needs snap_tol > 0 "
                         "(it bounds the committed drift; with 0 every "
                         "non-translation frame would be excluded)")
    if general_taps == "lowrank" and span <= 7:
        raise ValueError(f"general_taps='lowrank' needs span > 7, got "
                         f"{span}: its gate su_lr <= min(span, 9) - 7 "
                         f"cannot hold there, so every frame that is not a "
                         f"pure translation would be excluded")
    n, h0, w0 = shape
    dev = matrices.device
    th, tw = _auto_tile(n, w0) if tile is None else tile
    if th <= span:
        raise ValueError("tile height must exceed span")
    ky, kx = _block_div(th, tw)
    bh, bw = th // ky, tw // kx
    ph, pw = (-h0) % th, (-w0) % tw
    h, w = h0 + ph, w0 + pw
    n_ti, n_tj = h // th, w // tw
    if apron:
        npi = (h + 4 * th) // bh
        npj = (w + 2 * tw) // bw
        oy, ox = (2 * th) // bh, tw // bw
    else:
        if n_ti < 3 or n_tj < 3:
            raise ValueError("apron-free mode needs >= 3 tile blocks "
                             "per axis; use apron=True or smaller tiles")
        npi, npj = h // bh, w // bw
        oy, ox = 0, 0
    # window extents (delivery blocks): taps + block quantisation +
    # twice the guaranteed dither spread, capped at the padded image
    thp = -(-(th + span) // 8) * 8
    twp = -(-(tw + span) // 128) * 128
    vb = max(-(-(thp + bh - 1 + 2 * dither_budget) // bh), -(-thp // bh))
    hb = max(-(-(tw + span + bw - 1 + 2 * dither_budget) // bw),
             -(-twp // bw))
    vb = min(vb, max(npi, -(-thp // bh)))
    hb = min(hb, max(npj, -(-twp // bw)))

    m6 = matrices.reshape(n, 6).to(torch.float32)
    if snap_tol > 0.0:
        # a frame within snap_tol px of a pure translation everywhere on
        # the grid is replaced by that translation (scalar-weight taps)
        if snap_geom is None:
            cx = float((w0 - 1) * 0.5)
            cy = float((h0 - 1) * 0.5)
            rx, ry = cx, cy
        else:
            cx, cy, rx, ry = _vector(snap_geom, 4, "snap_geom", dev).unbind(0)
        err_u = (m6[:, 0] - 1.0).abs() * rx + m6[:, 1].abs() * ry
        err_v = m6[:, 3].abs() * rx + (m6[:, 4] - 1.0).abs() * ry
        is_t = torch.maximum(err_u, err_v) < snap_tol
        tx = m6[:, 0] * cx + m6[:, 1] * cy + m6[:, 2] - cx
        ty = m6[:, 3] * cx + m6[:, 4] * cy + m6[:, 5] - cy
        ones, zeros = torch.ones_like(tx), torch.zeros_like(tx)
        snapped = torch.stack([ones, zeros, tx, zeros, ones, ty], dim=1)
        m6 = torch.where(is_t[:, None], snapped, m6)
        trans = is_t.to(torch.float32)
    else:
        trans = torch.zeros((n,), dtype=torch.float32, device=dev)
    ones_n = torch.ones((n,), dtype=torch.float32, device=dev)
    er = ones_n if exp_ratios is None else exp_ratios.to(torch.float32)
    fs = ones_n if flux_scales is None else flux_scales.to(torch.float32)

    # separable decomposition and the per-frame tap-body gates
    inv_m11 = 1.0 / m6[:, 4]
    gx = m6[:, 0] - m6[:, 1] * m6[:, 3] * inv_m11
    gy = m6[:, 1] * inv_m11
    g0 = m6[:, 2] - m6[:, 1] * m6[:, 5] * inv_m11
    sv_sh = m6[:, 3].abs() * (tw - 1.0) + (m6[:, 4] - 1.0).abs() * (th - 1.0)
    span_ok_v = sv_sh <= span - 7.0 - _SP_EPS
    if general_taps == "exact":
        su_ex = gy.abs() * (thp - 1.0) + (gx - 1.0).abs() * (tw - 1.0)
        gate = span_ok_v & (su_ex <= span - 7.0 - _SP_EPS)
    else:
        t1hi = min(span, 9)
        su_lr = gy.abs() * (thp - 1.0) + (gx - 1.0).abs() * ((tw - 1) * 0.5)
        gate = (((gx - 1.0).abs() * ((tw - 1) * 0.5) < snap_tol)
                & ((m6[:, 4] - 1.0).abs() * ((th - 1) * 0.5) < snap_tol)
                & (su_lr <= t1hi - 7.0 - _SP_EPS) & span_ok_v)
    if v_bounds is None:
        vlo, vhi = torch.full_like(er, 2.0), torch.full_like(er, h0 - 4.0)
    else:
        vlo, vhi = (b.expand(n) for b in
                    _vector(v_bounds, 2, "v_bounds", dev).unbind(0))
    table = torch.stack(
        [*m6.unbind(1), er, fs, trans, vlo, vhi,
         gx, gy, g0, gate.to(torch.float32), torch.zeros_like(er)], dim=1)

    # per-(frame, tile) bases and the shared windows' containment test
    ti = (torch.arange(n_ti, dtype=torch.float32, device=dev) * th)[None, :, None]
    tj = (torch.arange(n_tj, dtype=torch.float32, device=dev) * tw)[None, None, :]
    vbase, ubase = _bases(m6, ti, tj, th, tw, span)
    margin_y = max((vb * bh - thp - (bh - 1)) // 2, 0)
    margin_x = max((hb * bw - (tw + span) - (bw - 1)) // 2, 0)
    byp = torch.clamp(torch.div(_median_int(vbase) - margin_y, bh,
                                rounding_mode="floor") + oy, 0, npi - vb)
    bxp = torch.clamp(torch.div(_median_int(ubase) - margin_x, bw,
                                rounding_mode="floor") + ox, 0, npj - hb)
    byp, bxp = byp.to(torch.int32), bxp.to(torch.int32)
    win_y0 = (byp - oy) * bh
    win_x0 = (bxp - ox) * bw
    base_ok = ((win_y0 <= torch.clamp(vbase, min=0))
               & (torch.clamp(vbase + th + span, max=h0) <= win_y0 + vb * bh)
               & (win_x0 <= torch.clamp(ubase, min=0))
               & (torch.clamp(ubase + tw + span, max=w0) <= win_x0 + hb * bw))
    tiles = torch.stack([vbase, ubase, base_ok.to(torch.int32)], dim=-1) \
        .reshape(n, n_ti * n_tj, 3).to(torch.int32).contiguous()
    return WarpPlan(th, tw, bh, bw, vb, hb, n_ti, n_tj, span, byp, bxp,
                    table.contiguous(), tiles)


def _validate(frames, matrices, masters, combine):
    if combine not in _COMBINES:
        raise ValueError(f"unknown combine '{combine}'")
    if frames.dim() != 3:
        raise ValueError(f"frames must be (N, H, W), got {tuple(frames.shape)}")
    n, h0, w0 = frames.shape
    if tuple(matrices.shape) != (n, 2, 3):
        raise ValueError(f"matrices must be ({n}, 2, 3), got "
                         f"{tuple(matrices.shape)}")
    if masters is not None and tuple(masters.shape) != (3, h0, w0):
        raise ValueError(f"masters must be (3, {h0}, {w0}), got "
                         f"{tuple(masters.shape)}")


def _warp_frame_plain(cal: torch.Tensor, f: int, plan: WarpPlan,
                      general_taps: str) -> torch.Tensor:
    """Warped frame ``f`` (H, W) with +3.4e38 where it does not cover."""
    h0, w0 = cal.shape
    dev = cal.device
    th, tw, span = plan.th, plan.tw, plan.span
    (m00, m01, m02, m10, m11, m12, _er, _fs, trans, vlo, vhi,
     gx, gy, g0, gate, _pad) = plan.table[f].unbind(0)
    ys = torch.arange(h0, device=dev)[:, None]
    xs = torch.arange(w0, device=dev)[None, :]
    ti_i, tj_i = ys // th, xs // tw
    rr_i, cc_i = ys - ti_i * th, xs - tj_i * tw
    rr, cc = rr_i.to(torch.float32), cc_i.to(torch.float32)
    y_out, x_out = ys.to(torch.float32), xs.to(torch.float32)
    ti_f, tj_f = (ti_i * th).to(torch.float32), (tj_i * tw).to(torch.float32)
    tab = plan.tiles[f].reshape(plan.n_ti, plan.n_tj, 3)[ti_i, tj_i]
    vbase, ubase, base_ok = tab[..., 0].long(), tab[..., 1].long(), tab[..., 2] > 0
    vb_f, ub_f = vbase.to(torch.float32), ubase.to(torch.float32)
    flat = cal.reshape(-1)

    def img(rows, cols):
        inside = (rows >= 0) & (rows < h0) & (cols >= 0) & (cols < w0)
        idx = rows.clamp(0, h0 - 1) * w0 + cols.clamp(0, w0 - 1)
        return torch.where(inside, flat[idx], 0.0)

    v = m10 * x_out + m11 * y_out + m12
    sx = m00 * x_out + m01 * y_out + m02
    cover = ((sx >= 2.0) & (sx <= w0 - 4.0) & (v >= vlo) & (v <= vhi)
             & base_ok)
    zero = torch.zeros((h0, w0), dtype=torch.float32, device=dev)
    if bool(trans > 0.5):
        # snapped translation: scalar weights per (frame, tile)
        # the snapped base anchoring puts a_u, a_v in [3, 4): taps 0 and
        # >= 7 carry exactly zero weight
        taps = range(1, min(span, 7)) if span >= 7 else range(0, span)
        a_u = tj_f + g0 - ub_f
        ws = [lanczos3_poly(a_u - s) for s in taps]
        wsum = sum(ws[1:], ws[0])
        inv = torch.where(wsum.abs() > 1e-3, 1.0 / wsum, 0.0)
        a_v = ti_f + m12 - vb_f
        ws2 = [lanczos3_poly(a_v - s) for s in taps]
        wsum2 = sum(ws2[1:], ws2[0])
        inv2 = torch.where(wsum2.abs() > 1e-3, 1.0 / wsum2, 0.0)
        warped = zero
        for k, s in enumerate(taps):
            mid = zero
            for k2, s2 in enumerate(taps):
                mid = mid + (ws[k2] * inv) * img(vbase + rr_i + s,
                                                 ubase + cc_i + s2)
            warped = warped + (ws2[k] * inv2) * mid
    else:
        # The horizontal pass of output row rr at vertical tap s is the
        # tile's mid row q = rr + s (source row vbase + q), so each mid row
        # is computed once per tile (the TPU kernel's order): mid[i, q, x]
        # for the tile row i of column x's tile.  (rr + s) and q are the
        # same exact float, so the values are those of a pass per pixel.
        n_q = th + span
        q_i = torch.arange(n_q, device=dev)[None, :, None]
        q = q_i.to(torch.float32)
        tab_q = plan.tiles[f].reshape(plan.n_ti, plan.n_tj, 3)[:, tj_i[0]]
        vb_q, ub_q = tab_q[:, None, :, 0].long(), tab_q[:, None, :, 1].long()
        vbq_f, ubq_f = vb_q.to(torch.float32), ub_q.to(torch.float32)
        zero_q = torch.zeros((plan.n_ti, n_q, w0), dtype=torch.float32,
                             device=dev)
        if general_taps == "lowrank":
            t1hi = min(span, 9)
            bu = (gx * tj_f + gy * (vbq_f + q) + g0 - ubq_f
                  + (gx - 1.0) * ((tw - 1) * 0.5))
            acc0, w0s = zero_q, zero_q
            for s2 in range(1, t1hi):
                wt = lanczos3_poly(bu - s2)
                acc0 = acc0 + wt * img(vb_q + q_i, ub_q + cc_i + s2)
                w0s = w0s + wt
            mid_q = acc0 * torch.where(w0s.abs() > 1e-3, 1.0 / w0s, 0.0)
        else:
            u_loc = gx * x_out + gy * (vbq_f + q) + g0 - ubq_f
            acc, wsum = zero_q, zero_q
            for s2 in range(span):
                wt = lanczos3_poly(u_loc - (cc + s2))
                acc = acc + wt * img(vb_q + q_i, ub_q + cc_i + s2)
                wsum = wsum + wt
            safe = wsum.abs() > 1e-3
            mid_q = torch.where(safe, acc / torch.where(safe, wsum, 1.0), 0.0)
        mid_q = mid_q.reshape(plan.n_ti * n_q, w0)
        first = (ti_i * n_q + rr_i).reshape(-1)

        def mid(s):
            return mid_q.index_select(0, first + s)

        if general_taps == "lowrank":
            bv = (m10 * x_out + m11 * ti_f + m12 - vb_f
                  + (m11 - 1.0) * ((th - 1) * 0.5))
            acc2, v0s = zero, zero
            for s in range(1, span):
                wt = lanczos3_poly(bv - s)
                acc2 = acc2 + wt * mid(s)
                v0s = v0s + wt
            warped = acc2 * torch.where(v0s.abs() > 1e-3, 1.0 / v0s, 0.0)
        else:
            v_loc = v - vb_f
            acc2, wsum2 = zero, zero
            for s in range(span):
                wt = lanczos3_poly(v_loc - (rr + s))
                acc2 = acc2 + wt * mid(s)
                wsum2 = wsum2 + wt
            safe2 = wsum2.abs() > 1e-3
            warped = torch.where(safe2,
                                 acc2 / torch.where(safe2, wsum2, 1.0), 0.0)
        cover = cover & (gate > 0.5)
    return torch.where(cover, warped, _BIG)


def _combine_plain(vals: torch.Tensor, combine: str, sigma_lower: float,
                   sigma_upper: float) -> torch.Tensor:
    """Per-pixel sigma-clip combine of (N, H, W) samples (+3.4e38 =
    uncovered), as the kernel computes it: median and MAD over the valid
    samples, clip at med -/+ sigma * 1.4826 * MAD, then the mean, median
    or sum of the kept samples (summed in ascending order).  'mean' is
    the coverage-weighted mean without clipping, summed in frame order.
    Pixels with nothing kept are 0."""
    n = vals.shape[0]
    half_big = _BIG * 0.5
    valid = vals < half_big
    count = valid.sum(dim=0)
    if combine == "mean":
        acc = torch.zeros_like(vals[0])
        for f in range(n):
            acc = acc + torch.where(valid[f], vals[f], 0.0)
        countf = count.to(torch.float32)
        return torch.where(count > 0, acc / countf.clamp(min=1.0), 0.0)
    srt = torch.sort(vals, dim=0).values
    lo = torch.div(count - 1, 2, rounding_mode="floor").clamp(min=0)[None]
    hi = torch.div(count, 2, rounding_mode="floor").clamp(min=0)[None]
    med = 0.5 * (srt.gather(0, lo) + srt.gather(0, hi))[0]
    devs = torch.sort((srt - med).abs(), dim=0).values
    std = (_MAD_TO_STD * 0.5) * (devs.gather(0, lo) + devs.gather(0, hi))[0]
    lo_b = med - sigma_lower * std
    hi_b = med + sigma_upper * std
    acc = torch.zeros_like(med)
    cnt = torch.zeros_like(med)
    below = torch.zeros_like(count)
    for k in range(n):
        v = srt[k]
        ok = v < half_big
        keep = ok & (v >= lo_b) & (v <= hi_b)
        acc = acc + torch.where(keep, v, 0.0)
        cnt = cnt + keep.to(torch.float32)
        below = below + (ok & (v < lo_b)).to(below.dtype)
    if combine == "median":
        cnti = cnt.to(below.dtype)
        klo = (below + torch.div(cnti - 1, 2, rounding_mode="floor")
               .clamp(min=0)).clamp(max=n - 1)[None]
        khi = (below + torch.div(cnti, 2, rounding_mode="floor")
               .clamp(min=0)).clamp(max=n - 1)[None]
        out = 0.5 * (srt.gather(0, klo) + srt.gather(0, khi))[0]
    elif combine == "sum":
        out = acc
    else:
        out = acc / cnt.clamp(min=1.0)
    return torch.where(cnt > 0, out, 0.0)


def combine_by_runs(vals: torch.Tensor, combine: str, sigma_lower: float,
                    sigma_upper: float, run: int) -> torch.Tensor:
    """One pixel's combine as K2's 'cols' route takes it past its reach
    (``combine_runs`` in csrc/warp_combine.cu); a plain statement of the
    rule for the tests, used by no path.

    ``vals`` (N,) holds the pixel's samples in frame order (+3.4e38 =
    uncovered).  The column is cut into runs of ``run`` samples, each
    sorted; every rank is the key bisected over the runs (the smallest
    key with more than k samples at or below it), the MAD's over the
    deviations; the kept samples are summed in ascending order in chunks:
    the samples whose key is below t, the key at the chunk's last rank
    (fewer than ``run``, gathered and sorted), then the samples equal to
    t one after another.  Returns the 0-dim result, the same as
    :func:`_combine_plain` on the column."""
    from .clip_combine import float_keys, float_of_keys, rank_by_bisection

    n = vals.shape[0]
    col = torch.cat([torch.sort(vals[i:i + run]).values
                     for i in range(0, n, run)]).to(torch.float32)
    keys = float_keys(col)
    zero = torch.zeros((), dtype=torch.float32)

    def rank(values, k):
        return rank_by_bisection(values[:, None], torch.tensor([k]))[0]

    covered = col < _BIG
    count = int(covered.sum())
    if count == 0 or combine == "mean":
        raise ValueError("combine_by_runs states the clipped combines of a "
                         "covered pixel")
    lo, hi = max((count - 1) // 2, 0), count // 2
    med = 0.5 * (rank(col, lo) + rank(col, hi))
    dev = (col - med).abs()
    std = (_MAD_TO_STD * 0.5) * (rank(dev, lo) + rank(dev, hi))
    lo_b = med - sigma_lower * std
    hi_b = med + sigma_upper * std
    kept = covered & (col >= lo_b) & (col <= hi_b)
    below = int((covered & (col < lo_b)).sum())
    cnt = int(kept.sum())
    if cnt == 0:
        return zero
    if combine == "median":
        return 0.5 * (rank(col, below + max((cnt - 1) // 2, 0))
                      + rank(col, below + cnt // 2))
    acc, left = zero, kept
    while bool(left.any()):
        rank0 = int((keys < keys[left].min()).sum())
        if int(left.sum()) <= run:
            for v in torch.sort(col[left]).values:
                acc = acc + v
            break
        t = torch.sort(keys).values[rank0 + run - 1]
        for v in torch.sort(col[left & (keys < t)]).values:
            acc = acc + v
        vt = float_of_keys(t)
        for _ in range(int((keys == t).sum())):
            acc = acc + vt
        left = left & (keys > t)
    return acc if combine == "sum" else acc / float(cnt)


def _calibrated(frames, masters, plan: WarpPlan, f: int) -> torch.Tensor:
    er, fs = plan.table[f, 6], plan.table[f, 7]
    raw = to_float32(frames[f])
    if masters is None:
        return raw * fs
    return (raw * masters[0] - masters[1] - er * masters[2]) * fs


#: the most bytes of samples the plain combine takes at once: it works
#: on bands of rows (each pixel's result is its own), so that its sorts
#: of a deep stack fit the card
_PLAIN_BAND_BYTES = 1 << 30


def _run_plain(frames, masters, plan, combine, sigma_lower, sigma_upper,
               general_taps):
    n, h, w = frames.shape
    vals = torch.empty(frames.shape, dtype=torch.float32,
                       device=frames.device)
    for f in range(n):
        vals[f] = _warp_frame_plain(_calibrated(frames, masters, plan, f), f,
                                    plan, general_taps)
    rows = max(1, _PLAIN_BAND_BYTES // (4 * n * w))
    if rows >= h:
        return _combine_plain(vals, combine, float(sigma_lower),
                              float(sigma_upper))
    out = torch.empty((h, w), dtype=torch.float32, device=frames.device)
    for r0 in range(0, h, rows):
        out[r0:r0 + rows] = _combine_plain(
            vals[:, r0:r0 + rows], combine, float(sigma_lower),
            float(sigma_upper))
    return out


@numpy_inputs("frames", "matrices", "masters", "exp_ratios", "flux_scales", "v_bounds", "snap_geom")
def warp_combine_plain(
    frames: torch.Tensor,
    matrices: torch.Tensor,
    masters: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    flux_scales: Optional[torch.Tensor] = None,
    tile: "Tuple[int, int] | None" = None,
    span: int = 12,
    sigma_lower: float = 5.0,
    sigma_upper: float = 5.0,
    apron: bool = True,
    combine: str = "average",
    dither_budget: int = 64,
    snap_tol: float = 0.05,
    general_taps: str = "exact",
    v_bounds: Optional[torch.Tensor] = None,
    snap_geom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch twin of the warp+combine kernel, on any device
    (one warped (H, W) frame at a time, then the combine over the
    (N, H, W) samples).  Same arguments and result as
    :func:`warp_combine`."""
    _validate(frames, matrices, masters, combine)
    plan = plan_warp_combine(frames.shape, matrices, exp_ratios, flux_scales,
                             tile=tile, span=span, apron=apron,
                             dither_budget=dither_budget, snap_tol=snap_tol,
                             general_taps=general_taps, v_bounds=v_bounds,
                             snap_geom=snap_geom)
    masters = None if masters is None else masters.to(torch.float32)
    return _run_plain(frames, masters, plan, combine, sigma_lower,
                      sigma_upper, general_taps)


def frame_tiles_used(plan: WarpPlan) -> torch.Tensor:
    """The (frame, tile) pairs the kernel combines, by its own rule
    (``kind_of`` in csrc/warp_combine.cu): the tile's window holds the
    frame's taps (``base_ok``) and the frame is a snapped translation or
    passes its tap-body gate.  A 0-dim tensor on the plan's device."""
    body = (plan.table[:, 8] > 0.5) | (plan.table[:, 14] > 0.5)
    return ((plan.tiles[..., 2] != 0) & body[:, None]).sum()


@_span("apt.warp_combine")
@numpy_inputs("frames", "matrices", "masters", "exp_ratios", "flux_scales", "v_bounds", "snap_geom")
def warp_combine(
    frames: torch.Tensor,
    matrices: torch.Tensor,
    masters: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    flux_scales: Optional[torch.Tensor] = None,
    tile: "Tuple[int, int] | None" = None,
    span: int = 12,
    sigma_lower: float = 5.0,
    sigma_upper: float = 5.0,
    apron: bool = True,
    combine: str = "average",
    dither_budget: int = 64,
    snap_tol: float = 0.05,
    general_taps: str = "exact",
    v_bounds: Optional[torch.Tensor] = None,
    snap_geom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Warp every frame by its matrix and sigma-clip-combine, fused,
    calibrating raw frames on the fly.

    ``frames`` (N, H, W) float32 calibrated frames, or raw uint16 /
    float32 when ``masters`` (3, H, W) = (A=1/flat, B=bias/flat,
    C=dark/flat) is given, so cal = raw*A - B - exp_ratio*C;
    ``matrices`` (N, 2, 3) output->source affine maps; ``exp_ratios``
    and ``flux_scales`` (N,) (default 1; the flux scale multiplies the
    calibrated value).  ``combine``: 'average' (sigma-clipped mean),
    'median' (median of the kept samples), 'sum' (sum of the kept
    samples) or 'mean' (no clipping).  ``tile``, ``span``, ``apron``,
    ``dither_budget``, ``snap_tol`` and ``general_taps`` have the JAX
    kernel's meaning and decide the same coverage (see
    :func:`plan_warp_combine`), and so have ``v_bounds`` and
    ``snap_geom``, which a row-banded caller sets (``parallel/fused``).
    Pixels no frame covers are 0.
    Returns (H, W) float32.

    CUDA tensors run the hand-written kernel; CPU tensors run
    :func:`warp_combine_plain`.  The kernel has three routes
    (``kernels._warp_route``): 'smem' below 150 frames, where a block of
    8 x 32 pixels keeps its samples and its source window in shared
    memory; 'cols' from 150 frames, the samples in a scratch of device
    memory and each pixel's column sorted by a warp; and 'wide' for a
    ``span`` past 192, where one output row's window no longer fits a
    block's 227 KB: a block of up to 32 x 32 pixels keeps only its
    (rows + span) x 32 mid rows (the horizontal pass) in shared memory,
    filled from one staged window row per warp, each mid row it reads
    computed once; each thread combines its own pixels (in registers to
    32 frames, in shared memory to 112, through the 'cols' combine past
    that).  It takes spans up to 1436 (``kernels._WARP_WIDE_MAX_SPAN``);
    past that the wrapper raises.

    Spans: ``apt.warp_combine`` around the call, ``apt.warp_combine.plan``
    and ``apt.warp_combine.k2`` (the kernel, or its twin on the CPU),
    whose attributes say what ran: ``route`` (``kernels._warp_route``'s,
    or 'plain' for the twin), ``span`` and ``taps`` (the tap body of
    frames that do not snap to a translation); counters
    ``warp_combine.frame_tiles`` (frames x tiles) and
    ``warp_combine.frame_tiles_used`` (:func:`frame_tiles_used`, read
    with the span records)."""
    _validate(frames, matrices, masters, combine)
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no warp+combine kernel for device {frames.device}")
    with _span("apt.warp_combine.plan"):
        plan = plan_warp_combine(frames.shape, matrices, exp_ratios,
                                 flux_scales, tile=tile, span=span,
                                 apron=apron, dither_budget=dither_budget,
                                 snap_tol=snap_tol, general_taps=general_taps,
                                 v_bounds=v_bounds, snap_geom=snap_geom)
        masters = None if masters is None else masters.to(torch.float32)
    count("warp_combine.frame_tiles",
          frames.shape[0] * plan.n_ti * plan.n_tj)
    count("warp_combine.frame_tiles_used",
          lambda: int(frame_tiles_used(plan)))
    with _span("apt.warp_combine.k2"):
        if frames.device.type == "cpu":
            annotate(route="plain", span=plan.span, taps=general_taps)
            return _run_plain(frames, masters, plan, combine, sigma_lower,
                              sigma_upper, general_taps)
        from .. import kernels

        return kernels.warp_combine_cuda(
            frames, masters, plan, combine=_COMBINES.index(combine),
            lowrank=general_taps == "lowrank",
            sigma_lower=float(sigma_lower), sigma_upper=float(sigma_upper))
