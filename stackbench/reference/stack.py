"""The plain reference of a stack: calibrate, Lanczos3-resample every
frame onto the reference frame by its TRUE matrix, sigma-clip combine.

Written from the definitions, in plain PyTorch, and imports nothing of
the program.  It takes the benchmark's own inputs (raw frames, masters,
exposure ratios) and the true matrices the benchmark drew, never what
the program derived from them, so a misregistered stack fails it as a
miscalibrated or misresampled one does.

* Calibration: ``(raw - bias - r * (dark - bias)) / flat`` (the master
  dark still holds the bias).
* Resampling, output (x, y) -> source (u, v) = M @ (x, y, 1): Heckbert's
  two passes.  Along each source row r the horizontal pass samples
  u_r = gx * x + gy * r + g0, the point of the map's line through (u, v)
  on that row; the vertical pass combines rows floor(v) - 2 ..
  floor(v) + 3.  Each pass weights its six taps by the Lanczos3 kernel
  sinc(t) sinc(t / 3) and divides by the weights' sum.
* Combine ('average', ccdproc's clip): median and median absolute
  deviation over the frames (the mean of the two middle values for an
  even count), std = 1.4826 * MAD, keep med - lo * std <= x <=
  med + hi * std, the mean of what is kept.

Every pixel value, weight and sum is computed in ``dtype``; the tap
positions are float64 whatever ``dtype`` is.  The work goes in blocks of
output rows, all frames of a block at once, so that it fits beside the
stack.

* Registration, judged apart from the image: each frame's solved map
  against its true one, by the largest distance at the frame's corners.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAD_TO_STD = 1.482602218505602
#: output pixels nearer than this to a frame's edge (after its map) are
#: not compared: there the program's coverage rules, not the arithmetic,
#: decide which frames count
EDGE_PX = 8
#: elements of the largest (frames, rows, width) temporary of a block
BLOCK_ELEMENTS = 1 << 26


def lanczos3(t: torch.Tensor) -> torch.Tensor:
    """sinc(t) sinc(t / 3) on |t| < 3, else 0."""
    a = 3.0
    pt = math.pi * t
    safe = torch.where(t.abs() < 1e-12, torch.ones_like(t), pt)
    val = a * torch.sin(safe) * torch.sin(safe / a) / (safe * safe)
    val = torch.where(t.abs() < 1e-12, torch.ones_like(t), val)
    return torch.where(t.abs() < a, val, torch.zeros_like(t))


def lanczos3_taps(frac: torch.Tensor):
    """The six weights lanczos3(frac - s), s = 0..5, of a position whose
    first tap lies ``frac`` in [2, 3) before it: the sines of all six
    from one sin(pi frac) and one sine and cosine of pi frac / 3 (by
    sin(x - pi s) = (-1)^s sin x and the angle-difference rule), equal
    to :func:`lanczos3` to rounding."""
    x = math.pi * frac
    s1, s3, c3 = torch.sin(x), torch.sin(x / 3.0), torch.cos(x / 3.0)
    out = []
    for s in range(6):
        t = frac - s
        sin_t3 = s3 * math.cos(math.pi * s / 3.0) \
            - c3 * math.sin(math.pi * s / 3.0)
        num = 3.0 * (-1.0) ** s * s1 * sin_t3
        den = math.pi * math.pi * t * t
        w = torch.where(t.abs() < 1e-12, torch.ones_like(t),
                        num / torch.where(t.abs() < 1e-12,
                                          torch.ones_like(t), den))
        out.append(torch.where(t.abs() < 3.0, w, torch.zeros_like(t)))
    return out


def calibrate(raw: torch.Tensor, bias, dark, flat, exp_ratios,
              dtype) -> torch.Tensor:
    """(N, H, W) calibrated frames in ``dtype``."""
    raw_i = raw.view(torch.int16).to(torch.int32).bitwise_and(0xFFFF) \
        if raw.dtype == torch.uint16 else raw
    out = torch.empty(raw.shape, dtype=dtype, device=raw.device)
    b, d, f = (m.to(dtype) for m in (bias, dark, flat))
    dark_counts = d - b
    for i in range(raw.shape[0]):
        r = exp_ratios[i].to(dtype)
        out[i] = (raw_i[i].to(dtype) - b - r * dark_counts) / f
    return out


def _separable(mats: np.ndarray):
    """(gx, gy, g0) of each frame's map: u on source row r is
    gx * x + gy * r + g0 (x, r the output column and the source row)."""
    m = mats.astype(np.float64)
    gx = m[:, 0, 0] - m[:, 0, 1] * m[:, 1, 0] / m[:, 1, 1]
    gy = m[:, 0, 1] / m[:, 1, 1]
    g0 = m[:, 0, 2] - m[:, 0, 1] * m[:, 1, 2] / m[:, 1, 1]
    return gx, gy, g0


def resample_rows(cal: torch.Tensor, mats: np.ndarray, y0: int, y1: int,
                  dtype):
    """Every frame of ``cal`` (N, H, W) resampled onto output rows
    y0..y1-1: (samples (N, y1-y0, W) in ``dtype``, inside (y1-y0, W):
    every frame's taps lie at least EDGE_PX from its edges)."""
    n, h, w = cal.shape
    dev = cal.device
    f64 = torch.float64
    m = torch.from_numpy(mats.astype(np.float64)).to(dev)
    gx, gy, g0 = (torch.from_numpy(a).to(dev)[:, None, None]
                  for a in _separable(mats))
    ys = torch.arange(y0, y1, device=dev, dtype=f64)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=f64)[None, None, :]
    mm = m.reshape(n, 6)[:, :, None, None]
    u = mm[:, 0] * xs + mm[:, 1] * ys + mm[:, 2]
    v = mm[:, 3] * xs + mm[:, 4] * ys + mm[:, 5]
    inside = ((u >= EDGE_PX) & (u <= w - 1 - EDGE_PX)
              & (v >= EDGE_PX) & (v <= h - 1 - EDGE_PX)).all(dim=0)
    flat = cal.reshape(n, h * w)
    v0 = torch.floor(v) - 2.0
    wvs = lanczos3_taps(v - v0)
    out = torch.zeros((n, y1 - y0, w), dtype=dtype, device=dev)
    wv_sum = torch.zeros_like(out)
    for s in range(6):
        r = v0 + s                                   # source row (f64)
        wv = wvs[s].to(dtype)
        ur = gx * xs + gy * r + g0
        u0 = torch.floor(ur) - 2.0
        whs = lanczos3_taps(ur - u0)
        ri = r.clamp(0, h - 1).to(torch.int64)
        mid = torch.zeros_like(out)
        wh_sum = torch.zeros_like(out)
        for t in range(6):
            c = u0 + t
            wh = whs[t].to(dtype)
            ci = c.clamp(0, w - 1).to(torch.int64)
            tap = torch.gather(flat, 1, (ri * w + ci).reshape(n, -1)) \
                .reshape(out.shape)
            mid = mid + wh * tap
            wh_sum = wh_sum + wh
        out = out + wv * (mid / wh_sum)
        wv_sum = wv_sum + wv
    return out / wv_sum, inside


def _median(sorted_vals: torch.Tensor) -> torch.Tensor:
    n = sorted_vals.shape[0]
    return 0.5 * (sorted_vals[(n - 1) // 2] + sorted_vals[n // 2])


def clip_mean(samples: torch.Tensor, sigma_lower: float,
              sigma_upper: float) -> torch.Tensor:
    """The clipped mean over axis 0 of (N, ...) samples, in their dtype."""
    med = _median(torch.sort(samples, dim=0).values)
    mad = _median(torch.sort((samples - med).abs(), dim=0).values)
    std = MAD_TO_STD * mad
    keep = (samples >= med - sigma_lower * std) \
        & (samples <= med + sigma_upper * std)
    total = torch.where(keep, samples, torch.zeros_like(samples)).sum(dim=0)
    return total / keep.sum(dim=0).to(samples.dtype)


def star_mask(h: int, w: int, star_x, star_y, half: int, device):
    """(H, W) True away from every star: outside the (2 * half + 9)^2
    box about each star's reference-frame position."""
    keep = torch.ones((h, w), dtype=torch.bool, device=device)
    r = half + 4
    for x, y in zip(np.asarray(star_x), np.asarray(star_y)):
        xi, yi = int(round(float(x))), int(round(float(y)))
        keep[max(yi - r, 0):max(yi + r + 1, 0),
             max(xi - r, 0):max(xi + r + 1, 0)] = False
    return keep


def row_blocks(n: int, h: int, w: int):
    """The (y0, y1) blocks of output rows the reference works in."""
    rows = max(1, BLOCK_ELEMENTS // (n * w))
    return [(y0, min(y0 + rows, h)) for y0 in range(0, h, rows)]


def regions(obs, inside: torch.Tensor) -> dict:
    """The pixels compared, each (H, W) bool: 'sky', those every frame
    covers away from its edges and outside every star's box, and 'star',
    the covered pixels of the stars' boxes."""
    h, w = inside.shape
    away = star_mask(h, w, obs.star_x, obs.star_y, obs.star_half,
                     inside.device)
    return {"sky": inside & away, "star": inside & ~away}


def reference_stack(obs, combine: dict, dtype=torch.float64):
    """(image (H, W) in ``dtype``, regions): the stack of ``obs`` (a
    :class:`stackbench.workload.Observation`) and the pixels compared
    (:func:`regions`).  ``combine`` gives 'method', 'sigma_lower' and
    'sigma_upper'."""
    if combine["method"] != "average":
        raise ValueError(f"the reference states the 'average' combine, "
                         f"not {combine['method']!r}")
    n, h, w = obs.frames.shape
    cal = calibrate(obs.frames, obs.bias, obs.dark, obs.flat,
                    obs.exp_ratios, dtype)
    image = torch.zeros((h, w), dtype=dtype, device=cal.device)
    inside = torch.zeros((h, w), dtype=torch.bool, device=cal.device)
    for y0, y1 in row_blocks(n, h, w):
        samples, ins = resample_rows(cal, obs.matrices, y0, y1, dtype)
        image[y0:y1] = clip_mean(samples, combine["sigma_lower"],
                                 combine["sigma_upper"])
        inside[y0:y1] = ins
        del samples
    del cal
    return image, regions(obs, inside)


def gaps(image: torch.Tensor, reference: torch.Tensor,
         compared: dict) -> dict:
    """The program's (H, W) image against the reference on each region of
    ``compared``: '<region>_rms_adu' and '<region>_max_adu', the rms and
    the widest absolute gap, in ADU (float64)."""
    d = image.to(reference.device, torch.float64) - reference.to(torch.float64)
    out = {}
    for name, mask in compared.items():
        dr = d[mask]
        if dr.numel() == 0:
            raise ValueError(f"no {name} pixel to compare")
        if not bool(torch.isfinite(dr).all()):
            out[f"{name}_rms_adu"] = out[f"{name}_max_adu"] = math.inf
            continue
        out[f"{name}_rms_adu"] = float(torch.sqrt((dr * dr).mean()))
        out[f"{name}_max_adu"] = float(dr.abs().max())
    return out


def maps_of(sims: dict) -> np.ndarray:
    """(N, 2, 3) float64 reference -> frame maps of per-frame similarities
    given as 'scale', 'theta', 'tx', 'ty' arrays."""
    scale, theta, tx, ty = (np.asarray(sims[k], np.float64)
                            for k in ("scale", "theta", "tx", "ty"))
    c, s = scale * np.cos(theta), scale * np.sin(theta)
    return np.stack([np.stack([c, -s, tx], -1), np.stack([s, c, ty], -1)],
                    -2)


def corner_errors(maps: np.ndarray, truth: np.ndarray, h: int,
                  w: int) -> np.ndarray:
    """Each frame's largest distance, over the four corners of an (h, w)
    frame, between where its solved and its true map send the corner:
    (N,) px."""
    corners = np.array([[0, w - 1, 0, w - 1], [0, 0, h - 1, h - 1],
                        [1, 1, 1, 1]], float)
    d = np.einsum("nij,jk->nik", np.asarray(maps, np.float64) - truth,
                  corners)
    return np.hypot(d[:, 0], d[:, 1]).max(axis=1)
