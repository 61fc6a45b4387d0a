"""The observing run a cell stacks, made from ``--seed``.

A frozen copy of ``chip_smoke.workload_geometry`` and
``chip_smoke.make_workload_on_device`` (themselves ``bench.py``'s
workload, ``bench.py:58-122``), with the sensor taken from the
configuration file and the dithers, rotations and stars from the traffic
mix.  The host half (masters, star positions, every frame's true
matrix) comes from one numpy generator seeded with the seed; the stack's
noise from a generator on the device seeded with the same seed, so the
stack is made on the card in a few large calls and never crosses to the
host.  This module imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Observation:
    """Inputs of one cell, and the truth the reference needs."""

    frames: torch.Tensor        # (N, H, W) uint16 raw lights on the device
    bias: torch.Tensor          # (H, W) float32 master bias
    dark: torch.Tensor          # (H, W) float32 master dark (bias included)
    flat: torch.Tensor          # (H, W) float32 normalised flat
    exp_ratios: torch.Tensor    # (N,) float32 light / dark exposure
    matrices: np.ndarray        # (N, 2, 3) true reference -> frame maps
    star_x: np.ndarray          # (S,) star positions in the reference frame
    star_y: np.ndarray
    star_half: int              # half size of each star's drawn patch


def geometry(n: int, h: int, w: int, sensor: dict, mix: dict, seed: int):
    """The host half of the run: flat, bias and dark counts, the stars'
    positions and fluxes and each frame's true matrix.  Frame 0 is the
    reference; every other frame is dithered by uniform(-d, d) px in x
    and y and, where the mix gives ``rotation_deg`` [lo, hi], turned by
    lo-hi degrees of random sign about the centre."""
    rng = np.random.default_rng(seed)
    yy = (np.arange(h, dtype=np.float32) - h / 2) / max(h, w)
    xx = (np.arange(w, dtype=np.float32) - w / 2) / max(h, w)
    r2 = yy[:, None] ** 2 + xx[None, :] ** 2
    flat = (1.0 - sensor["flat_vignetting"] * r2 / r2.max()).astype(np.float32)
    bias = np.full((h, w), sensor["bias_adu"], np.float32)
    dark_counts = np.full((h, w), sensor["dark_adu"], np.float32)
    hot = rng.integers(0, min(h, w), (sensor["hot_pixels"], 2))
    dark_counts[hot[:, 0], hot[:, 1]] = sensor["hot_adu"]
    edge = mix["star_edge_px"]
    k = mix["stars"]
    xs = rng.uniform(edge, w - edge, k)
    ys = rng.uniform(edge, h - edge, k)
    lo, hi = mix["star_flux_adu"]
    flux = rng.uniform(lo, hi, k)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    d = mix["dither_px"]
    rot = mix.get("rotation_deg")
    mats = np.zeros((n, 2, 3), np.float64)
    px, py = np.empty((n, k)), np.empty((n, k))
    for i in range(n):
        dx = dy = theta = 0.0
        if i:
            dx, dy = rng.uniform(-d, d, 2)
            if rot:
                theta = float(rng.choice([-1.0, 1.0])
                              * np.deg2rad(rng.uniform(rot[0], rot[1])))
        c, s = np.cos(theta), np.sin(theta)
        mats[i] = [[c, -s, cx + dx - c * cx + s * cy],
                   [s, c, cy + dy - s * cx - c * cy]]
        px[i] = c * (xs - cx) - s * (ys - cy) + cx + dx
        py[i] = s * (xs - cx) + c * (ys - cy) + cy + dy
    return {"flat": flat, "bias": bias, "dark_counts": dark_counts,
            "flux": flux, "mats": mats, "px": px, "py": py}


def make_observation(n: int, h: int, w: int, sensor: dict, mix: dict,
                     seed: int, device, chunk: int = 32) -> Observation:
    """The raw uint16 stack made on ``device`` ``chunk`` frames at a
    time: sky * flat + bias + exp_ratio * dark counts, the stars (circular
    Gaussians of the mix's FWHM, each on a patch of at least +-4 sigma)
    times the flat, and Gaussian read noise of the sensor's sigma, each
    frame its own, and the mix's cosmic-ray hits (``hits_per_mpix`` single
    pixels a frame at uniform places, each adding uniform ``hit_adu``
    [lo, hi] ADU, which the sigma clip has to reject), clipped and
    truncated to uint16."""
    geo = geometry(n, h, w, sensor, mix, seed)
    dev = torch.device(device)
    flat_t = torch.from_numpy(geo["flat"]).to(dev)
    er = float(sensor["exp_ratio"])
    base = sensor["sky_adu"] * flat_t + torch.from_numpy(
        geo["bias"] + er * geo["dark_counts"]).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.empty((n, h, w), dtype=torch.int16, device=dev)
    sigma = mix["star_fwhm_px"] / 2.35482
    half = max(12, math.ceil(4.0 * sigma))
    d = torch.arange(2 * half + 1, device=dev)
    pxt, pyt = (torch.from_numpy(geo[k]).to(dev) for k in ("px", "py"))
    amp = torch.from_numpy(geo["flux"] / (2 * np.pi * sigma * sigma)).to(dev)
    x0, y0 = pxt.long() - half, pyt.long() - half
    noise = float(sensor["read_noise_adu"])
    n_hits = round(mix.get("hits_per_mpix", 0.0) * h * w / 1e6)
    hit_lo, hit_hi = mix.get("hit_adu", (0.0, 0.0))
    for k in range(0, n, chunk):
        sl = slice(k, min(k + chunk, n))
        f = base + noise * torch.randn((sl.stop - k, h, w), generator=g,
                                       device=dev)
        xx = (x0[sl, :, None, None] + d[None, None, None, :]) \
            .expand(-1, -1, d.numel(), -1)
        yy = (y0[sl, :, None, None] + d[None, None, :, None]) \
            .expand(-1, -1, -1, d.numel())
        star = amp[None, :, None, None] * torch.exp(
            -0.5 * (((xx - pxt[sl, :, None, None]) / sigma) ** 2
                    + ((yy - pyt[sl, :, None, None]) / sigma) ** 2))
        fi = torch.arange(sl.stop - k, device=dev)[:, None, None, None] \
            .expand_as(xx)
        f.index_put_((fi, yy, xx), (star * flat_t[yy, xx]).to(torch.float32),
                     accumulate=True)
        if n_hits:
            at = torch.randint(0, h * w, (sl.stop - k, n_hits), generator=g,
                               device=dev)
            adu = hit_lo + (hit_hi - hit_lo) * torch.rand(
                (sl.stop - k, n_hits), generator=g, device=dev)
            f.view(sl.stop - k, h * w).scatter_add_(1, at, adu)
        i = f.clamp(0, 65535).to(torch.int32)
        frames[sl] = torch.where(i >= 32768, i - 65536, i).to(torch.int16)
        del f, star, i
    return Observation(
        frames=frames.view(torch.uint16),
        bias=torch.from_numpy(geo["bias"]).to(dev),
        dark=torch.from_numpy(geo["bias"] + geo["dark_counts"]).to(dev),
        flat=flat_t,
        exp_ratios=torch.full((n,), er, dtype=torch.float32, device=dev),
        matrices=geo["mats"], star_x=geo["px"][0], star_y=geo["py"][0],
        star_half=half)
