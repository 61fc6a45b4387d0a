"""Synthetic data generators for tests and benchmarks.

The reference's golden data (CR2 frames + Octave-generated postage
stamps, reference test/AstroPhotography/test_core.py:16-41) is not
reproducible in-repo; this module generates everything synthetically —
Bayer mosaics, starfields with known injected sources, darks with hot
pixels — so every kernel has a ground truth to test against
(SURVEY.md §4 rebuild plan, items a/d).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: Bayer color-plane indices following the LibRaw convention the
#: reference relies on (reference core/RawConv.py:111-128):
#: 0=R, 1=G (first green), 2=B, 3=G2 (second green).
RGGB = np.array([[0, 1], [3, 2]], dtype=np.uint8)


def bayer_color_map(shape: Tuple[int, int], pattern: np.ndarray = RGGB) -> np.ndarray:
    """Per-pixel color index array (the analogue of raw_colors_visible)."""
    h, w = shape
    return np.tile(pattern, ((h + 1) // 2, (w + 1) // 2))[:h, :w]


def make_rgb_scene(
    shape: Tuple[int, int] = (64, 64),
    seed: int = 0,
    peak: float = 40000.0,
) -> np.ndarray:
    """Smooth random RGB scene in [0, peak], float64, shape (H, W, 3)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    # low-frequency random field: random coarse grid, bilinear upsampled
    coarse = rng.uniform(0.05, 1.0, size=(3, max(h // 8, 2), max(w // 8, 2)))
    out = np.empty((h, w, 3))
    for c in range(3):
        yi = np.linspace(0, coarse.shape[1] - 1, h)
        xi = np.linspace(0, coarse.shape[2] - 1, w)
        y0 = np.floor(yi).astype(int)
        x0 = np.floor(xi).astype(int)
        y1 = np.minimum(y0 + 1, coarse.shape[1] - 1)
        x1 = np.minimum(x0 + 1, coarse.shape[2] - 1)
        fy = (yi - y0)[:, None]
        fx = (xi - x0)[None, :]
        c00 = coarse[c][np.ix_(y0, x0)]
        c01 = coarse[c][np.ix_(y0, x1)]
        c10 = coarse[c][np.ix_(y1, x0)]
        c11 = coarse[c][np.ix_(y1, x1)]
        out[..., c] = ((1 - fy) * (1 - fx) * c00 + (1 - fy) * fx * c01
                       + fy * (1 - fx) * c10 + fy * fx * c11)
    return out * peak


def mosaic_from_rgb(
    rgb: np.ndarray,
    black_levels: Tuple[int, int, int, int] = (512, 512, 512, 512),
    wb_gains: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
    pattern: np.ndarray = RGGB,
    saturation: int = 65535,
) -> np.ndarray:
    """Sample an RGB scene through an RGGB Bayer CFA into a uint16 mosaic.

    The sensor model inverts the processing chain: raw = scene/gain + black,
    so demosaic(black-sub, wb) recovers the scene.
    """
    h, w, _ = rgb.shape
    cmap = bayer_color_map((h, w), pattern)
    plane = np.empty((h, w))
    rgb_index = np.array([0, 1, 2, 1])  # color idx -> RGB channel
    for color in range(4):
        mask = cmap == color
        plane[mask] = (rgb[..., rgb_index[color]][mask] / wb_gains[color]
                       + black_levels[color])
    return np.clip(np.round(plane), 0, saturation).astype(np.uint16)


def gaussian_star(
    shape: Tuple[int, int],
    x: float,
    y: float,
    flux: float,
    fwhm: float,
    axial_ratio: float = 1.0,
    theta: float = 0.0,
) -> np.ndarray:
    """Single elliptical Gaussian star image (float64), integrating to ~flux."""
    h, w = shape
    sigma_x = fwhm / 2.35482
    sigma_y = sigma_x * axial_ratio
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ct, st = np.cos(theta), np.sin(theta)
    dx = (xx - x) * ct + (yy - y) * st
    dy = -(xx - x) * st + (yy - y) * ct
    amp = flux / (2 * np.pi * sigma_x * sigma_y)
    return amp * np.exp(-0.5 * ((dx / sigma_x) ** 2 + (dy / sigma_y) ** 2))


def make_starfield(
    shape: Tuple[int, int] = (256, 256),
    n_stars: int = 25,
    fwhm: float = 3.0,
    background: float = 200.0,
    read_noise: float = 5.0,
    flux_range: Tuple[float, float] = (2000.0, 80000.0),
    seed: int = 0,
    margin: int = 12,
    sky_gradient: float = 0.0,
    min_sep: float = 0.0,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Starfield with known truth; returns (image float32, truth dict).

    Truth dict has 'x', 'y', 'flux', 'fwhm' arrays.  Poisson + Gaussian
    read noise applied; background may have a linear gradient to
    exercise background modelling.  ``min_sep`` > 0 rejection-samples
    positions so no two stars are closer than that (isolated-star
    fields for detection/PSF tests).
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    if min_sep > 0:
        xs_l: list = []
        ys_l: list = []
        attempts = 0
        while len(xs_l) < n_stars and attempts < 100 * n_stars:
            attempts += 1
            x = rng.uniform(margin, w - 1 - margin)
            y = rng.uniform(margin, h - 1 - margin)
            if all((x - px) ** 2 + (y - py) ** 2 >= min_sep ** 2
                   for px, py in zip(xs_l, ys_l)):
                xs_l.append(x)
                ys_l.append(y)
        if len(xs_l) < n_stars:
            raise ValueError(
                f"could not place {n_stars} stars with min_sep={min_sep}")
        xs = np.array(xs_l)
        ys = np.array(ys_l)
    else:
        xs = rng.uniform(margin, w - 1 - margin, n_stars)
        ys = rng.uniform(margin, h - 1 - margin, n_stars)
    fluxes = np.exp(rng.uniform(np.log(flux_range[0]), np.log(flux_range[1]), n_stars))
    img = np.zeros(shape, dtype=np.float64)
    for x, y, f in zip(xs, ys, fluxes):
        img += gaussian_star(shape, x, y, f, fwhm)
    yy, xx = np.mgrid[0:h, 0:w]
    img += background + sky_gradient * (xx + yy) / (h + w)
    img = rng.poisson(np.clip(img, 0, None)).astype(np.float64)
    img += rng.normal(0.0, read_noise, size=shape)
    truth = {
        "x": xs,
        "y": ys,
        "flux": fluxes,
        "fwhm": np.full(n_stars, fwhm),
    }
    return img.astype(np.float32), truth


def make_dark(
    shape: Tuple[int, int] = (128, 128),
    bias_level: float = 500.0,
    dark_rate: float = 0.1,
    exptime: float = 60.0,
    read_noise: float = 8.0,
    n_hot: int = 12,
    hot_value: float = 40000.0,
    seed: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic dark frame and the boolean hot-pixel mask used to make it."""
    rng = np.random.default_rng(seed)
    img = rng.normal(bias_level + dark_rate * exptime, read_noise, size=shape)
    mask = np.zeros(shape, dtype=bool)
    ys = rng.integers(0, shape[0], n_hot)
    xs = rng.integers(0, shape[1], n_hot)
    mask[ys, xs] = True
    img[mask] = hot_value
    return img.astype(np.float32), mask


def inject_cosmic_rays(
    image: np.ndarray,
    n_rays: int = 10,
    amplitude: float = 30000.0,
    seed: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """Add single-pixel/short-streak cosmic ray hits; returns (image, mask)."""
    rng = np.random.default_rng(seed)
    out = image.astype(np.float32).copy()
    mask = np.zeros(image.shape, dtype=bool)
    h, w = image.shape
    for _ in range(n_rays):
        y = int(rng.integers(2, h - 2))
        x = int(rng.integers(2, w - 2))
        length = int(rng.integers(1, 4))
        dy, dx = rng.choice([-1, 0, 1], size=2)
        for step in range(length):
            yy = min(max(y + step * dy, 0), h - 1)
            xx = min(max(x + step * dx, 0), w - 1)
            out[yy, xx] += amplitude * float(rng.uniform(0.5, 1.5))
            mask[yy, xx] = True
    return out, mask
