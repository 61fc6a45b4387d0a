"""RAW mosaic -> RGB/grey conversion (the JAX package's
``ops/demosaic.py``).

Replacement for the LibRaw ``postprocess`` call the reference makes for
every conversion (reference core/RawConv.py:453-455: linear gamma, no
auto-bright/scale, 16-bit output, user white balance).  The whole chain
— per-site black-level subtraction with the uint16 wraparound guard
(reference ``_safe_subtract`` core/RawConv.py:250-289), white-balance
multiplication, 16-bit range scaling, demosaic, CCIR-601 luma, and
percentile renormalization (core/RawConv.py:462-471) — is plain
elementwise and fixed-stencil tensor code that runs on the device its
inputs live on.

Demosaic algorithms:

* ``mhc`` (default) — Malvar-He-Cutler gradient-corrected linear
  interpolation (Malvar, He & Cutler, ICASSP 2004): five fixed 5x5
  filters over the CFA signal, selected per site class.  Quality is
  AHD-class on edges (the reference inherits LibRaw's AHD via
  postprocess, core/RawConv.py:453-455) while staying a pure
  fixed-stencil convolution with no data-dependent control flow.
* ``bilinear`` — mask-normalized bilinear interpolation, pattern
  agnostic; kept as the fallback for exotic CFA layouts.
* ``ahd`` — adaptive homogeneity-directed (Hirakawa & Parks 2005), the
  algorithm LibRaw itself runs for the reference's postprocess call;
  directional interpolation + homogeneity selection, for
  parity-critical use.

Both formulations only need the per-pixel color map (the analogue of
rawpy's ``raw_colors_visible``); MHC additionally derives the site
classes (green-in-red-row vs green-in-blue-row) from the map itself,
so every Bayer phase (RGGB/BGGR/GRBG/GBRG) works unchanged.

``color_map`` is any integer tensor; it is used as an index (int64) to
look up per-band black levels and white-balance factors, so a caller
that converts many frames keeps it as int64 (``RawConv`` does).  Every
operation rounds on its own in float32: the taps are multiples of 1/16,
so most products are exact, and the three-term luma sum is written out
term by term so the CPU and the card round alike and no matrix-product
library is involved.
"""

from __future__ import annotations

import functools
from typing import Sequence, Union

import torch
import torch.nn.functional as F

from ..device import numpy_inputs, to_float32
from .composite import _percentile_sorted
from .stencil import conv2d_static

#: CCIR 601 luma coefficients (reference core/RawConv.py:550).
CCIR601 = (0.299, 0.587, 0.114)

#: color plane indices (reference RawConv class attrs R/G1/B/G2).
R, G1, B, G2 = 0, 1, 2, 3

MAX_ADU = 65535.0


def _conv3x3_sum(x: torch.Tensor, kernel) -> torch.Tensor:
    """3x3 weighted sum via shifted adds over a zero-padded image.

    ``kernel`` is a static Python 3x3 nested sequence; zero taps are
    skipped.
    """
    h, w = x.shape
    padded = F.pad(x, (1, 1, 1, 1))
    out = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            k = float(kernel[dy][dx])
            if k != 0.0:
                out = out + k * padded[dy:dy + h, dx:dx + w]
    return out


_BILINEAR_KERNEL = (
    (0.25, 0.5, 0.25),
    (0.5, 1.0, 0.5),
    (0.25, 0.5, 0.25),
)


@numpy_inputs("values", "color_map")
def demosaic_bilinear(values: torch.Tensor,
                      color_map: torch.Tensor) -> torch.Tensor:
    """Mask-normalized bilinear demosaic: (H, W) sites -> (H, W, 3) RGB.

    For each output color c, interpolate from the sites of that color
    with a 3x3 tent kernel, normalizing by the convolved site mask so
    edges and every CFA layout are handled uniformly.
    """
    values = to_float32(values)
    planes = []
    for colors in ((R,), (G1, G2), (B,)):
        site = torch.zeros_like(values, dtype=torch.bool)
        for c in colors:
            site = site | (color_map == c)
        sitef = site.to(torch.float32)
        num = _conv3x3_sum(values * sitef, _BILINEAR_KERNEL)
        den = _conv3x3_sum(sitef, _BILINEAR_KERNEL)
        interp = num / den.clamp(min=1e-12)
        # measured sites keep their own sample exactly (classical bilinear)
        planes.append(torch.where(site, values, interp))
    return torch.stack(planes, dim=-1)


def _conv5x5_sum(x: torch.Tensor, kernel) -> torch.Tensor:
    """5x5 weighted sum, reflect-padded (see ops/stencil.py)."""
    return conv2d_static(x, kernel, pad_mode="reflect")


# Malvar-He-Cutler 2004 filters, in eighths.  Names by target:
# G at an R/B site; R/B at a green site whose same-color neighbors are
# horizontal (row) or vertical (col); R at a B site / B at an R site
# (diag).
_E = 1.0 / 8.0
_MHC_G_AT_RB = (
    (0, 0, -1 * _E, 0, 0),
    (0, 0, 2 * _E, 0, 0),
    (-1 * _E, 2 * _E, 4 * _E, 2 * _E, -1 * _E),
    (0, 0, 2 * _E, 0, 0),
    (0, 0, -1 * _E, 0, 0),
)
_MHC_RB_ROW = (
    (0, 0, 0.5 * _E, 0, 0),
    (0, -1 * _E, 0, -1 * _E, 0),
    (-1 * _E, 4 * _E, 5 * _E, 4 * _E, -1 * _E),
    (0, -1 * _E, 0, -1 * _E, 0),
    (0, 0, 0.5 * _E, 0, 0),
)
_MHC_RB_COL = tuple(zip(*_MHC_RB_ROW))  # transpose
_MHC_RB_DIAG = (
    (0, 0, -1.5 * _E, 0, 0),
    (0, 2 * _E, 0, 2 * _E, 0),
    (-1.5 * _E, 0, 6 * _E, 0, -1.5 * _E),
    (0, 2 * _E, 0, 2 * _E, 0),
    (0, 0, -1.5 * _E, 0, 0),
)


def _horizontal_neighbor_mask(site: torch.Tensor) -> torch.Tensor:
    """True where a horizontal (left or right) neighbor is in ``site``.

    Wrap-around preserves Bayer phase (H, W are even for every CFA),
    so edge columns classify correctly.
    """
    return torch.roll(site, 1, dims=1) | torch.roll(site, -1, dims=1)


@numpy_inputs("values", "color_map")
def demosaic_mhc(values: torch.Tensor,
                 color_map: torch.Tensor) -> torch.Tensor:
    """Malvar-He-Cutler demosaic: (H, W) CFA sites -> (H, W, 3) RGB.

    Gradient-corrected bilinear interpolation: each missing color is a
    fixed 5x5 linear filter of the raw CFA signal (the filters embed
    the luminance-gradient correction), selected by the site's class.
    Measured sites keep their own sample exactly.
    """
    v = to_float32(values)
    site_r = color_map == R
    site_b = color_map == B
    site_g = (color_map == G1) | (color_map == G2)
    # green sites split by the orientation of their red neighbors
    g_red_row = site_g & _horizontal_neighbor_mask(site_r)
    g_blue_row = site_g & _horizontal_neighbor_mask(site_b)

    conv_g = _conv5x5_sum(v, _MHC_G_AT_RB)
    conv_row = _conv5x5_sum(v, _MHC_RB_ROW)
    conv_col = _conv5x5_sum(v, _MHC_RB_COL)
    conv_diag = _conv5x5_sum(v, _MHC_RB_DIAG)

    red = torch.where(site_r, v,
                      torch.where(g_red_row, conv_row,
                                  torch.where(g_blue_row, conv_col,
                                              conv_diag)))
    green = torch.where(site_g, v, conv_g)
    blue = torch.where(site_b, v,
                       torch.where(g_blue_row, conv_row,
                                   torch.where(g_red_row, conv_col,
                                               conv_diag)))
    return torch.stack([red, green, blue], dim=-1)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x translated by (dy, dx), wrap-padded (no gathers).

    Wrap keeps the Bayer COLOR PHASE intact at the borders (H, W are
    even for every CFA): an edge-replicated pad would feed wrong-color
    samples into the directional filters, corrupting the outermost two
    columns/rows far worse than the spatially-wrong-but-right-color
    wrap samples do."""
    return torch.roll(x, (dy, dx), dims=(0, 1))


def _ahd_candidates(values: torch.Tensor, color_map: torch.Tensor):
    """The horizontal and the vertical AHD candidate, each (H, W, 3)."""
    v = to_float32(values)
    site_r = color_map == R
    site_b = color_map == B
    site_g = (color_map == G1) | (color_map == G2)

    # directional green at non-green sites: average of the two in-line
    # greens plus a half Laplacian of the same-color in-line samples
    gh = 0.5 * (_shift(v, 0, -1) + _shift(v, 0, 1)) \
        + 0.25 * (2.0 * v - _shift(v, 0, -2) - _shift(v, 0, 2))
    gv = 0.5 * (_shift(v, -1, 0) + _shift(v, 1, 0)) \
        + 0.25 * (2.0 * v - _shift(v, -2, 0) - _shift(v, 2, 0))
    greens = [torch.where(site_g, v, gh), torch.where(site_g, v, gv)]

    cands = []
    for g in greens:
        # chroma via mask-normalized bilinear of the color DIFFERENCE
        # planes (R-G, B-G known at their sites), then add green back
        planes = [g]
        for site in (site_r, site_b):
            sitef = site.to(torch.float32)
            diff = torch.where(site, v - g, 0.0)
            num = _conv3x3_sum(diff, _BILINEAR_KERNEL)
            den = _conv3x3_sum(sitef, _BILINEAR_KERNEL)
            plane = g + num / den.clamp(min=1e-12)
            planes.append(torch.where(site, v, plane))
        cands.append(torch.stack([planes[1], planes[0], planes[2]], dim=-1))
    return cands


@numpy_inputs("values", "color_map")
def demosaic_ahd(values: torch.Tensor,
                 color_map: torch.Tensor) -> torch.Tensor:
    """Adaptive Homogeneity-Directed demosaic (Hirakawa & Parks 2005):
    (H, W) CFA sites -> (H, W, 3) RGB.

    The algorithm LibRaw runs for the reference's ``postprocess`` call
    (core/RawConv.py:453-455, dcraw ahd_interpolate): green is
    interpolated twice (horizontal and vertical directional filters
    with Laplacian correction), chroma rides the interpolated
    color-difference planes, and each pixel picks the direction whose
    3x3-smoothed homogeneity (neighbors within adaptive luma/chroma
    tolerance) is higher — averaging where tied.  This build scores
    homogeneity in luma/color-difference space rather than CIELab
    (monotone in the same differences; saves the per-pixel cube roots)
    and is pattern-generic via the color map.  Pure stencils and
    selects, no data-dependent control flow.

    The homogeneity tests compare float32 sums (``dl <= eps_l``,
    ``dc <= eps_c``): another rounding of one product can flip a test,
    and the pixel then takes another of its three possible values (the
    horizontal candidate, the vertical one, or their mean).
    """
    cands = _ahd_candidates(values, color_map)

    # homogeneity maps: neighbors within adaptive luma/chroma tolerance
    def luma_chroma(c):
        lum = 0.25 * (c[..., 0] + 2.0 * c[..., 1] + c[..., 2])
        return lum, c[..., 0] - c[..., 1], c[..., 2] - c[..., 1]

    lh, uh, wh_ = luma_chroma(cands[0])
    lv, uv, wv = luma_chroma(cands[1])
    nbrs = ((0, -1), (0, 1), (-1, 0), (1, 0))

    def diffs(lum, u, w):
        dl = [(lum - _shift(lum, dy, dx)).abs() for dy, dx in nbrs]
        dc = [(u - _shift(u, dy, dx)) ** 2 + (w - _shift(w, dy, dx)) ** 2
              for dy, dx in nbrs]
        return dl, dc

    dlh, dch = diffs(lh, uh, wh_)
    dlv, dcv = diffs(lv, uv, wv)
    # adaptive tolerance: the smaller of each direction's own in-line
    # neighbor spread (dcraw ahd epsilon)
    eps_l = torch.minimum(torch.maximum(dlh[0], dlh[1]),
                          torch.maximum(dlv[2], dlv[3]))
    eps_c = torch.minimum(torch.maximum(dch[0], dch[1]),
                          torch.maximum(dcv[2], dcv[3]))
    hom_h = functools.reduce(torch.add, [
        ((dl <= eps_l) & (dc <= eps_c)).to(torch.float32)
        for dl, dc in zip(dlh, dch)])
    hom_v = functools.reduce(torch.add, [
        ((dl <= eps_l) & (dc <= eps_c)).to(torch.float32)
        for dl, dc in zip(dlv, dcv)])
    box = ((1.0, 1.0, 1.0), (1.0, 1.0, 1.0), (1.0, 1.0, 1.0))
    sh = _conv3x3_sum(hom_h, box)
    sv = _conv3x3_sum(hom_v, box)
    pick_h = (sh > sv)[..., None]
    pick_v = (sv > sh)[..., None]
    blend = 0.5 * (cands[0] + cands[1])
    return torch.where(pick_h, cands[0],
                       torch.where(pick_v, cands[1], blend))


_DEMOSAIC_FUNCS = {"mhc": demosaic_mhc, "bilinear": demosaic_bilinear,
                   "ahd": demosaic_ahd}


def _per_site(table: torch.Tensor, color_map: torch.Tensor) -> torch.Tensor:
    """``table[color_map]`` as float32: a (4,) per-band table spread over
    the sites."""
    return table.to(torch.float32)[color_map.long()]


@numpy_inputs("mosaic", "color_map", "black_levels")
def safe_subtract_black(
    mosaic: torch.Tensor,
    color_map: torch.Tensor,
    black_levels: torch.Tensor,
) -> torch.Tensor:
    """Per-site black-level subtraction clamped at zero.

    The reference resets pixels below the black level to the black
    level before subtracting so uint16 cannot wrap (reference
    core/RawConv.py:269-289); in float that is exactly
    ``max(x - black, 0)``.
    """
    bl = _per_site(black_levels, color_map)
    return (to_float32(mosaic) - bl).clamp(min=0.0)


@numpy_inputs("mosaic", "color_map", "black_levels", "wb")
def raw_to_rgb(
    mosaic: torch.Tensor,
    color_map: torch.Tensor,
    black_levels: torch.Tensor,
    wb: torch.Tensor,
    white_level: float = 65535.0,
    subtract_black: bool = True,
    algorithm: str = "mhc",
) -> torch.Tensor:
    """Linear 16-bit-range RGB from a uint16 Bayer mosaic.

    Equivalent of LibRaw postprocess(gamma=(1,1), no_auto_bright,
    output_bps=16, user_wb): black subtraction, white-balance
    multipliers applied at the CFA sites, scaling so the sensor range
    [black, white_level] maps to [0, 65535], then demosaic
    (``algorithm``: 'mhc' gradient-corrected default, 'bilinear' or
    'ahd').  Output float32 (caller clips/casts; reference clips at
    core/RawConv.py:484-486).
    """
    if algorithm not in _DEMOSAIC_FUNCS:
        raise ValueError(f"unknown demosaic algorithm {algorithm!r}; "
                         f"choose from {sorted(_DEMOSAIC_FUNCS)}")
    f = to_float32(mosaic)
    white = torch.tensor(float(white_level), dtype=torch.float32,
                         device=f.device)
    if subtract_black:
        f = safe_subtract_black(f, color_map, black_levels)
        ref_black = black_levels.to(torch.float32).max()
    else:
        ref_black = torch.zeros((), dtype=torch.float32, device=f.device)
    f = f * _per_site(wb, color_map)
    scale = MAX_ADU / (white - ref_black).clamp(min=1.0)
    f = f * scale
    return _DEMOSAIC_FUNCS[algorithm](f, color_map)


@numpy_inputs("mosaic", "color_map", "black_levels", "wb")
def raw_to_grey_linear(
    mosaic: torch.Tensor,
    color_map: torch.Tensor,
    black_levels: torch.Tensor,
    wb: torch.Tensor,
    white_level: float = 65535.0,
    subtract_black: bool = True,
    algorithm: str = "mhc",
) -> torch.Tensor:
    """CCIR-601 luma of the linear RGB (reference core/RawConv.py:549-556).

    The reference rounds RGB to uint16 before the luma sum; we keep
    float32 throughout (sub-ADU difference, within test tolerance).
    The sum is three explicit terms, red first.
    """
    rgb = raw_to_rgb(mosaic, color_map, black_levels, wb, white_level,
                     subtract_black, algorithm=algorithm)
    rgb = rgb.clamp(0.0, MAX_ADU)
    return (CCIR601[0] * rgb[..., 0] + CCIR601[1] * rgb[..., 1]) \
        + CCIR601[2] * rgb[..., 2]


@numpy_inputs("mosaic", "color_map", "black_levels", "wb")
def raw_to_grey_direct(
    mosaic: torch.Tensor,
    color_map: torch.Tensor,
    black_levels: torch.Tensor,
    wb: torch.Tensor,
    subtract_black: bool = True,
) -> torch.Tensor:
    """Documented 'direct' grey: each site scaled by its band's WB factor,
    no interpolation (reference core/RawConv.py:500-501,533-547 — the
    reference implementation is broken, SURVEY.md §2.8; this implements
    the documented semantics)."""
    f = to_float32(mosaic)
    if subtract_black:
        f = safe_subtract_black(f, color_map, black_levels)
    return f * _per_site(wb, color_map)


@numpy_inputs("mosaic", "color_map", "black_levels")
def split_channels(
    mosaic: torch.Tensor,
    color_map: torch.Tensor,
    black_levels: torch.Tensor,
    subtract_black: bool = True,
) -> torch.Tensor:
    """(4, H, W) full-size per-band images, zero off-band.

    Reference split() semantics (core/RawConv.py:589-618): each output
    keeps only its band's pixels at their original positions, zero
    elsewhere, optionally black-subtracted with the wraparound guard.
    """
    f = to_float32(mosaic)
    if subtract_black:
        f = safe_subtract_black(f, color_map, black_levels)
    return torch.stack([torch.where(color_map == c, f, 0.0)
                        for c in (R, G1, B, G2)])


@numpy_inputs("mosaic_sub", "color_map", "region")
def wb_from_region(
    mosaic_sub: torch.Tensor,
    color_map: torch.Tensor,
    region: Union[torch.Tensor, Sequence[int]],
) -> torch.Tensor:
    """White balance multipliers from per-band means in a region.

    Reference _get_whitebalance_from_region (core/RawConv.py:291-366):
    per-band mean of (black-subtracted) site values inside the region
    [rowmin, rowmax, colmin, colmax] (inclusive, 0-based), then
    multipliers max(avg)/avg — brightest band gets 1.0.
    ``region`` is four host integers (or a (4,) integer tensor, read to
    the host); pass [0, H-1, 0, W-1] for 'auto'.  Sums are float32.
    """
    h, w = mosaic_sub.shape
    rmin, rmax, cmin, cmax = (int(v) for v in region)
    dev = mosaic_sub.device
    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    in_region = ((rows >= rmin) & (rows <= rmax)
                 & (cols >= cmin) & (cols <= cmax))
    avgs = []
    for c in (R, G1, B, G2):
        m = in_region & (color_map == c)
        n = m.sum().clamp(min=1)
        avgs.append(torch.where(m, mosaic_sub, 0.0).sum() / n)
    avg = torch.stack(avgs)
    return avg.max() / avg.clamp(min=1e-12)


@numpy_inputs("img")
def percentile_renorm(
    img: torch.Tensor,
    lo_pct: float = 0.01,
    hi_pct: float = 99.99,
) -> torch.Tensor:
    """Linear stretch from [p_lo, p_hi] to [0, 65535]
    (reference core/RawConv.py:462-471).  Both percentiles come from one
    sort of the image, by linear interpolation between order statistics
    with the position computed in float64."""
    srt = torch.sort(img.reshape(1, -1), dim=1).values
    lo = _percentile_sorted(srt, lo_pct)[0]
    hi = _percentile_sorted(srt, hi_pct)[0]
    return (img - lo) * (MAX_ADU / (hi - lo).clamp(min=1e-12))
