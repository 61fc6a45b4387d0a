"""L.A.Cosmic cosmic-ray detection and removal with a fixed number of
iterations (the JAX package's ``ops/cosmic.py``).

van Dokkum (2001) with astroscrappy's structure; per iteration:

1. 2x block-replicated subsampling, 3x3 Laplacian, negative clip, 2x2
   block average back (L+); S = L+ / (2 noise) with noise =
   sqrt(median5(img) + rn^2); S' = S - median5(S);
2. fine-structure image: base = convolve(img, psf) (fsmode='convolve')
   or median3(img) (fsmode='median', the paper's original);
   F = (base - median7(base)) / noise, floored at 0.01; candidates need
   S' > sigclip AND S'/F > objlim: the F test rejects genuine point
   sources, whose fine structure is PSF-like;
3. two-stage neighbour growth: dilate once gated at the full sigclip,
   then dilate gated at sigclip * sigfrac;
4. saturated stars are excluded; masked pixels are replaced by the 5x5
   median of their unmasked neighbours.

The cumulative CR mask and the cleaned image are returned.  Every median
filter is a sort over a stack of shifted planes (49 planes for the 7x7
one), freed before the next is built.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import numpy_inputs, to_float32
from .stats import masked_median
from .stencil import conv2d_static


def _edge_pad(img: torch.Tensor, half: int) -> torch.Tensor:
    return F.pad(img[None], (half, half, half, half), mode="replicate")[0]


def _shift_stack(padded: torch.Tensor, h: int, w: int, size: int
                 ) -> torch.Tensor:
    return torch.stack([padded[dy:dy + h, dx:dx + w]
                        for dy in range(size) for dx in range(size)])


def _median_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    """size x size median filter with edge clamping (size odd)."""
    h, w = img.shape
    stack = _shift_stack(_edge_pad(img, size // 2), h, w, size)
    k = size * size
    srt = torch.sort(stack, dim=0).values
    del stack
    return 0.5 * (srt[(k - 1) // 2] + srt[k // 2]) if k % 2 == 0 \
        else srt[k // 2].clone()


def _masked_median_filter(img: torch.Tensor, good: torch.Tensor,
                          size: int) -> torch.Tensor:
    """size x size median over the ``good`` pixels inside the image; NaN
    where there is none."""
    h, w = img.shape
    half = size // 2
    vals = _shift_stack(_edge_pad(img, half), h, w, size)
    ok = _shift_stack(F.pad(good, (half, half, half, half), value=False),
                      h, w, size)
    return masked_median(vals, ok, axis=0)


def _laplacian_subsampled(img: torch.Tensor) -> torch.Tensor:
    """L+ of van Dokkum: the Laplacian on the 2x-supersampled image,
    clipped at zero, block-averaged back."""
    h, w = img.shape
    up = img.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    padded = _edge_pad(up, 1)
    lap = (4.0 * up
           - padded[0:-2, 1:-1] - padded[2:, 1:-1]
           - padded[1:-1, 0:-2] - padded[1:-1, 2:])
    lap = lap.clamp(min=0.0)
    return lap.reshape(h, 2, w, 2).mean(dim=(1, 3)) * 2.0


def _gaussian_psf_kernel(fwhm: float, size: int) -> np.ndarray:
    """Normalized 2-D Gaussian PSF template (astroscrappy gausskernel)."""
    sigma = fwhm / 2.35482
    half = size // 2
    yy, xx = np.mgrid[-half:half + 1, -half:half + 1]
    k = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _conv_static(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Static-stencil convolution, edge-padded (see ops/stencil.py)."""
    return conv2d_static(img, kernel, pad_mode="edge")


def _dilate3(mask: torch.Tensor) -> torch.Tensor:
    h, w = mask.shape
    p = F.pad(mask, (1, 1, 1, 1), value=False)
    out = torch.zeros_like(mask)
    for dy in range(3):
        for dx in range(3):
            out = out | p[dy:dy + h, dx:dx + w]
    return out


@numpy_inputs("img_adu")
def lacosmic(
    img_adu: torch.Tensor,
    gain: float = 1.0,
    readnoise: float = 12.0,
    sigclip: float = 4.5,
    sigfrac: float = 0.3,
    objlim: float = 5.0,
    satlevel_e: float = 65535.0,
    niter: int = 6,
    fsmode: str = "convolve",
    psffwhm: float = 3.5,
    psfsize: int = 7,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Clean cosmic rays; returns (cleaned ADU image, CR mask bool).

    The defaults are astroscrappy's as ccdproc calls it, with
    ``fsmode='convolve'`` and a Gaussian PSF template (fwhm 3.5,
    size 7).  ``satlevel_e`` is in electrons (gain * 65535 for a 16-bit
    sensor).  ``fsmode='median'`` selects the paper's original median
    fine-structure image."""
    if fsmode not in ("convolve", "median"):
        raise ValueError(f"fsmode must be 'convolve' or 'median', "
                         f"got {fsmode!r}")
    dev = img_adu.device
    gain_t = torch.tensor(gain, dtype=torch.float32, device=dev)
    clean = to_float32(img_adu) * gain_t
    rn2 = float(np.float32(readnoise) ** 2)
    psfk = _gaussian_psf_kernel(psffwhm, psfsize) \
        if fsmode == "convolve" else None

    # saturated stars (and their halos) are never cosmic rays, but only
    # EXTENDED saturated structure qualifies (the 5x5 median must also be
    # high), else a very bright single-pixel hit above satlevel would
    # protect itself
    sat_t = float(np.float32(satlevel_e))
    sat = (clean > sat_t) & (_median_filter(clean, 5) > sat_t / 10.0)
    not_sat = ~_dilate3(_dilate3(sat))
    crmask = torch.zeros_like(clean, dtype=torch.bool)

    for _ in range(niter):
        lplus = _laplacian_subsampled(clean)
        noise = torch.sqrt(_median_filter(clean, 5).clamp(min=1e-5) + rn2)
        s = lplus / (2.0 * noise)
        del lplus
        sprime = s - _median_filter(s, 5)
        del s
        base = _conv_static(clean, psfk) if fsmode == "convolve" \
            else _median_filter(clean, 3)
        fine = ((base - _median_filter(base, 7)) / noise).clamp(min=0.01)
        del base, noise
        candidate = (sprime > sigclip) & (sprime / fine > objlim) & not_sat
        del fine
        # two-stage neighbour growth: dilation gated at the full
        # sigclip, then at sigclip * sigfrac
        grown = candidate | (_dilate3(candidate) & (sprime > sigclip)
                             & not_sat)
        grown = grown | (_dilate3(grown) & (sprime > sigclip * sigfrac)
                         & not_sat)
        del sprime
        crmask = crmask | grown
        # an empty neighbourhood gives NaN: the pixel keeps its value
        repl = _masked_median_filter(clean, ~crmask, 5)
        repl = torch.where(torch.isnan(repl), clean, repl)
        clean = torch.where(grown, repl, clean)
    return clean / gain_t, crmask
