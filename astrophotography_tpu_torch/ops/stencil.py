"""2-D correlation with a small static kernel (the JAX package's
``ops/stencil.py``): statically shifted multiply-adds over a padded
image, with zero, edge or reflect padding."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_PAD_MODES = {"edge": "replicate", "reflect": "reflect"}


def conv2d_static(img: torch.Tensor, kernel, pad_mode: str = "zero",
                  skip_zero_taps: bool = True) -> torch.Tensor:
    """Correlation of ``img`` (..., H, W) with a host-side ``kernel``
    (nested sequence or ndarray of floats, odd sizes).  ``pad_mode`` is
    'zero', 'edge' or 'reflect'.  Taps are accumulated in dy-major
    order; zero taps are skipped when ``skip_zero_taps``."""
    kh = len(kernel)
    kw = len(kernel[0])
    h, w = img.shape[-2:]
    pads = (kw // 2, kw // 2, kh // 2, kh // 2)
    if pad_mode == "zero":
        padded = F.pad(img, pads)
    elif pad_mode in _PAD_MODES:
        # replicate / reflect pad the last two dims of a 3-D input
        flat = img.reshape(-1, h, w)
        padded = F.pad(flat, pads, mode=_PAD_MODES[pad_mode]).reshape(
            *img.shape[:-2], h + 2 * (kh // 2), w + 2 * (kw // 2))
    else:
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    out = torch.zeros_like(img)
    for dy in range(kh):
        for dx in range(kw):
            k = float(kernel[dy][dx])
            if k == 0.0 and skip_zero_taps:
                continue
            out = out + k * padded[..., dy:dy + h, dx:dx + w]
    return out
