"""Colour compositing: stretch and channel combination (the JAX
package's ``ops/composite.py``): per-channel linear range from
percentiles, then an asinh (Lupton) or gamma intensity mapping, to
uint8 / uint16 RGB ready for TIFF or PNG output."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import numpy_inputs, resolve_device, to_float32


def _percentile(rows: torch.Tensor, pct: float) -> torch.Tensor:
    """:func:`_percentile_sorted` of unsorted rows."""
    return _percentile_sorted(torch.sort(rows, dim=1).values, pct)


def _percentile_sorted(srt: torch.Tensor, pct: float) -> torch.Tensor:
    """``pct``-th percentile of each row of an (C, M) float32 tensor whose
    rows are sorted ascending, by linear interpolation between the two
    nearest order statistics (numpy's 'linear' method).  The position
    pct / 100 * (M - 1) is computed in float64 as numpy does; in float32
    it would be off by up to an index on a 16-megapixel channel.
    ``torch.quantile`` is avoided: it limits the input size and
    interpolates in another order.  NaN for a row that holds a NaN."""
    m = srt.shape[1]
    pos = min(max(pct / 100.0 * (m - 1), 0.0), m - 1.0)
    low = int(math.floor(pos))
    high = min(low + 1, m - 1)
    high_w = pos - low
    out = srt[:, low] * (1.0 - high_w) + srt[:, high] * high_w
    return torch.where(torch.isnan(srt[:, -1]), torch.nan, out)


@numpy_inputs("channels")
def stretch_channels(
    channels: torch.Tensor,
    black_pct: float = 0.5,
    white_pct: float = 99.8,
    gamma: float = 2.2,
    asinh_q: float = 8.0,
    mode: str = "asinh",
) -> torch.Tensor:
    """(3, H, W) linear channels -> (H, W, 3) stretched in [0, 1].

    * 'asinh': Lupton-style, a shared luminance asinh stretch that
      preserves colour ratios;
    * 'gamma': independent per-channel power law (stiff's default
      GAMMA 2.2 behaviour);
    * 'linear': percentile window only."""
    if mode not in ("asinh", "gamma", "linear"):
        raise ValueError(f"unknown stretch mode {mode!r}")
    chans = to_float32(channels)
    rows = chans.reshape(3, -1)
    srt = torch.sort(rows, dim=1).values        # one sort, two reads
    lo = _percentile_sorted(srt, black_pct)
    hi = _percentile_sorted(srt, white_pct)
    scaled = (chans - lo[:, None, None]) \
        / (hi - lo)[:, None, None].clamp(min=1e-9)
    scaled = scaled.clamp(min=0.0)
    if mode == "asinh":
        lum = scaled.mean(dim=0)
        q = torch.tensor(asinh_q, dtype=torch.float32, device=chans.device)
        factor = torch.asinh(q * lum) / (lum.clamp(min=1e-9) * torch.asinh(q))
        out = scaled * factor[None]
    elif mode == "gamma":
        out = torch.pow(scaled.clamp(0.0, 1.0), 1.0 / gamma)
    else:
        out = scaled
    return out.permute(1, 2, 0).clamp(0.0, 1.0)


def compose_rgb(
    r, g, b,
    mode: str = "asinh",
    black_pct: float = 0.5,
    white_pct: float = 99.8,
    gamma: float = 2.2,
    asinh_q: float = 8.0,
    bits: int = 8,
    device=None,
) -> np.ndarray:
    """Three channel images -> uint8 / uint16 (H, W, 3) numpy composite.
    Tensors are stretched on their device; numpy arrays go to ``device``
    (CUDA when not given) first."""
    if not all(isinstance(c, torch.Tensor) for c in (r, g, b)):
        dev = resolve_device(device)
        r, g, b = (torch.as_tensor(np.asarray(c)).to(dev) for c in (r, g, b))
    out = stretch_channels(torch.stack([to_float32(c) for c in (r, g, b)]),
                           black_pct=black_pct, white_pct=white_pct,
                           gamma=gamma, asinh_q=asinh_q, mode=mode)
    out = out.cpu().numpy()
    if bits == 8:
        return np.clip(np.round(out * 255), 0, 255).astype(np.uint8)
    return np.clip(np.round(out * 65535), 0, 65535).astype(np.uint16)
