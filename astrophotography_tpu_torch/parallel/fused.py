"""The fused warp+combine over row bands, on one device
(:func:`banded_warp_combine`) or one band per rank of a mesh's 'space'
axis (:func:`sharded_warp_combine`; the JAX package's
``parallel/fused.py``).

The natural decomposition of the fused kernel is spatial: cut the image
rows into bands, give each band a row halo wide enough for the warp's
reach (dither + Lanczos support), move every frame's affine matrix into
the band's local rows, and run the identical whole-frame kernel on the
band.  The band loop runs the bands one after another and slices the
halo from the same tensor; the sharded form runs its band on each rank
and fetches the halo from the neighbours (``parallel/halo``).  Both hand
the padded band to one helper, :func:`_warp_band`, so a sharded run and
a band loop with the same band count give K2 identical inputs and agree
bit for bit.

Global-edge semantics: rows beyond the first and last band are zero, and
each band narrows the kernel's source-row coverage bounds (``v_bounds``)
to the global [2, H - 4] window, so taps never reach the zero halo: edge
rows are excluded or kept by exactly the whole-frame rule.  The snap
geometry (``snap_geom``) is the whole image's, moved into local rows, so
every band snaps a near-translation frame to the identical translation.
The result matches the whole-frame kernel to float-reassociation /
clip-tie tolerance and is bit-identical for pure translations.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.warp_combine import warp_combine
from .halo import halo_exchange_rows
from .mesh import FrameSpaceMesh


def _band_rows(x: torch.Tensor, y0: int, y1: int) -> torch.Tensor:
    """Rows ``y0:y1`` of an (C, H, W) tensor as a contiguous block, zero
    where the range leaves the image."""
    h = x.shape[1]
    lo, hi = max(y0, 0), min(y1, h)
    if (lo, hi) == (y0, y1):
        return x[:, y0:y1].contiguous()
    # uint16 is filled through an int16 view (uint16 support on CUDA
    # tensors is partial)
    as_i16 = x.dtype == torch.uint16
    src = x.view(torch.int16) if as_i16 else x
    out = torch.zeros((x.shape[0], y1 - y0, x.shape[2]), dtype=src.dtype,
                      device=x.device)
    out[:, lo - y0:hi - y0] = src[:, lo:hi]
    return out.view(torch.uint16) if as_i16 else out


def banded_warp_combine(
    frames: torch.Tensor,
    matrices: torch.Tensor,
    n_bands: int,
    masters: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    halo: int = 64,
    **kernel_kwargs,
) -> torch.Tensor:
    """Row-banded fused warp + sigma-clip combine.

    ``frames`` (N, H, W) raw uint16 / float32 (H divisible by
    ``n_bands``), ``matrices`` (N, 2, 3), ``masters`` (3, H, W) (see
    :func:`ops.warp_combine.warp_combine` for the calibration planes),
    ``halo`` rows of context on each side of a band: at least
    max |row translation| + 6.  ``kernel_kwargs`` go to
    :func:`warp_combine`, which runs once per band (the CUDA kernel on
    CUDA tensors).  Returns the (H, W) stack."""
    h = frames.shape[1]
    if n_bands < 1 or h % n_bands:
        raise ValueError(f"height {h} not divisible by n_bands {n_bands}")
    band = h // n_bands
    if halo >= band:
        raise ValueError("halo must be smaller than the band")
    out = []
    for idx in range(n_bands):
        top = idx * band - halo
        fr_pad = _band_rows(frames, top, top + band + 2 * halo)
        mast_pad = None if masters is None else \
            _band_rows(masters, top, top + band + 2 * halo)
        out.append(_warp_band(fr_pad, mast_pad, matrices, top, h, band,
                              halo, exp_ratios, **kernel_kwargs))
        del fr_pad, mast_pad
    return torch.cat(out, dim=0)


def _warp_band(fr_pad: torch.Tensor, mast_pad: Optional[torch.Tensor],
               matrices: torch.Tensor, top: int, h: int, band: int,
               halo: int, exp_ratios: Optional[torch.Tensor],
               **kernel_kwargs) -> torch.Tensor:
    """K2 on one padded band: ``fr_pad`` (N, band + 2 * halo, W) holds
    global rows ``top`` .. ``top + band + 2 * halo`` of an image of ``h``
    rows (zero beyond it), ``mast_pad`` the masters' same rows.  Returns
    the band's own ``band`` rows."""
    w = fr_pad.shape[2]
    mats = matrices.to(torch.float32)
    dev = mats.device
    cx, cy = (w - 1) * 0.5, (h - 1) * 0.5
    # local band rows: local output / source row 0 is global row yoff
    yoff = torch.tensor(float(top), dtype=torch.float32, device=dev)
    mats_local = mats.clone()
    mats_local[:, 0, 2] += mats[:, 0, 1] * yoff
    mats_local[:, 1, 2] += mats[:, 1, 1] * yoff - yoff
    # global coverage bounds in LOCAL source rows: taps stop at global
    # rows [2, H - 4] exactly as on the whole frame; interior bands see
    # bounds outside their rows
    v_bounds = torch.stack([2.0 - yoff, (h - 4.0) - yoff])
    snap_geom = torch.stack([torch.full_like(yoff, cx), cy - yoff,
                             torch.full_like(yoff, cx),
                             torch.full_like(yoff, cy)])
    res = warp_combine(fr_pad, mats_local, masters=mast_pad,
                       exp_ratios=exp_ratios, v_bounds=v_bounds,
                       snap_geom=snap_geom, **kernel_kwargs)
    return res[halo:halo + band]


def sharded_warp_combine(
    frames_local: torch.Tensor,
    matrices: torch.Tensor,
    mesh: FrameSpaceMesh,
    masters: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    halo: int = 64,
    axis_name: str = "space",
    **kernel_kwargs,
) -> torch.Tensor:
    """Row-sharded fused warp + sigma-clip combine over ``mesh``.

    ``frames_local`` (N, band, W) raw uint16 / float32 is this rank's
    row band of the (N, H, W) stack (``shard_spatial``: H = band x the
    'space' axis size), ``matrices`` (N, 2, 3) and ``exp_ratios`` (N,)
    replicated, ``masters`` (3, band, W) row-sharded like the frames (see
    :func:`ops.warp_combine.warp_combine` for the calibration planes),
    ``halo`` rows of neighbour context per side: at least
    max |row translation| + 6, and less than the band.  Exchanges the
    halo, then runs K2 on the padded band (:func:`_warp_band`, as
    :func:`banded_warp_combine` does).  Returns this rank's (band, W)
    rows of the stack."""
    band = frames_local.shape[1]
    if halo >= band:
        raise ValueError("halo must be smaller than the per-device band")
    idx = mesh.index(axis_name)
    fr_pad = halo_exchange_rows(frames_local, halo, mesh, axis_name)
    mast_pad = None if masters is None else \
        halo_exchange_rows(masters, halo, mesh, axis_name)
    return _warp_band(fr_pad, mast_pad, matrices, idx * band - halo,
                      band * mesh.size(axis_name), band, halo, exp_ratios,
                      **kernel_kwargs)
