"""The two stacking pipelines on a (frame, space) mesh: the collectives
that GSPMD inserts into the JAX package's pipelines, written out.

The JAX package runs ``calibrate_register_stack`` and
``calibrate_register_stack_lean`` under ``jax.jit`` with the frames
sharded over 'frame' (``P("frame", None, None)``) and the stack
constrained to rows over 'space' (``P("space", None)``).  Here each rank
holds its frame block with every row (``mesh.local_frames``) and
returns its row band of the stack (``mesh.gather_rows`` assembles it);
the diagnostics are replicated.  Per rank:

1. calibration, noise statistics and detection on its own frames (the
   lean path runs K1 there);
2. ``all_gather`` of the Stars tables over 'frame', in global frame
   order: ``ref_frame='auto'`` takes the argmax over all frames;
3. the similarity solve on the whole table, on every rank (it is cheap,
   and every rank gets the same matrices);
4. unfused: its frames warped onto its 'space' band (``warp_band``),
   the warped band and the coverage mask gathered over 'frame', the
   combine (``combine_band``: K3 for 'average'), ``config.n_bands``
   sub-bands at a time; under ``combine_impl='fused'`` the calibrated
   rows of its band gathered over 'frame', then
   :func:`parallel.fused.sharded_warp_combine` (K2) on them with the
   halo the solved matrices need (:func:`lean_halo`);
   lean: the raw rows of its band gathered over 'frame', then
   :func:`parallel.fused.sharded_warp_combine` (K2) over 'space' with
   its halo exchange.

A rank's local sizes must divide as the one-device path requires
(``detect_chunk``, ``n_bands``).  The result equals the one-device
pipeline's up to the float32 rounding of the band offsets (the clip-tie
rule of the band loop), and bit for bit the one-device run that warps
the same bands (``n_bands`` times the 'space' size, or
``banded_warp_combine`` at the same halo for 'fused').
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..device import on_device
from ..models.config import PipelineConfig
from ..models.pipeline import (_solve_frame_similarities, band_matrices,
                               combine_band, detect_calibrated, detect_lean,
                               diagnostics, lean_kernel_kwargs, lean_masters,
                               warp_band)
from ..ops.calibrate import calibrate_batch
from ..ops.detect import Stars
from ..ops.register import REJECTED_TRANSLATION
from .fused import sharded_warp_combine
from .mesh import FrameSpaceMesh, all_gather

#: rows beyond the warp's displacement that Lanczos3 taps reach
_TAP_ROWS = 6


def _gather_stars(mesh: FrameSpaceMesh, stars: Stars) -> Stars:
    """Every frame's Stars table, in global frame order, in one
    exchange (the fields packed as float32)."""
    packed = torch.stack([*stars[:6], stars.valid.to(torch.float32)], dim=1)
    full = all_gather(mesh, packed, "frame")
    return Stars(*full[:, :6].unbind(1), valid=full[:, 6] > 0.5)


def _geometry(frames_local: torch.Tensor, mesh: FrameSpaceMesh):
    """(n, first global frame of this rank, h, w, band rows, first band
    row) of a frame-sharded (N_local, H, W) block."""
    n_local, h, w = frames_local.shape
    ns = mesh.size("space")
    if h % ns:
        raise ValueError(f"height {h} not divisible by space axis {ns}")
    band = h // ns
    return (n_local * mesh.size("frame"), mesh.index("frame") * n_local, h,
            w, band, mesh.index("space") * band)


def _replicated(x, dev, n: int, name: str) -> Optional[torch.Tensor]:
    t = on_device(x, dev, torch.float32)
    if t is not None and tuple(t.shape) != (n,):
        raise ValueError(f"{name} must be the replicated ({n},) vector, "
                         f"got {tuple(t.shape)}")
    return t


def sharded_calibrate_register_stack(
    frames_local: torch.Tensor,
    mesh: FrameSpaceMesh,
    bias: Optional[torch.Tensor] = None,
    dark: Optional[torch.Tensor] = None,
    flat: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    badpix_mask: Optional[torch.Tensor] = None,
    flux_scales: Optional[torch.Tensor] = None,
    config: PipelineConfig = PipelineConfig(),
):
    """The unfused pipeline (``models.calibrate_register_stack``) on
    ``mesh``: ``frames_local`` (N / n_frame, H, W) is this rank's frame
    block; the masters and ``badpix_mask`` (H, W), ``exp_ratios`` and
    ``flux_scales`` (N,) are replicated.  The bad-pixel repair works frame
    by frame and the flux scales multiply the calibrated frames, as on
    one device.  ``config.combine_impl`` is 'xla', 'pallas' or 'fused'
    (K2 on the calibrated band with its halo; ``n_bands`` must be 1).

    Returns (this rank's (H / n_space, W) rows of the stack, the
    replicated diagnostics of the whole stack; under 'fused' with the
    ``halo``)."""
    dev = frames_local.device
    n, f0, h, w, band, y0 = _geometry(frames_local, mesh)
    n_local = frames_local.shape[0]
    fused = config.combine_impl == "fused"
    if fused and config.n_bands > 1:
        raise ValueError("combine_impl='fused' subsumes banding; "
                         "use n_bands=1")
    n_bands = max(config.n_bands, 1)
    if band % n_bands:
        raise ValueError(f"band height {band} not divisible by n_bands "
                         f"{n_bands}")
    bias, dark, flat = (on_device(m, dev, torch.float32)
                        for m in (bias, dark, flat))
    er = _replicated(exp_ratios, dev, n, "exp_ratios")
    fs = _replicated(flux_scales, dev, n, "flux_scales")
    cal = calibrate_batch(frames_local, bias, dark, flat,
                          None if er is None else er[f0:f0 + n_local],
                          dark_still_biased=config.dark_still_biased,
                          badpix_mask=on_device(badpix_mask, dev))
    if fs is not None:
        cal = cal * fs[f0:f0 + n_local, None, None]
    stars = _gather_stars(mesh, detect_calibrated(cal, config))
    sims, matrices, ref_idx = _solve_frame_similarities(stars, n, config)
    diag = diagnostics(stars, sims, matrices, ref_idx)
    if fused:
        halo = lean_halo(matrices, h, w, band)
        cal_band = all_gather(mesh, cal[:, y0:y0 + band], "frame")
        del cal
        stacked = sharded_warp_combine(
            cal_band, matrices, mesh, halo=halo, axis_name="space",
            **lean_kernel_kwargs(config, h, w))
        diag["halo"] = halo
        return stacked, diag
    mats_local = matrices[f0:f0 + n_local]
    sub = band // n_bands
    rows = []
    for b in range(n_bands):
        warped, weights = warp_band(
            cal, band_matrices(mats_local, float(y0 + b * sub)), sub, config)
        warped = all_gather(mesh, warped, "frame")
        # the combine reads only coverage > 0.5: send it as bytes
        covered = all_gather(mesh, (weights > 0.5).to(torch.uint8), "frame")
        rows.append(combine_band(warped, covered.to(torch.float32), config))
        del warped, weights, covered
    return torch.cat(rows, dim=0), diag


def _row_reach(matrices: torch.Tensor, h: int, w: int) -> float:
    """Largest |source row - output row| over the image of any frame
    that registered (an affine map's extremes are at the corners; a
    rejected frame is moved out of the field and covers nothing)."""
    xs = torch.tensor([0.0, w - 1.0, 0.0, w - 1.0], device=matrices.device)
    ys = torch.tensor([0.0, 0.0, h - 1.0, h - 1.0], device=matrices.device)
    m = matrices[:, 1].to(torch.float32)
    disp = m[:, 0:1] * xs + (m[:, 1:2] - 1.0) * ys + m[:, 2:3]
    kept = matrices[:, :, 2].abs().amax(dim=1) < 0.5 * REJECTED_TRANSLATION
    return float(torch.where(kept[:, None], disp.abs(), 0.0).max())


def lean_halo(matrices: torch.Tensor, h: int, w: int, band: int) -> int:
    """The row halo a 'space' band of ``band`` rows needs for the warp of
    an (H, W) image by ``matrices``: the rows' reach plus the taps,
    rounded up to 8 and kept below the band.  Raises ``ValueError`` when
    the frames move further than a band can hold."""
    need = math.ceil(_row_reach(matrices, h, w)) + _TAP_ROWS
    if need >= band:
        raise ValueError(f"band of {band} rows too small: the solved "
                         f"matrices move rows by up to {need - _TAP_ROWS} "
                         f"px, and the taps reach {_TAP_ROWS} rows further")
    return min(-(-need // 8) * 8, band - 1)


def sharded_calibrate_register_stack_lean(
    frames_local: torch.Tensor,
    mesh: FrameSpaceMesh,
    bias: Optional[torch.Tensor] = None,
    dark: Optional[torch.Tensor] = None,
    flat: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    flux_scales: Optional[torch.Tensor] = None,
    config: PipelineConfig = PipelineConfig(),
):
    """The lean pipeline (``models.calibrate_register_stack_lean``) on
    ``mesh``: ``frames_local`` (N / n_frame, H, W) raw is this rank's
    frame block, the masters (H, W), ``exp_ratios`` and ``flux_scales``
    (N,) are replicated.  Each 'space' band gets the row halo the solved
    matrices need (:func:`lean_halo`).

    Returns (this rank's (H / n_space, W) rows of the stack, the
    replicated diagnostics of the whole stack, with the ``halo``)."""
    dev = frames_local.device
    n, f0, h, w, band, y0 = _geometry(frames_local, mesh)
    n_local = frames_local.shape[0]
    bias, dark, flat = (on_device(m, dev, torch.float32)
                        for m in (bias, dark, flat))
    er = _replicated(exp_ratios, dev, n, "exp_ratios")
    if er is None:
        er = torch.ones((n,), dtype=torch.float32, device=dev)
    fs = _replicated(flux_scales, dev, n, "flux_scales")

    stars = _gather_stars(mesh, detect_lean(
        frames_local, bias, dark, flat, er[f0:f0 + n_local], config))
    sims, matrices, ref_idx = _solve_frame_similarities(stars, n, config)
    halo = lean_halo(matrices, h, w, band)
    raw_band = all_gather(mesh, frames_local[:, y0:y0 + band], "frame")
    masters = lean_masters(bias, dark, flat, config, h, w, dev)
    stacked = sharded_warp_combine(
        raw_band, matrices, mesh, masters=masters[:, y0:y0 + band],
        exp_ratios=er, halo=halo, axis_name="space", flux_scales=fs,
        **lean_kernel_kwargs(config, h, w))
    diag = diagnostics(stars, sims, matrices, ref_idx)
    del diag["matrices"]                # as the one-device lean path
    diag["halo"] = halo
    return stacked, diag
