"""Bias / dark / flat calibration of light frames (the JAX package's
``ops/calibrate.py``).

The arithmetic of the reference ApCalibrate.calibrate:
``img - bias``; ``dark - bias`` when the master dark still holds the bias
(``dark_still_biased``); the dark scaled by the light/dark exposure
ratio; then a division by the flat wherever the flat is non-zero.

This is not the lean path's ``raw * A - B - r * C`` with A = 1/flat: the
division rounds differently from a multiply by the reciprocal, so the two
stay separate.  On the card ``calibrate_batch`` is one hand-written kernel
(``csrc/calibrate.cu``); ``calibrate_batch_plain`` is its twin.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import numpy_inputs, to_float32
from .badpix import fix_bad_pixels


@numpy_inputs("img", "bias", "dark", "flat", "badpix_mask")
def calibrate_frame(
    img: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dark: Optional[torch.Tensor] = None,
    flat: Optional[torch.Tensor] = None,
    exp_ratio: float = 1.0,
    dark_still_biased: bool = True,
    badpix_mask: Optional[torch.Tensor] = None,
    deltapix: int = 2,
) -> torch.Tensor:
    """Calibrate one (H, W) frame (or, without ``badpix_mask``, a batch
    the masters broadcast against) to float32.  ``badpix_mask`` (True =
    bad) adds the masked neighbourhood-median repair within +-``deltapix``
    after the arithmetic."""
    out = to_float32(img)
    if bias is not None:
        out = out - bias
    if dark is not None:
        dark_use = dark - bias if (dark_still_biased
                                   and bias is not None) else dark
        out = out - torch.as_tensor(exp_ratio, dtype=torch.float32,
                                    device=out.device) * dark_use
    if flat is not None:
        out = torch.where(flat != 0, out / flat, out)
    if badpix_mask is not None:
        out, _ = fix_bad_pixels(out, badpix_mask, deltapix=deltapix)
    return out


@numpy_inputs("imgs", "bias", "dark", "flat", "exp_ratios", "badpix_mask")
def calibrate_batch(
    imgs: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dark: Optional[torch.Tensor] = None,
    flat: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    dark_still_biased: bool = True,
    badpix_mask: Optional[torch.Tensor] = None,
    deltapix: int = 2,
) -> torch.Tensor:
    """Calibrate an (N, H, W) stack against shared (H, W) masters;
    ``exp_ratios`` (N,) scales the dark per frame (default 1).
    ``badpix_mask`` (H, W) (True = bad) repairs every frame after the
    arithmetic, one frame at a time: a frame's neighbourhood stack is
    (2 * deltapix + 1)^2 planes.

    On a CUDA tensor the arithmetic is one hand-written kernel
    (``csrc/calibrate.cu``, one launch a call; a stack that is neither
    uint16 nor float32 is made float32 first, as the twin's first step
    does), bit for bit :func:`calibrate_batch_plain`, which CPU tensors
    run.  On the card the masters must be float32 (H, W) tensors and
    ``exp_ratios`` (N,), on the stack's device."""
    if imgs.device.type == "cpu":
        return calibrate_batch_plain(imgs, bias, dark, flat, exp_ratios,
                                     dark_still_biased, badpix_mask,
                                     deltapix)
    if imgs.device.type != "cuda":
        raise ValueError(f"no calibrate kernel for device {imgs.device}")
    from .. import kernels

    stack = (imgs if imgs.dtype in (torch.uint16, torch.float32)
             else to_float32(imgs))
    if stack.dtype == torch.float32 and bias is None and dark is None \
            and flat is None:
        out = stack                 # nothing to do, as in the twin
    else:
        out = kernels.calibrate_cuda(stack, bias, dark, flat, exp_ratios,
                                     dark_still_biased)
    return _repair(out, imgs, badpix_mask, deltapix)


@numpy_inputs("imgs", "bias", "dark", "flat", "exp_ratios", "badpix_mask")
def calibrate_batch_plain(
    imgs: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dark: Optional[torch.Tensor] = None,
    flat: Optional[torch.Tensor] = None,
    exp_ratios: Optional[torch.Tensor] = None,
    dark_still_biased: bool = True,
    badpix_mask: Optional[torch.Tensor] = None,
    deltapix: int = 2,
) -> torch.Tensor:
    """:func:`calibrate_batch` as whole-tensor PyTorch operations, one
    pass over the stack each: the twin of ``csrc/calibrate.cu``."""
    out = to_float32(imgs)
    if bias is not None:
        out = out - bias[None]
    if dark is not None:
        dark_use = dark - bias if (dark_still_biased
                                   and bias is not None) else dark
        ratios = (torch.ones(imgs.shape[0], dtype=torch.float32,
                             device=out.device)
                  if exp_ratios is None else exp_ratios.to(torch.float32))
        out = out - ratios[:, None, None] * dark_use[None]
    if flat is not None:
        out = torch.where(flat[None] != 0, out / flat[None], out)
    return _repair(out, imgs, badpix_mask, deltapix)


def _repair(out: torch.Tensor, imgs: torch.Tensor,
            badpix_mask: Optional[torch.Tensor],
            deltapix: int) -> torch.Tensor:
    """The calibrated stack ``out`` with each frame's bad pixels repaired
    (``fix_bad_pixels``), or ``out`` itself without a mask."""
    if badpix_mask is None:
        return out
    if out is imgs:                 # float32 input without masters
        out = out.clone()
    for f in range(out.shape[0]):
        out[f] = fix_bad_pixels(out[f], badpix_mask, deltapix=deltapix)[0]
    return out
