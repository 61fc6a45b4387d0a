"""The port's twin of the repository's ``__graft_entry__.entry``: the
flagship pipeline's forward step and its example inputs.

``entry(device=None)`` returns ``(forward, example_args)``: ``forward``
is the unfused pipeline (``models.calibrate_register_stack`` at
``max_stars=16, match_k=8, interp='separable'``) on a bias-carrying
(N, H, W) stack, returning the stacked (H, W) image; the example is 4
frames of 128^2 with 12 stars on ``device`` (CUDA when not given), made
by the same numpy draws as the JAX entry's.  The multi-device dry run
(``dryrun_multichip``) has no twin yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _example_inputs(n_frames: int = 4, size: int = 128, device=None):
    """(frames + bias, bias) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    base = np.full((size, size), 500.0, np.float32)
    for x, y, f in zip(rng.uniform(20, size - 20, 12),
                       rng.uniform(20, size - 20, 12),
                       rng.uniform(20000, 60000, 12)):
        yy, xx = np.mgrid[0:size, 0:size]
        sig = 3.0 / 2.35482
        base += f / (2 * np.pi * sig ** 2) * np.exp(
            -((xx - x) ** 2 + (yy - y) ** 2) / (2 * sig ** 2))
    frames = np.stack([
        base + rng.normal(0, 5.0, (size, size)) for _ in range(n_frames)
    ]).astype(np.float32)
    bias = np.full((size, size), 100.0, np.float32)
    return (torch.from_numpy(frames + bias[None]).to(dev),
            torch.from_numpy(bias).to(dev))


def entry(device=None):
    """(fn, example_args): the forward step of the flagship pipeline."""
    from .models import PipelineConfig, calibrate_register_stack

    cfg = PipelineConfig(max_stars=16, match_k=8, interp="separable")

    def forward(frames, bias):
        stacked, _diag = calibrate_register_stack(frames, bias=bias,
                                                  config=cfg)
        return stacked

    return forward, _example_inputs(device=device)
