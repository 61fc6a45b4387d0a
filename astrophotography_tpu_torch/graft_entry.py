"""The port's twins of the repository's ``__graft_entry__``: the flagship
pipeline's forward step with its example inputs, and the multi-device
dry run.

``entry(device=None)`` returns ``(forward, example_args)``: ``forward``
is the unfused pipeline (``models.calibrate_register_stack`` at
``max_stars=16, match_k=8, interp='separable'``) on a bias-carrying
(N, H, W) stack, returning the stacked (H, W) image; the example is 4
frames of 128^2 with 12 stars on ``device`` (CUDA when not given), made
by the same numpy draws as the JAX entry's.

``dryrun_multichip(n_devices, ...)`` runs the JAX dry run's three steps
on ``n_devices`` ranks (``parallel.launch.spawn``) over the same
(frame, space) mesh and the same inputs: the unfused pipeline with the
frames sharded over 'frame' and the stack over 'space', the row-sharded
fused warp+combine with masters and exposure ratios, and the lean
pipeline with chunked detection; then it prints the JAX dry run's OK
line.
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


def _fused_inputs(size: int):
    """The dry run's row-sharded fused warp+combine inputs (the JAX dry
    run's ``rng(1)`` draws): 4 raw uint16 frames of a gradient, masters
    (A=1/flat, B=bias/flat, C=dark/flat), exposure ratios and
    translation matrices, as CPU tensors."""
    rng = np.random.default_rng(1)
    n_sh = 4
    h_sh, w_sh = size, min(size, 512)
    base = np.add.outer(np.linspace(0, 20, h_sh),
                        np.linspace(0, 10, w_sh)).astype(np.float32) + 500.0
    fr = np.clip(np.stack([base + i for i in range(n_sh)]) + 100.0, 0,
                 65535).astype(np.uint16)
    flat = np.full((h_sh, w_sh), 1.0, np.float32)
    bias_m = np.full((h_sh, w_sh), 100.0, np.float32)
    dark_m = np.full((h_sh, w_sh), 2.0, np.float32)
    masters = np.stack([1.0 / flat, bias_m / flat, dark_m / flat])
    exp_ratios = np.linspace(0.8, 1.2, n_sh).astype(np.float32)
    mats = []
    for f in range(n_sh):
        tx, ty = (0.0, 0.0) if f == 0 else rng.uniform(-3, 3, 2)
        mats.append([[1.0, 0.0, tx], [0.0, 1.0, ty]])
    return {"frames": torch.from_numpy(fr),
            "masters": torch.from_numpy(masters),
            "exp_ratios": torch.from_numpy(exp_ratios),
            "matrices": torch.from_numpy(np.asarray(mats, np.float32))}


def _dryrun_rank(device, f_dim: int, s_dim: int, inputs: dict) -> dict:
    """One rank of the dry run: the three steps on a (f_dim, s_dim)
    mesh; returns the shapes, the inliers and the kernel launches."""
    from . import kernels
    from .models import PipelineConfig
    from .parallel.mesh import (frame_space_mesh, gather_rows, local_frames,
                                replicate, shard_spatial)
    from .parallel.sharded import (sharded_calibrate_register_stack,
                                   sharded_calibrate_register_stack_lean)
    from .parallel.fused import sharded_warp_combine

    kernels.reset_launch_counts()
    mesh = frame_space_mesh(f_dim, s_dim, device=device)
    cfg = PipelineConfig(max_stars=16, match_k=8, interp="separable")
    stacked, diag = sharded_calibrate_register_stack(
        local_frames(mesh, inputs["frames"]), mesh,
        bias=replicate(mesh, inputs["bias"]), config=cfg)
    stacked = gather_rows(mesh, stacked)

    fz = inputs["fused"]
    w_sh = fz["frames"].shape[2]
    fused = gather_rows(mesh, sharded_warp_combine(
        shard_spatial(mesh, fz["frames"]), replicate(mesh, fz["matrices"]),
        mesh, halo=12, masters=shard_spatial(mesh, fz["masters"]),
        exp_ratios=replicate(mesh, fz["exp_ratios"]), tile=(16, w_sh),
        axis_name="space"))

    lean_size = inputs["raw_lean"].shape[1]
    lean_cfg = PipelineConfig(max_stars=16, match_k=8,
                              detect_mode="chunked", detect_chunk=2,
                              detect_topk="tile", detect_fast=True,
                              fused_tile=(16, min(lean_size, 512)))
    lean_out, lean_diag = sharded_calibrate_register_stack_lean(
        local_frames(mesh, inputs["raw_lean"]), mesh,
        bias=replicate(mesh, inputs["bias_lean"]), config=lean_cfg)
    lean_out = gather_rows(mesh, lean_out)
    finite = all(bool(torch.isfinite(t).all())
                 for t in (stacked, fused, lean_out))
    return {"mesh": dict(mesh.shape), "transport": mesh.transport,
            "stacked": tuple(stacked.shape), "inliers":
            diag["n_inliers"].tolist(), "fused": tuple(fused.shape),
            "lean": tuple(lean_out.shape),
            "lean_inliers": lean_diag["n_inliers"].tolist(),
            "finite": finite, "launches": dict(kernels.launch_counts)}


def dryrun_multichip(n_devices: int, size: int = 512,
                     n_frames: "int | None" = None,
                     lean_size: "int | None" = None, device=None) -> list:
    """The FULL pipeline step on an ``n_devices`` mesh of ranks, one run
    (the twin of ``__graft_entry__.dryrun_multichip``).

    Mesh: (2, n_devices / 2) when ``n_devices`` is even, else
    (1, n_devices).  ``size`` is the square frame edge of the unfused
    pipeline and of the fused kernel step; ``n_frames`` defaults to 2
    frames per 'frame' rank; ``lean_size`` (default min(size, 256)) sizes
    the lean pipeline.  The ranks run on ``device`` (CUDA when not
    given; the CPU only when asked for), over NCCL when every rank has a
    card of its own and over host-staged gloo otherwise.  Prints the
    transport and the JAX dry run's OK line; returns every rank's
    summary (shapes, inliers, kernel launches)."""
    from .parallel.launch import default_transport, spawn

    dev = resolve_device(device)
    f_dim = 2 if n_devices % 2 == 0 else 1
    s_dim = n_devices // f_dim
    if n_frames is None:
        n_frames = 2 * f_dim
    if size % (8 * s_dim):
        raise ValueError(f"size {size} must divide evenly into "
                         f"8-row-aligned bands across {s_dim} shards")
    if lean_size is None:
        lean_size = min(size, 256)
    if lean_size % (8 * s_dim):
        raise ValueError(f"lean_size {lean_size} must divide evenly into "
                         f"8-row-aligned bands across {s_dim} shards")
    frames, bias = _example_inputs(n_frames=n_frames, size=size,
                                   device="cpu")
    lean_frames, bias_lean = _example_inputs(n_frames=n_frames,
                                             size=lean_size, device="cpu")
    raw_lean = torch.from_numpy(np.clip(lean_frames.numpy(), 0, 65535)
                                .astype(np.uint16))
    inputs = {"frames": frames, "bias": bias, "fused": _fused_inputs(size),
              "raw_lean": raw_lean, "bias_lean": bias_lean}
    transport = default_transport(dev, n_devices)
    print(f"dryrun_multichip: {n_devices} ranks on {dev.type}, transport "
          f"{transport}", flush=True)
    ranks = spawn(_dryrun_rank, n_devices, device=dev, transport=transport,
                  args=(f_dim, s_dim, inputs))
    r0 = ranks[0]
    if r0["stacked"] != (size, size) or r0["lean"] != (lean_size,
                                                        lean_size):
        raise RuntimeError(f"dry run shapes {r0}")
    if r0["fused"] != (size, min(size, 512)):
        raise RuntimeError(f"dry run fused shape {r0['fused']}")
    if not all(r["finite"] for r in ranks):
        raise RuntimeError("dry run: a stack is not finite")
    print(f"dryrun_multichip OK: mesh {r0['mesh']}, "
          f"stacked {r0['stacked']}, inliers {r0['inliers']}, "
          f"sharded-fused-with-masters {r0['fused']}, "
          f"lean-sharded {r0['lean']}, "
          f"lean inliers {r0['lean_inliers']}", flush=True)
    return ranks


def entry(device=None):
    """(fn, example_args): the forward step of the flagship pipeline."""
    from .models import PipelineConfig, calibrate_register_stack

    cfg = PipelineConfig(max_stars=16, match_k=8, interp="separable")

    def forward(frames, bias):
        stacked, _diag = calibrate_register_stack(frames, bias=bias,
                                                  config=cfg)
        return stacked

    return forward, _example_inputs(device=device)
