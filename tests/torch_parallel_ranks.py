"""Rank programs for the port's multi-device tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_gpu.py`` and the
import-isolation test).  ``parallel.launch.spawn`` pickles a rank
function by its import path, so they live in a module of their own that
imports no JAX: each rank is a fresh interpreter that loads only this
module, ``torch`` and the port."""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.models import PipelineConfig
from astrophotography_tpu_torch.parallel.fused import sharded_warp_combine
from astrophotography_tpu_torch.parallel.halo import (halo_exchange_rows,
                                                      sharded_map_overlap)
from astrophotography_tpu_torch.parallel.mesh import (
    frame_space_mesh, gather_rows, local_frames, replicate, shard_frames,
    shard_spatial)
from astrophotography_tpu_torch.parallel.sharded import (
    sharded_calibrate_register_stack, sharded_calibrate_register_stack_lean)


def box5(x: torch.Tensor) -> torch.Tensor:
    """5x5 box mean of an (H, W) image with zero padding."""
    h, w = x.shape
    p = torch.nn.functional.pad(x, (2, 2, 2, 2))
    acc = torch.zeros_like(x)
    for dy in range(5):
        for dx in range(5):
            acc = acc + p[dy:dy + h, dx:dx + w]
    return acc / 25.0


def _error(fn) -> str:
    """The message of the ValueError ``fn()`` raises ('' if none)."""
    try:
        fn()
    except ValueError as exc:
        return str(exc)
    return ""


def _warp_case(mesh, case: dict) -> torch.Tensor:
    """One ``sharded_warp_combine`` case, gathered to the whole image."""
    masters = case.get("masters")
    out = sharded_warp_combine(
        shard_spatial(mesh, case["frames"]),
        replicate(mesh, case["matrices"]), mesh,
        masters=None if masters is None else shard_spatial(mesh, masters),
        exp_ratios=None if case.get("exp_ratios") is None
        else replicate(mesh, case["exp_ratios"]),
        halo=case["halo"], **case["kw"])
    return gather_rows(mesh, out)


def _diag(diag: dict) -> dict:
    return {k: diag[k] for k in ("scale", "theta", "tx", "ty", "n_inliers",
                                 "rms", "n_stars", "ref_frame")}


def _replicated(mesh, kw: dict) -> dict:
    return {k: replicate(mesh, v) for k, v in kw.items()}


def parity_rank(device, inp: dict) -> dict:
    """Every CPU parity check's sharded half, on 4 ranks: a 1x4 mesh, a
    2x2 mesh and the default mesh, then the exchanges, the warp+combine
    cases and both pipelines.  Returns what the parent compares."""
    res = {"mesh_error": _error(lambda: frame_space_mesh(3, 2, device=device))}
    row = frame_space_mesh(1, 4, device=device)
    sq = frame_space_mesh(2, 2, device=device)
    flat = frame_space_mesh(device=device)
    res["meshes"] = [(m.shape, m.coords, m.axis_ranks("frame"),
                      m.axis_ranks("space"), m.transport)
                     for m in (row, sq, flat)]
    grid = inp["grid"]
    res["placement"] = {"shard_frames": shard_frames(sq, grid),
                        "shard_spatial": shard_spatial(sq, grid),
                        "replicate": replicate(sq, grid),
                        "local_frames": local_frames(sq, grid)}
    res["split_error"] = _error(lambda: shard_spatial(row, grid[:, :30]))
    res["halo_u16"] = halo_exchange_rows(shard_spatial(row, inp["u16"]), 3,
                                         row)
    res["halo_traffic"] = list(row.traffic)
    res["stencil"] = gather_rows(row, sharded_map_overlap(box5, row, 2)(
        shard_spatial(row, inp["image"])))
    res["warp_row"] = [_warp_case(row, c) for c in inp["warp_row"]]
    res["warp_sq"] = [_warp_case(sq, c) for c in inp["warp_sq"]]
    bad = inp["warp_row"][0]
    res["halo_error"] = _error(lambda: _warp_case(row, {**bad, "halo": 64}))

    unf = inp["unfused"]
    res["unfused"] = []
    for cfg in unf["configs"]:
        out, diag = sharded_calibrate_register_stack(
            local_frames(sq, unf["frames"]), sq,
            **_replicated(sq, unf["masters"]), config=PipelineConfig(**cfg))
        res["unfused"].append((gather_rows(sq, out), _diag(diag)))
    res["unfused_band_error"] = _error(
        lambda: sharded_calibrate_register_stack(
            local_frames(sq, unf["frames"]), sq,
            config=PipelineConfig(n_bands=3)))
    res["fused_band_error"] = _error(
        lambda: sharded_calibrate_register_stack(
            local_frames(sq, unf["frames"]), sq,
            config=PipelineConfig(combine_impl="fused", n_bands=2)))
    # the repair and the flux scales, under each combine
    ext = unf["extras"]
    res["unfused_extras"] = []
    for cfg in ext["configs"]:
        out, diag = sharded_calibrate_register_stack(
            local_frames(sq, ext["frames"]), sq,
            **_replicated(sq, {**unf["masters"], "badpix_mask": ext["badpix"],
                               "flux_scales": ext["flux_scales"]}),
            config=PipelineConfig(**cfg))
        res["unfused_extras"].append((gather_rows(sq, out), _diag(diag),
                                      diag["matrices"], diag.get("halo")))
    res["lean"] = []
    for case in inp["lean"]:
        out, diag = sharded_calibrate_register_stack_lean(
            local_frames(sq, case["frames"]), sq,
            **_replicated(sq, case["masters"]),
            config=PipelineConfig(**case["config"]))
        res["lean"].append((gather_rows(sq, out), _diag(diag), diag["halo"]))
    res["traffic_ops"] = sorted({r["op"] for r in sq.traffic})
    return res


def failing_rank(device) -> None:
    """Rank 1 raises; the others wait for it in a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def no_jax_rank(device, frames, matrices) -> list:
    """A sharded warp+combine; returns the JAX modules this rank holds."""
    mesh = frame_space_mesh(1, dist.get_world_size(), device=device)
    sharded_warp_combine(shard_spatial(mesh, frames),
                         replicate(mesh, matrices), mesh, halo=8,
                         tile=(16, 64), span=8)
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")
                  or m == "astrophotography_tpu"
                  or m.startswith("astrophotography_tpu."))


def card_k2_rank(device, case: dict) -> dict:
    """Sharded K2 on the card over every rank; the stack, the launches."""
    kernels.reset_launch_counts()
    mesh = frame_space_mesh(1, dist.get_world_size(), device=device)
    out = _warp_case(mesh, case)
    return {"stack": out, "launches": dict(kernels.launch_counts),
            "transport": mesh.transport}
