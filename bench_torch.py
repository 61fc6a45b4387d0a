#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port on one GPU: calibrate + register
+ sigma-clip stack throughput (GPix/s), the twin of ``bench.py``.

The workload is ``bench.py``'s own (:func:`make_workload`): uint16 raw
frames with the full bias + exposure-scaled dark + flat master set, over
sub-pixel dithers (and, for the third line, 0.1-0.25 deg field
rotations).  It prints ``bench.py``'s lines, one JSON object each, in its
order:

1. the lean path (``calibrate_register_stack_lean``: kernels K1 and K2)
   at 100x4096^2, translation-snap dithers;
2. RAW -> grey FITS frames/s (``bench_rawgrey_torch.run``) on 6 lossless-
   JPEG DNGs of 3904^2;
3. the lean path at 100x4096^2 with field rotations (lowrank taps).

Each stacking line has ``metric``, ``value`` (sustained GPix/s: N*H*W over
the best of ``BENCH_REPEATS`` windows of 3 back-to-back runs with one
sync), ``unit``, ``vs_baseline`` (null: no figure sets a target for the
card), ``single_run_ms`` (the best single run, ending in a synchronize
and a host read of the stack's sum), ``runs_ms`` (min / median / max of
the sustained windows, per run), ``peak_mem_bytes`` (one single run),
``launches`` (of each kernel in one run), ``interior_median`` and
``device`` (the card's name, power limit and count).  A line is printed
only for a stack that is finite, whose interior median is within 5% of
the sky, and whose path launched the kernels it must; any failure
raises and the script exits non-zero.

Environment: ``BENCH_FRAMES`` / ``BENCH_SIZE`` (default 100 / 4096),
``BENCH_IMPL`` (``lean``, the default, or the unfused combines
``pallas`` (K3), ``fused`` (K2), ``xla``), ``BENCH_REPEATS`` (3),
``BENCH_BANDS`` (the unfused path's band count; 0 = the memory rule of
:func:`config_for`), ``BENCH_SKIP_RAWGREY=1`` / ``BENCH_SKIP_ROTATION=1``
(leave out lines 2 / 3), ``BENCH_RAW_FRAMES`` / ``BENCH_RAW_SIZE`` /
``BENCH_RAW_COMPRESSION`` (line 2: 6, 3904, 7).

Run from the repository root on a machine with a CUDA card::

    python3 bench_torch.py
    BENCH_FRAMES=24 BENCH_IMPL=pallas BENCH_SKIP_RAWGREY=1 \\
        BENCH_SKIP_ROTATION=1 python3 bench_torch.py

Without a card it raises before printing any line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from astrophotography_tpu_torch.device import device_info, resolve_device

SKY = 800.0
#: the pipelines ``BENCH_IMPL`` names: the lean path, or the unfused path
#: with one of its combines
IMPLS = ("lean", "pallas", "fused", "xla")
#: back-to-back runs in one sustained window
SUSTAINED_RUNS = 3
#: the unfused path's band rule: ~7 stack-sized float32 temporaries
#: against this many bytes of device memory
BAND_TEMPORARIES, BAND_BUDGET_BYTES = 7, 8e9


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _gaussian_star(shape, x, y, flux, fwhm):
    """Circular Gaussian star image (float64) integrating to ~flux."""
    h, w = shape
    sigma = fwhm / 2.35482
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    amp = flux / (2 * np.pi * sigma * sigma)
    return amp * np.exp(-0.5 * (((xx - x) / sigma) ** 2
                                + ((yy - y) / sigma) ** 2))


def make_workload(n_frames: int, size: int, rotate: bool = False):
    """Synthetic observing run with a full master set, the same numbers
    as ``bench.py``'s workload: uint16 frames = scene*flat + bias +
    0.5*dark_counts with sub-pixel dithers uniform(-4, 4) and, with
    ``rotate``, 0.1-0.25 deg rotations about the centre.

    Returns (frames, bias, dark_master, flat, exp_ratio, max_offset_px,
    matrices (N, 2, 3) of the true reference->frame similarities)."""
    rng = np.random.default_rng(0)
    yy = (np.arange(size, dtype=np.float32) - size / 2) / size
    r2 = yy[:, None] ** 2 + yy[None, :] ** 2
    flat = (1.0 - 0.08 * r2 / r2.max()).astype(np.float32)
    bias = np.full((size, size), 300.0, np.float32)
    dark_counts = np.full((size, size), 40.0, np.float32)
    hot = rng.integers(0, size, (200, 2))
    dark_counts[hot[:, 0], hot[:, 1]] = 5000.0
    dark_master = bias + dark_counts
    exp_ratio = 0.5
    xs = rng.uniform(48, size - 48, 40)
    ys = rng.uniform(48, size - 48, 40)
    fl = rng.uniform(20000, 60000, 40)
    base_fixed = SKY * flat + bias + exp_ratio * dark_counts
    noise_bank = [rng.normal(0, 8.0, (size, size)).astype(np.float32)
                  for _ in range(min(4, n_frames))]
    cx = cy = (size - 1) / 2.0
    frames = np.empty((n_frames, size, size), np.uint16)
    mats = np.zeros((n_frames, 2, 3), np.float64)
    max_off = 0.0
    for i in range(n_frames):
        if i == 0:
            dx = dy = theta = 0.0
        else:
            dx, dy = rng.uniform(-4.0, 4.0, 2)
            theta = (float(rng.choice([-1.0, 1.0])
                           * np.deg2rad(rng.uniform(0.1, 0.25)))
                     if rotate else 0.0)
        c, s = np.cos(theta), np.sin(theta)
        mats[i] = [[c, -s, cx + dx - c * cx + s * cy],
                   [s, c, cy + dy - s * cx - c * cy]]
        f = base_fixed + noise_bank[i % len(noise_bank)]
        for x, y, amp in zip(xs, ys, fl):
            px = c * (x - cx) - s * (y - cy) + cx + dx
            py = s * (x - cx) + c * (y - cy) + cy + dy
            x0, y0 = int(px) - 12, int(py) - 12
            patch = _gaussian_star((25, 25), px - x0, py - y0, amp, 3.0)
            f[y0:y0 + 25, x0:x0 + 25] += patch * flat[y0:y0 + 25,
                                                      x0:x0 + 25]
            max_off = max(max_off, float(np.hypot(px - x, py - y)))
        frames[i] = np.clip(f, 0, 65535).astype(np.uint16)
    return frames, bias, dark_master, flat, exp_ratio, max_off, mats


def lean_config(rotate: bool):
    """bench.py's lean configurations (rotation: lowrank taps, budget
    32; snap: span 8, budget 8)."""
    from astrophotography_tpu_torch.models import PipelineConfig

    common = dict(max_stars=48, match_k=10, detect_mode="chunked",
                  detect_chunk=2, detect_topk="tile", detect_fast=True,
                  detect_bin_rows=True, centroid="kernel", fused_apron=False,
                  general_taps="lowrank")
    if rotate:
        return PipelineConfig(dither_budget=32, **common)
    return PipelineConfig(warp_span=8, dither_budget=8, **common)


def config_for(impl: str, n_frames: int, size: int, rotate: bool = False):
    """bench.py's configuration of ``impl`` for an N x size^2 stack: the
    lean one, or the unfused path's (exact f32 detection, global top-k)
    with ``impl`` as its combine.  'fused' never bands; the others take
    ``BENCH_BANDS``, else the fewest bands (doubling while the size
    divides) that keep 7 stack-sized float32 temporaries under 8e9
    bytes."""
    from astrophotography_tpu_torch.models import PipelineConfig

    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "lean":
        return lean_config(rotate)
    n_bands = int(os.environ.get("BENCH_BANDS", "0"))
    if impl == "fused":
        n_bands = 1
    elif n_bands == 0:
        peak = n_frames * size * size * 4 * BAND_TEMPORARIES
        n_bands = 1
        while peak / n_bands > BAND_BUDGET_BYTES and size % (n_bands * 2) == 0:
            n_bands *= 2
    return PipelineConfig(max_stars=48, match_k=10, interp="separable",
                          n_bands=n_bands, detect_mode="vmap",
                          combine_impl=impl)


def exact_detection_kernel(cfg, h: int, w: int) -> bool:
    """Whether a run of ``cfg`` on frames of ``h`` x ``w`` detects through
    exact detection's kernel: ``find_stars`` in 'exact' mode (no
    ``detect_fast``) on its kernel route (``ops.detect._find_route``)."""
    from astrophotography_tpu_torch.ops import detect as dt

    if cfg.detect_fast:
        return False
    kernel, foot, r = dt.daofind_kernel(cfg.fwhm)
    return dt._find_route((h, w), cfg.max_stars, cfg.detect_topk, "exact",
                          kernel, foot, r) == "kernel"


def required_launches(impl: str, cfg, h: int, w: int) -> dict:
    """The kernels a run of ``impl`` must launch on the card, {name: exact
    count, or None for any positive count}: K1 where the lean path takes
    its fused detection (``models.pipeline.lean_detect_fused``) and K2 on
    the lean path; K3 once per band and the separable warp on 'pallas'
    and 'xla' (one path); K2 on 'fused'; calibration's kernel once on the
    unfused paths and once a chunk where the lean path's detection
    calibrates without K1; exact detection's kernel where the path
    detects with it (:func:`exact_detection_kernel`; the lean path where
    K1 does not take the frames)."""
    from astrophotography_tpu_torch.models import pipeline as pl

    if impl == "lean":
        req = {"warp_combine": None}
        if pl.lean_detect_fused(cfg, h, w):
            req["detect_tiles"] = None
            return req
        req["calibrate"] = None
        if exact_detection_kernel(cfg, h, w):
            req["find_exact"] = None
        return req
    req = {"fused": {"warp_combine": None}}.get(
        impl, {"clip_combine": cfg.n_bands, "warp_separable": None})
    req = dict(req, calibrate=1)
    if exact_detection_kernel(cfg, h, w):
        req = dict(req, find_exact=None)
    return req


def check_launches(label, launches, required) -> None:
    """Every kernel in ``required`` ({name: exact count or None for any
    positive count}) was launched; no other kernel was."""
    for name, count in launches.items():
        want = required.get(name, 0)
        if want is None:
            require(count > 0, f"{label}: kernel {name} not launched")
        else:
            require(count == want, f"{label}: kernel {name} launched "
                                   f"{count} times, expected {want}")


def check_stack(label: str, stacked: torch.Tensor) -> float:
    """The stack is finite and its interior (an eighth of each side in
    from the edges) has a median within 5% of the sky; returns that
    median."""
    require(bool(torch.isfinite(stacked).all()), f"{label}: stack not finite")
    h, w = stacked.shape[-2:]
    med = float(stacked[h // 8:h - h // 8, w // 8:w - w // 8].median())
    require(abs(med - SKY) < 0.05 * SKY, f"{label}: interior median {med}")
    return med


def attempt(n_frames: int, size: int, repeats: int, combine_impl: str,
            rotate: bool = False, device=None) -> dict:
    """One stacking line (bench.py's ``_attempt``): ``combine_impl`` 'lean'
    runs ``calibrate_register_stack_lean``, the others
    ``calibrate_register_stack`` with that combine, on ``device`` (the
    card when None)."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.device import synchronize
    from astrophotography_tpu_torch.models import pipeline as pl

    if repeats < 1:
        raise ValueError(f"repeats must be >= 1, got {repeats}")
    dev = resolve_device(device)
    cfg = config_for(combine_impl, n_frames, size, rotate)
    label = f"{n_frames}x{size}^2 {combine_impl}{' rotated' if rotate else ''}"
    t0 = time.perf_counter()
    frames, bias, dark, flat, exp_ratio, max_off, _mats = make_workload(
        n_frames, size, rotate=rotate)
    fr = torch.from_numpy(frames).to(dev)
    del frames
    kw = dict(bias=torch.from_numpy(bias).to(dev),
              dark=torch.from_numpy(dark).to(dev),
              flat=torch.from_numpy(flat).to(dev),
              exp_ratios=torch.full((n_frames,), exp_ratio,
                                    dtype=torch.float32, device=dev))
    workload_s = time.perf_counter() - t0
    on_card = dev.type == "cuda"

    def run() -> torch.Tensor:
        stack = (pl.calibrate_register_stack_lean if combine_impl == "lean"
                 else pl.calibrate_register_stack)
        return stack(fr, config=cfg, **kw)[0]

    def finish(stacked) -> float:
        synchronize(dev)
        return float(stacked.sum())

    finish(run())                                   # warm-up
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    single, launches, peak, stacked = [], None, None, None
    for _ in range(repeats):
        del stacked
        t0 = time.perf_counter()
        stacked = run()
        finish(stacked)
        single.append(time.perf_counter() - t0)
        if launches is None:
            launches = dict(kernels.launch_counts)
            peak = torch.cuda.max_memory_allocated(dev) if on_card else None
    if on_card:
        check_launches(label, launches, required_launches(
            combine_impl, cfg, size, size))
    med = check_stack(label, stacked)
    del stacked

    sustained = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = None
        for _i in range(SUSTAINED_RUNS):
            out = run()
        finish(out)
        sustained.append((time.perf_counter() - t0) / SUSTAINED_RUNS)
        del out
    gpix = n_frames * size * size / min(sustained) / 1e9
    if combine_impl == "lean":
        mode = ("rotated 0.1-0.25deg, low-rank general taps" if rotate
                else "sub-px dithers, translation-snap path")
        what = "full-cal(bias+dark+flat)+register+stack"
    else:
        mode = "rotated 0.1-0.25deg" if rotate else "sub-px dithers"
        what = "full-cal+register+stack"
    result = {
        "metric": f"{what} GPix/s ({n_frames}x{size}^2 {combine_impl}, "
                  f"{mode}, sustained over {SUSTAINED_RUNS} back-to-back "
                  f"runs)",
        "value": gpix,
        "unit": "GPix/s",
        "vs_baseline": None,
        "single_run_ms": min(single) * 1e3,
        "runs_ms": {"min": min(sustained) * 1e3,
                    "median": float(np.median(sustained)) * 1e3,
                    "max": max(sustained) * 1e3},
        "peak_mem_bytes": peak,
        "launches": launches,
        "interior_median": med,
        "workload_s": workload_s,
        "device": device_info(dev),
    }
    if rotate:
        result["max_rotation_offset_px"] = max_off
    return result


def main() -> int:
    import bench_rawgrey_torch

    impl = os.environ.get("BENCH_IMPL", "lean")
    if impl not in IMPLS:
        raise ValueError(f"BENCH_IMPL must be one of {IMPLS}, got {impl!r}")
    dev = resolve_device(None)          # raises without a usable card
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    n_frames = int(os.environ.get("BENCH_FRAMES", "100"))
    size = int(os.environ.get("BENCH_SIZE", "4096"))
    print(json.dumps(attempt(n_frames, size, repeats, impl, device=dev)),
          flush=True)
    if os.environ.get("BENCH_SKIP_RAWGREY") != "1":
        print(json.dumps(bench_rawgrey_torch.run(
            n_frames=int(os.environ.get("BENCH_RAW_FRAMES", "6")),
            size=int(os.environ.get("BENCH_RAW_SIZE", "3904")),
            repeats=max(repeats, 3),
            compression=int(os.environ.get("BENCH_RAW_COMPRESSION", "7")),
            device=dev)), flush=True)
    if os.environ.get("BENCH_SKIP_ROTATION") != "1":
        print(json.dumps(attempt(n_frames, size, repeats, impl, rotate=True,
                                 device=dev)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
