#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the hand-written CUDA kernels from ``astrophotography_tpu_torch/
csrc``, holds each against its plain PyTorch twin on the card (at the
main paths' own shapes and on a smaller matrix of cases), then drives
the port's stacking paths at full size and checks the registrations and
the stacks:

* the lean path (``calibrate_register_stack_lean``, kernels K1 and K2)
  on 100 raw uint16 frames of 4096^2 with bias, dark and flat masters,
  once with sub-pixel dithers (translation-snap path) and once with
  0.1-0.25 deg field rotations (lowrank taps);
* the unfused path (``calibrate_register_stack``, kernel K3) on the
  first 24 of those dithered frames, with bench.py's own config for that
  size (two output bands, the K3 combine);
* the lean path's chunked detection at 16x1024^2;
* the row-banded warp+combine (``parallel.banded_warp_combine``, K2 once
  per band with ``v_bounds`` and ``snap_geom`` set) on both lean
  workloads with the matrices the lean path solved, against the
  whole-frame K2;
* the unfused path once more with a bad-pixel mask (the workload's hot
  pixels), which repairs every calibrated frame;
* the repair and measurement ops on a synthetic 4008x2672 starfield:
  bad-pixel mask and repair, L.A.Cosmic, source mask and background,
  detection, aperture photometry, PSF fits, the colour stretch;
* the RAW half (``raw``): one planted 3904^2 scene through
  ``synth`` -> lossless-JPEG DNG -> ``RawConv`` with every demosaic
  algorithm and white-balance method, the card against the port's own
  CPU run, then 24 such DNGs -> grey FITS through ``api.grey`` and
  through the three-stage loop (decode thread -> ``RawConv.grey(fetch=
  False)`` -> ``AsyncWriter``), with frames/s and the decode / upload /
  device / download / write split, and the device ms of each
  ``ops/demosaic`` function;
* the calibration-file engines (``files``): 9 bias, 9 dark and 9 flat
  frames and 8 lights of 4008x2672 as uint16 FITS in a temp directory,
  then ``make_master`` x3, ``calc_read_noise``, ``find_badpix``,
  ``auto_badcol_file``, ``Calibrator.calibrate`` on the lights (one with
  ``fix_cosmic``) and ``fix_badpix_files``, each held to what was
  planted and split into read, device and write time;
* the file-to-file reduction (``reduce``): a synthetic night of 24
  uint16 lights of 4008x2672 in two filters with masters in a temp
  directory (``make_observing_run``), ``ap_reduce --astrometry
  --stack_engine fused`` in process (calibrate, quality, the network-free
  navigate stage, K2 per group; then again, rewriting nothing),
  ``ap_stack`` with each engine and the union canvas, every product held
  to what was planted, K2 (snap and 'exact' bodies) and K3 against their
  twins at that shape, the per-stage split, and the entry point's twin;
* the multi-device layer (``multichip``): 4 ranks spawned on the one
  card over host-staged gloo, K2 row-sharded (``sharded_warp_combine``,
  1x4) on both lean workloads against the band loop (bit for bit) and
  the whole frame, the unfused pipeline (K3) and the lean pipeline (K1,
  K2) on a 2x2 mesh against the one-process runs, the unfused pipeline
  with a bad-pixel mask and flux scales under K3 and under K2
  (``combine_impl='fused'``), the lean pipeline with the 'median' noise
  centre, and the dry run's twin (``graft_entry.dryrun_multichip``),
  with each rank's kernel times, launches, exchange bytes and times and
  peak memory;
* the routes past the kernels' shared-memory limits and radius 16
  (``deep``): the lean path on 1200 uint16 frames of 2048^2 (10.1 GB,
  made on the card: K2's global route), the unfused path on 1200 frames
  of 512^2 (K3's global route), K2 against its twin at 1200 x 512^2
  (snap and lowrank), K3 against its twin on a masked 1200 x 1024 x 2048
  stack and, on its 'select' route, on a masked 30000 x 480 x 640 one
  (46.1 GB, a lucky-imaging run; the twin on 16 rows), K1 at radii 17,
  24 and 48 (its separable route) on 16 x 4096^2;
* an oversampled rig (``oversampled``): the lean path on 100 uint16
  frames of 4096^2 with the same masters and dithers and stars of 8 px
  FWHM, with ``fwhm=8.0`` (K1 on its ring route at radius 6), the
  registration and the stack checked, K1's call replayed on its twin;
  then K1 at every radius of the ring route the FWHM can reach (4, 6, 8,
  12, 16) on that stack against its twin, with its time and bound;
* K2 past span 192 (``wide``): its 'wide' route against the twin bit
  for bit at spans 193, 256 and 1436 (the route's reach) on every tap
  body, uint16 with masters and float32 without, then
  ``calibrate_register_stack`` with ``combine_impl='fused'``, span 256
  and tiles of 320 x 1024 on 24 frames of 2048^2 turning 0-12 deg about
  the centre (an alt-az mount's field rotation over about an hour):
  registration and stack checked, K2 once on 'wide', its call replayed on
  the twin, its time and bound; then 'wide' alone, timed with its bound,
  at 100 x 4096^2 (0-12 deg) and 360 x 2048^2 (0-15 deg, an alt-az hour)
  made on the card;
* the benchmark entry point (``bench``): ``python3 bench_torch.py`` as
  a subprocess (its three lines: lean snap, RAW->grey, lean rotated),
  then again with ``BENCH_FRAMES=24 BENCH_SIZE=4096 BENCH_IMPL=pallas``
  and the RAW and rotated lines skipped (the unfused K3 line); every
  line in bench.py's order, finite and positive, on this card, with the
  launches its path must make.

Beside the checks against the plain twins it times K2 at 100x4096^2 with
``combine='average'`` against ``combine='mean'`` (the same warp without
the sort and clip): the warp phase against the combine phase.

Run from the repository root with ``python3 chip_smoke.py``; every phase
runs.  ``--only {k1,k2,k3,lean,unfused,small,bands,measure,raw,files,reduce,multichip,deep,oversampled,wide,bench}``
runs one group of phases (the kernel check and timing of K1, K2 or K3 at
the main paths' shapes, the lean path, the unfused path with and without
the mask, the 16x1024^2 chunked run and the small kernel matrix, the
band loop, the measurement ops, the RAW half, the calibration-file
engines, the file-to-file reduction, the multi-device layer, the
routes past the shared-memory limits, the oversampled lean path, K2
past span 192, or the benchmark) and prints no ``kernels`` line.  Every phase raises
on failure.  Each phase prints one JSON line; the build line carries
ptxas' register, shared-memory and spill report for every kernel; the
line before the last is the card's ``nvidia-smi`` name and power limit,
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from astrophotography_tpu_torch.device import card_line
from bench_torch import (SKY, _gaussian_star, check_launches, check_stack,
                         config_for, lean_config, make_workload)
from bench_torch import require as _require

N_FRAMES, SIZE = 100, 4096
UNFUSED_FRAMES = 24
#: translation error bound against the true dithers where stars come from
#: find_stars (the unfused path, the lean path's chunked detection): its
#: 5x5 centre-of-mass centroids carry a sub-pixel-phase bias (the JAX
#: package measures 0.18 / 0.24 px in x / y on 8x1024^2 of this workload)
UNFUSED_T_ERR_PX = 0.5
PHASES = ("k1", "k2", "k3", "lean", "unfused", "small", "bands", "measure",
          "raw", "files", "reduce", "multichip", "deep", "oversampled", "wide",
          "bench")
#: the RAW half: 24 lossless-JPEG DNGs of 3904^2 uint16 (bench_rawgrey's
#: set: black level 128)
RAW_FRAMES, RAW_SIZE = 24, 3904
#: the calibration-file engines: frames per master, light frames
CAL_FRAMES, LIGHT_FRAMES = 9, 8
#: the band loop: 4 bands of 1024 rows with a halo of one K2 tile row
N_BANDS, HALO = 4, 64
#: the clip-tie rule of the JAX package's band tests: a pixel may differ
#: by more than TIE_ATOL + TIE_RTOL * |ref| (a sample at a clip bound
#: kept in one arithmetic order only) on under TIE_FRAC of the pixels,
#: and the median difference stays under TIE_MEDIAN
TIE_ATOL, TIE_RTOL, TIE_FRAC, TIE_MEDIAN = 0.5, 1e-4, 1e-4, 1e-3
#: published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): device
#: memory, and float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def unfused_config():
    """bench.py's unfused rung at 24x4096^2 (``config_for('pallas')``:
    exact f32 detection, global top-k, two bands by the memory rule, the
    K3 combine)."""
    return config_for("pallas", UNFUSED_FRAMES, SIZE)


def _timed(fn):
    """(fn(), its device time in ms) for one call (CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _time_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches after a warm-up
    (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the memory rate, against the
    operations at the float32 rate; the larger bounds it."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def _k1_agrees(k, p, label) -> dict:
    """K1's tables ``k`` held against its twin's ``p``: max values within
    rtol 1e-4, atol 1e-2; argmax and offsets equal (offsets within 1e-4
    bin) on every tile, except tiles whose two maxima tie within 1e-3
    relative.  Returns the errors."""
    kmax, kidx, kyo, kxo = k
    pmax, pidx, pyo, pxo = p
    _require(bool(((kmax > -1e37) == (pmax > -1e37)).all()),
             f"{label}: K1 empty tiles differ")
    live = pmax > -1e37
    err = (kmax - pmax).abs()
    _require(bool((err[live] <= 1e-2 + 1e-4 * pmax[live].abs()).all()),
             f"{label}: K1 tile maxima differ")
    tie = (kidx != pidx) & (err <= 1e-3 * pmax.abs().clamp(min=1.0))
    same = kidx == pidx
    _require(bool((same | tie).all()), f"{label}: K1 argmax differs")
    off = torch.maximum((kyo - pyo).abs(), (kxo - pxo).abs())
    _require(bool((off[same] <= 1e-4).all()), f"{label}: K1 offsets differ")
    return {"max_abs_err": float(err[live].max()) if bool(live.any())
            else 0.0,
            "offset_max_abs_err": float(off[same].max()),
            "argmax_ties": int(tie.sum()), "live_tiles": int(live.sum())}


def _k2_exact(k, p, label) -> float:
    """K2's image ``k`` equal to its twin's ``p`` bit for bit (max |diff|
    0, equal zero masks)."""
    _require(bool(torch.equal(k == 0, p == 0)),
             f"{label}: K2 zero coverage differs")
    err = float((k - p).abs().max())
    _require(err == 0.0, f"{label}: K2 differs from its twin by {err}")
    return err


def _k3_exact(k, p, label) -> float:
    """K3's image ``k`` equal to its twin's ``p`` bit for bit, NaN where
    nothing is kept included (the kernel rounds every value operation as
    its twin does, so any difference is a bug)."""
    nan_k, nan_p = torch.isnan(k), torch.isnan(p)
    _require(bool(torch.equal(nan_k, nan_p)), f"{label}: K3 NaN pixels differ")
    err = float((k - p).abs()[~nan_p].max()) if bool((~nan_p).any()) else 0.0
    _require(err == 0.0, f"{label}: K3 differs from its twin by {err}")
    return err


def _exact(k, p, label, names) -> float:
    """A kernel's outputs ``k`` equal to its twin's ``p`` field by field
    (``names``) bit for bit, signed zeros included; a NaN only has to be
    a NaN (the kernels round every value operation as their twins do)."""
    err = 0.0
    for what, kk, pp in zip(names, k, p):
        if kk.dtype == torch.bool:
            _require(bool(torch.equal(kk, pp)), f"{label}: {what} differs")
            continue
        nan_k, nan_p = torch.isnan(kk), torch.isnan(pp)
        _require(bool(torch.equal(nan_k, nan_p)),
                 f"{label}: {what} NaN pixels differ")
        diff = (torch.where(nan_k, 0.0, kk).view(torch.int32)
                != torch.where(nan_p, 0.0, pp).view(torch.int32))
        if bool((~nan_p).any()):
            err = max(err, float((kk - pp).abs()[~nan_p].max()))
        _require(not bool(diff.any()),
                 f"{label}: {what}: {int(diff.sum())} of {diff.numel()} "
                 f"values differ from the twin (max |diff| {err})")
    return err


def check_detect(frames, thr, mf, a_plane, er, label, card, reps=3,
                 fwhm=3.0):
    """K1 against detect_tiles_plain by :func:`_k1_agrees`' rule, and
    K1's time."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.ops import detect_tiles as dt

    args = dict(mf_bc=mf, a_plane=a_plane, exp_ratios=er, fwhm=fwhm)
    k = dt.detect_tiles(frames, thr, **args)
    torch.cuda.synchronize()
    p, plain_ms = _timed(lambda: dt.detect_tiles_plain(frames, thr, **args))
    agree = _k1_agrees(k, p, label)
    ms = _time_ms(lambda: dt.detect_tiles(frames, thr, **args), reps)
    # per raw pixel: 2-row binning (2 flops), then per binned pixel the
    # Gaussian and box column and row passes (6 per tap), the density
    # (5) and the 3x3 peak test (10)
    r = dt._kernel_params(fwhm)[1]
    ntap = 2 * r + 1
    n_bytes = _nbytes(frames, thr, mf, a_plane, er, *k)
    res = {"phase": "K1 vs detect_tiles_plain", "case": label,
           "shape": list(frames.shape), "radius": r,
           "route": kernels._detect_route(r), **agree,
           "ms": ms, "plain_ms": plain_ms,
           **_bound(n_bytes, frames.numel() * (3 * ntap + 9.5)), "card": card}
    res["ms_over_bound"] = ms / res["bound_ms"]
    _print(res)
    return res


def _k2_kernel(frames, mats, masters, er, combine="average",
               general_taps="exact", **kw):
    """A call of K2's wrapper alone, on a plan made once (the host prep
    of ``warp_combine`` is left out of the kernel's time)."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.ops import warp_combine as wc

    plan = wc.plan_warp_combine(frames.shape, mats, er,
                                general_taps=general_taps, **kw)
    return lambda: kernels.warp_combine_cuda(
        frames, masters, plan, combine=wc._COMBINES.index(combine),
        lowrank=general_taps == "lowrank", sigma_lower=5.0, sigma_upper=5.0)


def _k2_bound(frames, masters, n_out: int) -> dict:
    """K2 reads the raw stack and the masters once and writes the image;
    per (frame, pixel) ~30 flops (5 of calibration, 6 horizontal and 6
    vertical taps at 2 each, 1 to add the sample), plus the log2(N)
    compares per sample of a comparison sort."""
    n = frames.shape[0]
    ops = frames.numel() * (30 + math.log2(max(n, 2)))
    return _bound(_nbytes(frames, masters) + 4 * n_out, ops)


def check_warp(frames, mats, masters, er, label, card, reps=3, **kw):
    """K2 against warp_combine_plain: rtol 1e-4, atol 1e-2, equal
    zero-coverage masks; at most 1e-5 of the pixels may differ (a sample
    within rounding of a clip bound kept on one side only).  ``ms`` is
    the kernel's own time."""
    from astrophotography_tpu_torch.ops import warp_combine as wc

    args = dict(masters=masters, exp_ratios=er, **kw)
    k = wc.warp_combine(frames, mats, **args)
    torch.cuda.synchronize()
    p, plain_ms = _timed(lambda: wc.warp_combine_plain(frames, mats, **args))
    _require(bool(((k == 0) == (p == 0)).all()),
             f"{label}: K2 zero coverage differs")
    err = (k - p).abs()
    bad = err > 1e-2 + 1e-4 * p.abs()
    frac = float(bad.float().mean())
    _require(frac <= 1e-5, f"{label}: K2 differs on {frac:.2e} of pixels")
    ok_err = float(err[~bad].max())
    del k, p, err, bad
    torch.cuda.empty_cache()
    ms = _time_ms(_k2_kernel(frames, mats, masters, er, **kw), reps)
    res = {"phase": "K2 vs warp_combine_plain", "case": label,
           "shape": list(frames.shape), "max_abs_err": ok_err,
           "pixels_differing": frac, "ms": ms, "plain_ms": plain_ms,
           **_k2_bound(frames, masters, frames[0].numel()), "card": card}
    _print(res)
    return res


def k2_split(frames, mats, masters, er, label, card, reps=3, **kw):
    """K2's time with combine='average' against combine='mean' (the same
    warp; 'mean' skips the sort, the MAD and the clip), in turns
    average, mean, mean, average on one card: the warp phase against the
    combine phase."""
    runs = {c: _k2_kernel(frames, mats, masters, er, combine=c, **kw)
            for c in ("average", "mean")}
    times = {"average": [], "mean": []}
    for c in ("average", "mean", "mean", "average"):
        times[c].append(_time_ms(runs[c], reps))
    avg = sum(times["average"]) / 2
    mean = sum(times["mean"]) / 2
    res = {"phase": "K2 split, average vs mean", "case": label,
           "shape": list(frames.shape), "average_ms": times["average"],
           "mean_ms": times["mean"], "combine_ms": avg - mean,
           "combine_share": (avg - mean) / avg, "card": card}
    _print(res)
    return res


def check_clip(stack, mask, label, card, reps=5):
    """K3 against clip_combine_plain: bit-identical, NaN where nothing is
    kept included (the kernel rounds every value operation as its twin
    does, so any difference is a bug)."""
    from astrophotography_tpu_torch.ops import clip_combine as cc

    k = cc.clip_combine(stack, mask)
    torch.cuda.synchronize()
    p, plain_ms = _timed(lambda: cc.clip_combine_plain(stack, mask))
    err = _k3_exact(k, p, label)
    nan_pixels = int(torch.isnan(p).sum())
    del k, p
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: cc.clip_combine(stack, mask), reps)
    # per sample: log2(N) compares of a comparison sort, the deviation
    # (2), the clip tests (2) and the sum (1)
    n = stack.shape[0]
    ops = stack.numel() * (5 + math.log2(max(n, 2)))
    res = {"phase": "K3 vs clip_combine_plain", "case": label,
           "shape": list(stack.shape), "masked": mask is not None,
           "max_abs_err": err, "nan_pixels": nan_pixels,
           "ms": ms, "plain_ms": plain_ms,
           **_bound(_nbytes(stack, mask) + 4 * stack[0].numel(), ops),
           "card": card}
    _print(res)
    return res


def _clip_inputs(n, h, w, dev, seed, masked=True):
    """A K3 test stack on ``dev``: sky 800 with 8 ADU noise, 2% outliers
    at 40000, ~20% of the samples masked and every 97th row of pixels
    fully masked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    stack = SKY + 8.0 * torch.randn((n, h, w), generator=g, device=dev)
    out = torch.rand((n, h, w), generator=g, device=dev) < 0.02
    stack = torch.where(out, 40000.0, stack)
    if not masked:
        return stack, None
    mask = torch.rand((n, h, w), generator=g, device=dev) > 0.2
    mask[:, ::97, :] = False
    return stack, mask


def _masters(bias, dark, flat, dev):
    """(A, B, C) = (1/flat, bias/flat, (dark - bias)/flat) on ``dev``."""
    b, d, f = (torch.from_numpy(x).to(dev) for x in (bias, dark, flat))
    a = 1.0 / f
    return torch.stack([a, b * a, (d - b) * a]), b, d - b, f


def _workload_on_device(rotate, dev, keep_host=False):
    """The lean workload on ``dev``; with ``keep_host`` also its raw
    stack as a CPU tensor in shared memory (else None), which the
    multichip phase hands to its ranks."""
    t0 = time.perf_counter()
    frames, bias, dark, flat, exp_ratio, max_off, mats = make_workload(
        N_FRAMES, SIZE, rotate=rotate)
    gen_s = time.perf_counter() - t0
    host = torch.from_numpy(frames)
    if keep_host:
        host = host.share_memory_()
    fr = host.to(dev)
    del frames
    return (fr, bias, dark, flat, exp_ratio, max_off, mats, gen_s,
            host if keep_host else None)


def _check_registration(label, diag, mats, t_err_max=None):
    """n_inliers >= 5 and rms < 0.5 px on every frame; returns the
    largest translation error against the true matrices."""
    n_in = diag["n_inliers"].cpu().numpy()
    rms = diag["rms"].cpu().numpy()
    _require(bool((n_in >= 5).all()), f"{label}: n_inliers {n_in.min()}")
    _require(bool((rms < 0.5).all()), f"{label}: rms {rms.max()}")
    n = len(n_in)
    t_err = max(np.max(np.abs(diag["tx"].cpu().numpy() - mats[:n, 0, 2])),
                np.max(np.abs(diag["ty"].cpu().numpy() - mats[:n, 1, 2])))
    if t_err_max is not None:
        _require(t_err < t_err_max, f"{label}: translation error {t_err}")
    return int(n_in.min()), float(rms.max()), float(t_err)


def run_main_path(rotate: bool, card: str, dev, phases) -> dict:
    """Kernel checks at the main path's shapes (K1 on snap, K2 with its
    average-vs-mean split), then the lean path, as far as ``phases``
    asks."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.models import (
        calibrate_register_stack_lean)
    from astrophotography_tpu_torch.ops import detect_tiles as dt

    label = "rotated" if rotate else "snap"
    cfg = lean_config(rotate)
    fr, bias, dark, flat, exp_ratio, max_off, mats, gen_s, host = \
        _workload_on_device(rotate, dev, keep_host="multichip" in phases)
    n = fr.shape[0]
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    masters, b_t, du_t, f_t = _masters(bias, dark, flat, dev)
    checks = {}
    if "k1" in phases and not rotate:
        # K1 on the main path's input (threshold: nsigma x the 8 ADU noise)
        mf = dt.master_densities(b_t, du_t, f_t, fwhm=cfg.fwhm)
        thr = torch.full((n,), cfg.detect_nsigma * 8.0, device=dev)
        checks["detect_tiles"] = check_detect(
            fr, thr, mf, masters[0], er, f"main path {label}", card)
        del mf
    if "k2" in phases:
        mats_t = torch.from_numpy(mats.astype(np.float32)).to(dev)
        k2_kw = dict(span=cfg.warp_span, apron=False,
                     dither_budget=cfg.dither_budget,
                     general_taps=cfg.general_taps)
        checks["warp_combine"] = check_warp(
            fr, mats_t, masters, er, f"main path {label}", card, **k2_kw)
        torch.cuda.empty_cache()
        checks["warp_split"] = k2_split(fr, mats_t, masters, er,
                                        f"main path {label}", card, **k2_kw)
    torch.cuda.empty_cache()
    if not phases & {"lean", "bands", "multichip"}:
        return checks

    kw = dict(bias=torch.from_numpy(bias).to(dev),
              dark=torch.from_numpy(dark).to(dev),
              flat=torch.from_numpy(flat).to(dev), exp_ratios=er)

    def run():
        return calibrate_register_stack_lean(fr, config=cfg, **kw)

    run()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stacked, diag = run()
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check_launches(label, launches, {"detect_tiles": None,
                                     "warp_combine": None})
    _require("jax" not in sys.modules, "jax was imported")
    if "bands" in phases:
        checks["bands"] = run_bands(fr, diag, masters, er, cfg, label, card)
    if "multichip" in phases:
        checks["multichip"] = {
            "label": label, "frames": host, "masters": masters.cpu(),
            "bias": bias, "dark": dark, "flat": flat, "er": er.cpu(),
            "cfg": cfg, "stacked": stacked.cpu(),
            "diag": {k: v.cpu() if isinstance(v, torch.Tensor) else v
                     for k, v in diag.items()}}
    if "lean" not in phases:
        return checks
    k = 3
    t0 = time.perf_counter()
    for _ in range(k):
        out, _d = run()
    torch.cuda.synchronize()
    sustained_s = (time.perf_counter() - t0) / k

    # registration against the known dithers (reference = frame 0)
    min_in, max_rms, t_err = _check_registration(label, diag, mats)
    med = check_stack(label, stacked)
    res = {"phase": f"main path {label}", "shape": [n, SIZE, SIZE],
           "single_run_ms": single_ms,
           "sustained_gpix_s": n * SIZE * SIZE / sustained_s / 1e9,
           "sustained_ms": sustained_s * 1e3,
           "max_memory_allocated_bytes": peak, "launches": launches,
           "min_inliers": min_in, "max_rms_px": max_rms,
           "max_translation_err_px": t_err,
           "interior_median": med, "sky": SKY,
           "max_offset_px": max_off, "workload_gen_s": gen_s, "card": card}
    _print(res)
    del fr, stacked, out, masters, kw
    torch.cuda.empty_cache()
    return {"main": res, **checks}


def _tie_rule(label, got, ref) -> dict:
    """Hold ``got`` against ``ref`` by the clip-tie rule: equal zero
    masks, the median difference and the fraction of pixels beyond the
    tolerance under their limits.  Returns the figures."""
    _require(bool(((got == 0) == (ref == 0)).all()),
             f"{label}: zero coverage differs")
    both = (got != 0) & (ref != 0)
    err = (got - ref).abs()[both]
    frac = float((err > TIE_ATOL + TIE_RTOL * ref[both].abs()).float().mean())
    med = float(err.median())
    _require(frac < TIE_FRAC, f"{label}: {frac:.2e} of the pixels beyond "
                              f"{TIE_ATOL} + {TIE_RTOL} |ref|")
    _require(med < TIE_MEDIAN, f"{label}: median difference {med}")
    return {"max_abs_err": float(err.max()), "median_abs_err": med,
            "fraction_beyond_tolerance": frac,
            "covered": float(both.float().mean())}


def _solved_matrices(diag) -> torch.Tensor:
    """The (N, 2, 3) matrices of a pipeline's diagnostics."""
    from astrophotography_tpu_torch.ops.register import Similarity

    return Similarity(*(diag[k] for k in ("scale", "theta", "tx", "ty",
                                          "n_inliers", "rms"))).matrix()


def run_bands(fr, diag, masters, er, cfg, label, card) -> dict:
    """``banded_warp_combine`` (4 bands, halo 64) on the lean workload's
    raw stack with the matrices the lean path just solved, against the
    whole-frame ``warp_combine`` of the same inputs: equal zero masks and
    the clip-tie rule (a band sums the snapped translation next to another
    row offset, so its float32 rounding differs), and on the snap
    workload also with those translations rounded to 1/64 px, which both
    sum exactly: bit for bit.  K2 must be launched once per band."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.ops.warp_combine import warp_combine
    from astrophotography_tpu_torch.parallel import banded_warp_combine

    mats = _solved_matrices(diag)
    kw = dict(span=cfg.warp_span, tile=cfg.fused_tile, apron=False,
              dither_budget=cfg.dither_budget,
              general_taps=cfg.general_taps)

    def whole(m):
        return warp_combine(fr, m, masters=masters, exp_ratios=er, **kw)

    def banded(m):
        return banded_warp_combine(fr, m, N_BANDS, masters=masters,
                                   exp_ratios=er, halo=HALO, **kw)

    whole(mats), banded(mats)               # warm-up
    ref, whole_ms = _timed(lambda: whole(mats))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got, banded_ms = _timed(lambda: banded(mats))
    launches = dict(kernels.launch_counts)
    check_launches(f"bands {label}", launches, {"warp_combine": N_BANDS})
    res = {"phase": f"bands {label}", "shape": list(fr.shape),
           "n_bands": N_BANDS, "halo": HALO, "launches": launches,
           "whole_frame_ms": whole_ms, "banded_ms": banded_ms,
           "ms_per_band": banded_ms / N_BANDS,
           **_tie_rule(f"bands {label}", got, ref), "card": card}
    del got, ref
    if label == "snap":
        exact = torch.zeros_like(mats)
        exact[:, 0, 0] = exact[:, 1, 1] = 1.0
        exact[:, :, 2] = torch.round(mats[:, :, 2] * 64.0) / 64.0
        ref, got = whole(exact), banded(exact)
        _require(bool(((got == 0) == (ref == 0)).all()),
                 "bands snap, 1/64 px translations: zero coverage differs")
        err = float((got - ref).abs().max())
        _require(err == 0.0, f"bands snap, 1/64 px translations: banded "
                             f"differs from the whole frame by {err}")
        res["exact_translations_max_abs_err"] = err
        del got, ref
    torch.cuda.empty_cache()
    _print(res)
    return res


def check_bounds_geom(card, dev) -> None:
    """K2 with ``v_bounds`` and ``snap_geom`` set to other values than
    their defaults at 16x1024^2, snap and rotated lowrank, against
    ``warp_combine_plain``: bit for bit, and the bounds must cut rows.
    The half-extents of 20 px snap the rotations under 0.0025 rad about
    an off-centre point and leave the others to the lowrank body."""
    from astrophotography_tpu_torch.ops import warp_combine as wc

    geo = dict(v_bounds=torch.tensor([100.5, 900.0], device=dev),
               snap_geom=torch.tensor([400.0, 300.0, 20.0, 20.0], device=dev))
    for rotate in (False, True):
        frames, bias, dark, flat, exp_ratio, _off, mats = make_workload(
            16, 1024, rotate=rotate)
        fr = torch.from_numpy(frames).to(dev)
        masters = _masters(bias, dark, flat, dev)[0]
        args = dict(masters=masters,
                    exp_ratios=torch.full((16,), exp_ratio, device=dev),
                    general_taps="lowrank", dither_budget=32)
        m = torch.from_numpy(mats.astype(np.float32)).to(dev)
        k = wc.warp_combine(fr, m, **args, **geo)
        p, plain_ms = _timed(lambda: wc.warp_combine_plain(fr, m, **args,
                                                           **geo))
        full = wc.warp_combine(fr, m, **args)
        err = float((k - p).abs().max())
        label = f"16x1024^2 {'rotated' if rotate else 'snap'}"
        _require(err == 0.0 and bool(((k == 0) == (p == 0)).all()),
                 f"K2 with v_bounds / snap_geom, {label}: differs from its "
                 f"twin by {err}")
        _require(bool((k[:90] == 0).all()) and bool((k[910:] == 0).all())
                 and int((k != 0).sum()) < int((full != 0).sum()),
                 f"K2 with v_bounds, {label}: rows beyond the bounds covered")
        _print({"phase": "K2 with v_bounds and snap_geom vs "
                         "warp_combine_plain", "case": label,
                "max_abs_err": err, "plain_ms": plain_ms,
                "covered": float((k != 0).float().mean()),
                "covered_default": float((full != 0).float().mean()),
                "card": card})


# ---- the multichip phase ---------------------------------------------------

#: the multichip phase: ranks on one card, the transport they must use
MC_WORLD, MC_TRANSPORT = 4, "gloo"
#: the kernels' launch functions whose device time a rank records
_KERNEL_FNS = ("detect_tiles", "warp_combine", "clip_combine")


class _KernelClock:
    """Within the block, every launch of a kernel wrapper is bracketed by
    CUDA events; ``ms()`` sums each kernel's device time (the launch
    counters are untouched: the wrapped function is the counting one)."""

    def __enter__(self):
        from astrophotography_tpu_torch import kernels

        self._kernels, self._orig, self._events = kernels, {}, {}
        for name in _KERNEL_FNS:
            fn = getattr(kernels, f"{name}_cuda")
            self._orig[name] = fn
            self._events[name] = []
            setattr(kernels, f"{name}_cuda", self._wrap(name, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self._events[name].append((start, end))
            return out
        return timed

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self._kernels, f"{name}_cuda", fn)

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in ev)
                for name, ev in self._events.items()}


def _exchanges(traffic) -> dict:
    """The traffic records of a step summed by operation."""
    out = {}
    for rec in traffic:
        key = f"{rec['op']} over {rec['axis']}"
        acc = out.setdefault(key, {"count": 0, "bytes_sent": 0,
                                   "bytes_received": 0, "ms": 0.0,
                                   "staging_ms": 0.0})
        acc["count"] += 1
        for k in ("bytes_sent", "bytes_received", "ms", "staging_ms"):
            acc[k] += rec[k]
    return out


class _FirstCall:
    """Within the block, the first ``keep`` calls of ``module.<name>`` (a
    kernel's wrapper as a pipeline or the sharded code calls it) keep
    their arguments and results, for the kernel's check against its
    plain twin."""

    def __init__(self, module: str, name: str, keep: int = 1):
        import importlib

        self.module, self.name = importlib.import_module(module), name
        self.keep, self.calls = keep, []

    @property
    def call(self):
        return self.calls[0] if self.calls else None

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def first(*a, **k):
            out = fn(*a, **k)
            if len(self.calls) < self.keep:
                self.calls.append((a, k, out))
            return out
        setattr(self.module, self.name, first)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


_PIPELINE = "astrophotography_tpu_torch.models.pipeline"
#: each kernel as the one-device pipelines call it (module, wrapper's
#: name there)
_PIPELINE_CALLS = {"K1": (_PIPELINE, "detect_tiles"),
                   "K2": (_PIPELINE, "warp_combine"),
                   "K3": (_PIPELINE, "clip_combine"),
                   "warp_separable": (_PIPELINE, "warp_affine_separable"),
                   "find_exact": (_PIPELINE, "find_stars"),
                   "calibrate": (_PIPELINE, "calibrate_batch")}
#: each kernel as the sharded code calls it
_MC_CALLS = dict(_PIPELINE_CALLS,
                 K2=("astrophotography_tpu_torch.parallel.fused",
                     "warp_combine"))
#: each kernel's plain twin (module, name)
_PLAINS = {"K1": ("astrophotography_tpu_torch.ops.detect_tiles",
                  "detect_tiles_plain"),
           "K2": ("astrophotography_tpu_torch.ops.warp_combine",
                  "warp_combine_plain"),
           "K3": ("astrophotography_tpu_torch.ops.clip_combine",
                  "clip_combine_plain"),
           "warp_separable": ("astrophotography_tpu_torch.ops.warp",
                              "warp_affine_separable_plain"),
           "find_exact": ("astrophotography_tpu_torch.ops.detect",
                          "find_stars_plain"),
           "calibrate": ("astrophotography_tpu_torch.ops.calibrate",
                         "calibrate_batch_plain")}


def _plain_check(kind: str, call, label: str) -> dict:
    """The plain twin on the exact arguments a kernel got in a path's
    run, held against the kernel's result by the kernel's rule: K1 by
    :func:`_k1_agrees`, K2, K3, the separable warp, exact detection and
    calibration bit for bit."""
    import importlib

    _require(call is not None, f"{label}: {kind} was not called")
    a, k, out = call
    plain_mod, plain_name = _PLAINS[kind]
    plain = getattr(importlib.import_module(plain_mod), plain_name)
    p, plain_ms = _timed(lambda: plain(*a, **k))
    label = f"{label} {kind}"
    if kind == "K1":
        agree = _k1_agrees(out, p, label)
    elif kind == "warp_separable":
        agree = {"max_abs_err": _exact(out, p, label,
                                       ("warped", "coverage"))}
    elif kind == "find_exact":
        agree = {"max_abs_err": _exact(out, p, label, out._fields)}
    elif kind == "calibrate":
        agree = {"max_abs_err": _exact((out,), (p,), label, ("stack",))}
    else:
        agree = {"max_abs_err": (_k2_exact if kind == "K2" else _k3_exact)(
            out, p, label)}
    del p
    torch.cuda.empty_cache()
    return {"kernel": kind, "shape": list(a[0].shape), **agree,
            "plain_ms": plain_ms}


def _mc_step(mesh, place, run, label, check=()):
    """One multichip step on this rank: every rank starts together, the
    inputs are placed (``place()``: shared-memory blocks to the card),
    then ``run(*placed)`` with the launch counters at 0, the kernels
    clocked and the exchanges recorded.  The kernels in ``check`` ('K1',
    'K2', 'K3') keep their first call's arguments, and after the record
    their plain twins run on them.  Returns (run's result, the rank's
    record)."""
    import contextlib

    import torch.distributed as dist

    from astrophotography_tpu_torch import kernels

    torch.cuda.empty_cache()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    placed = place()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kernels.reset_launch_counts()
    mesh.traffic.clear()
    with contextlib.ExitStack() as stack:
        calls = {kind: stack.enter_context(_FirstCall(*_MC_CALLS[kind]))
                 for kind in check}
        clock = stack.enter_context(_KernelClock())
        out = run(*placed)
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    rec = {"rank": mesh.rank, "coords": dict(mesh.coords),
           "upload_s": t1 - t0, "wall_s": t2 - t1,
           "kernel_ms": clock.ms(), "launches": dict(kernels.launch_counts),
           "exchanges": _exchanges(mesh.traffic),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    del placed
    rec["plain_checks"] = [
        _plain_check(kind, calls[kind].call,
                     f"multichip {label} rank {mesh.rank}")
        for kind in check]
    return out, rec


#: the rank of each multichip step whose kernels are held against their
#: plain twins on the exact arguments they got (one rank a step: the
#: twins are slow), and which kernels: a top, an interior and a bottom
#: band, a combine sub-band, the second frame shard
MC_CHECKS = {"K2 snap": (0, ("K2",)), "K2 rotated": (2, ("K2",)),
             "unfused": (1, ("K3",)), "lean": (3, ("K1", "K2")),
             "unfused extras": (2, ("K3",)), "unfused fused": (1, ("K2",)),
             "lean median": (0, ("K2",))}


def unfused_fused_config():
    """:func:`unfused_config` with the fused warp+combine (K2 on the
    calibrated stack), which takes no bands."""
    return dataclasses.replace(unfused_config(), combine_impl="fused",
                               n_bands=1)


def _hot(w: dict) -> np.ndarray:
    """The workload's planted hot pixels (dark counts above 1000 ADU):
    the bad-pixel mask of the unfused runs."""
    return np.asarray(w["dark"]) - np.asarray(w["bias"]) > 1000.0


def _flux_scales(n: int) -> torch.Tensor:
    """Flux scales of the multichip unfused runs: 0.9 to 1.1."""
    return torch.linspace(0.9, 1.1, n, dtype=torch.float32)


def _multichip_rank(device, work: dict) -> dict:
    """The multichip phase's steps on one rank: K2 row-sharded on a 1x4
    mesh (snap, rotated), then the unfused and the lean pipelines on a
    2x2 mesh.  Stacks come back from rank 0 only."""
    from astrophotography_tpu_torch.models.pipeline import lean_kernel_kwargs
    from astrophotography_tpu_torch.parallel.fused import sharded_warp_combine
    from astrophotography_tpu_torch.parallel.mesh import (
        frame_space_mesh, gather_rows, local_frames, replicate,
        shard_spatial)
    from astrophotography_tpu_torch.parallel.sharded import (
        sharded_calibrate_register_stack,
        sharded_calibrate_register_stack_lean)

    row = frame_space_mesh(1, MC_WORLD, device=device)
    sq = frame_space_mesh(2, MC_WORLD // 2, device=device)
    first = row.rank == 0

    def step(mesh, place, run, key):
        rank, kinds = MC_CHECKS[key]
        return _mc_step(mesh, place, run, key,
                        kinds if mesh.rank == rank else ())

    res = {}
    for label in ("snap", "rotated"):
        w = work[label]
        kw = lean_kernel_kwargs(w["cfg"], SIZE, SIZE)

        def place(w=w):
            return (shard_spatial(row, w["frames"]),
                    replicate(row, w["mats"]),
                    shard_spatial(row, w["masters"]),
                    replicate(row, w["er"]))

        def run(fr, mats, masters, er, kw=kw):
            out = sharded_warp_combine(fr, mats, row, masters=masters,
                                       exp_ratios=er, halo=HALO, **kw)
            return gather_rows(row, out)

        key = f"K2 {label}"
        stack, rec = step(row, place, run, key)
        res[key] = {"rank": rec, "stack": stack.cpu() if first else None}
        del stack

    unf = work["unfused"]

    def place_masters(mesh, w):
        return tuple(replicate(mesh, w[k]) for k in ("bias", "dark", "flat",
                                                     "er"))

    def run_unfused(fr, bias, dark, flat, er):
        out, diag = sharded_calibrate_register_stack(
            fr, sq, bias=bias, dark=dark, flat=flat, exp_ratios=er,
            config=unfused_config())
        return gather_rows(sq, out), diag

    (stack, diag), rec = step(
        sq, lambda: (local_frames(sq, unf["frames"]),
                     *place_masters(sq, unf)), run_unfused, "unfused")
    res["unfused"] = {"rank": rec, "stack": stack.cpu() if first else None,
                      "n_inliers": diag["n_inliers"].cpu(),
                      "matrices": diag["matrices"].cpu()}
    del stack, diag

    # with the bad-pixel repair and the flux scales, under K3 and K2
    for key, cfg in (("unfused extras", unfused_config()),
                     ("unfused fused", unfused_fused_config())):
        def run_extras(fr, bias, dark, flat, er, bad, fs, cfg=cfg):
            out, diag = sharded_calibrate_register_stack(
                fr, sq, bias=bias, dark=dark, flat=flat, exp_ratios=er,
                badpix_mask=bad, flux_scales=fs, config=cfg)
            return gather_rows(sq, out), diag

        (stack, diag), rec = step(
            sq, lambda: (local_frames(sq, unf["frames"]),
                         *place_masters(sq, unf), replicate(sq, unf["badpix"]),
                         replicate(sq, unf["flux_scales"])), run_extras, key)
        res[key] = {"rank": rec, "stack": stack.cpu() if first else None,
                    "n_inliers": diag["n_inliers"].cpu(),
                    "matrices": diag["matrices"].cpu(),
                    "halo": diag.get("halo")}
        del stack, diag

    snap = work["snap"]

    def run_lean(fr, bias, dark, flat, er, cfg):
        out, diag = sharded_calibrate_register_stack_lean(
            fr, sq, bias=bias, dark=dark, flat=flat, exp_ratios=er,
            config=cfg)
        return gather_rows(sq, out), diag

    for key, cfg in (("lean", snap["cfg"]),
                     ("lean median", dataclasses.replace(
                         snap["cfg"], noise_center="median"))):
        def run_lean_cfg(*placed, cfg=cfg):
            return run_lean(*placed, cfg=cfg)

        (stack, diag), rec = step(
            sq, lambda: (local_frames(sq, snap["frames"]),
                         *place_masters(sq, snap)), run_lean_cfg, key)
        mats = _solved_matrices(diag)
        res[key] = {"rank": rec, "stack": stack.cpu() if first else None,
                    "n_inliers": diag["n_inliers"].cpu(),
                    "matrices": mats.cpu(), "halo": diag["halo"]}
        del stack, diag
    return res


def _mc_record(label, mesh_shape, ranks, key, checks, card) -> dict:
    res = {"phase": f"multichip {label}", "world": MC_WORLD,
           "mesh": mesh_shape, "transport": MC_TRANSPORT,
           "ranks": [r[key]["rank"] for r in ranks], **checks, "card": card}
    _print(res)
    return res


def _rank_launches(label, ranks, key, required) -> dict:
    """Every rank's launches of the step checked against ``required``;
    returns each kernel's launches, one count a rank."""
    out = {}
    for r in ranks:
        launches = r[key]["rank"]["launches"]
        check_launches(f"multichip {label} rank {r[key]['rank']['rank']}",
                       launches, required)
        for name, count in launches.items():
            out.setdefault(name, []).append(count)
    return out


def _plain_errors(ranks, key) -> dict:
    """The step's kernel-vs-twin checks (one rank made them): the
    largest error of each kernel."""
    errs = {}
    for r in ranks:
        for chk in r[key]["rank"]["plain_checks"]:
            errs[chk["kernel"]] = max(errs.get(chk["kernel"], 0.0),
                                      chk["max_abs_err"])
    _require(set(errs) == set(MC_CHECKS[key][1]),
             f"multichip {key}: kernel checks {sorted(errs)}")
    return errs


def _same_on_every_rank(label, ranks, key, field) -> torch.Tensor:
    first = ranks[0][key][field]
    for r in ranks[1:]:
        _require(torch.equal(r[key][field], first),
                 f"multichip {label}: {field} differ between ranks")
    return first


def run_multichip(card: str, dev, snap: dict, rot: dict) -> dict:
    """The multi-device layer on the card: 4 ranks spawned on the one card
    (``parallel.launch.spawn``, gloo: NCCL refuses two ranks on one GPU,
    so the exchanged rows go through pinned host buffers), each given
    only its blocks of the shared-memory inputs:

    * K2 row-sharded (``sharded_warp_combine``, 1x4 mesh, halo 64, one
      1024-row band a rank) on both lean workloads with the matrices the
      lean path solved: equal to ``banded_warp_combine`` (4 bands, halo
      64) bit for bit, and the clip-tie rule against the whole frame;
    * the unfused pipeline (``sharded_calibrate_register_stack``, 2x2)
      on the first 24 snap frames with ``unfused_config()`` (K3): the
      one-process run's inliers and matrices exactly, its stack with the
      same 4 sub-bands bit for bit, the tie rule against its 2 bands;
    * the lean pipeline (``sharded_calibrate_register_stack_lean``, 2x2,
      K1 on each frame shard, K2 over 'space') on the snap workload: the
      lean path's inliers and matrices exactly, the tie rule against its
      stack, and the band loop (2 bands, the ranks' halo) bit for bit;
    * ``graft_entry.dryrun_multichip(4, size=512)`` on the card.

    In each step one rank (``MC_CHECKS``) holds its kernels against their
    plain twins on the exact arguments they got there (K1 by its rule,
    K2 and K3 bit for bit).  Prints one line per step: each rank's upload
    and wall s, kernel ms (CUDA events), launches, exchange bytes and ms
    with the host staging apart, peak memory, the twin checks.  Ranks
    that share one card take turns on it: the times measure the
    exchanges' cost, not scaling."""
    import dataclasses

    from astrophotography_tpu_torch.graft_entry import dryrun_multichip
    from astrophotography_tpu_torch.models import (
        calibrate_register_stack, calibrate_register_stack_lean)
    from astrophotography_tpu_torch.models.pipeline import lean_kernel_kwargs
    from astrophotography_tpu_torch.ops.calibrate import calibrate_batch
    from astrophotography_tpu_torch.ops.warp_combine import warp_combine
    from astrophotography_tpu_torch.parallel import banded_warp_combine
    from astrophotography_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    n_u = UNFUSED_FRAMES
    cfg_u = unfused_config()
    work, refs = {}, {}
    for w in (snap, rot):
        label = w["label"]
        mats = _solved_matrices(w["diag"])
        kw = lean_kernel_kwargs(w["cfg"], SIZE, SIZE)
        fr, masters, er, m = (t.to(dev) for t in (w["frames"], w["masters"],
                                                  w["er"], mats))
        refs[label] = {
            "banded": banded_warp_combine(fr, m, N_BANDS, masters=masters,
                                          exp_ratios=er, halo=HALO,
                                          **kw).cpu(),
            "whole": warp_combine(fr, m, masters=masters, exp_ratios=er,
                                  **kw).cpu()}
        work[label] = {"frames": w["frames"], "mats": mats.cpu(),
                       "masters": w["masters"], "er": w["er"],
                       "cfg": w["cfg"], **{k: torch.from_numpy(w[k])
                                           for k in ("bias", "dark", "flat")}}
        if label == "snap":
            kw_u = dict(bias=w["bias"], dark=w["dark"], flat=w["flat"],
                        exp_ratios=er[:n_u])
            ex = dict(kw_u, badpix_mask=torch.from_numpy(_hot(w)).to(dev),
                      flux_scales=_flux_scales(n_u).to(dev))
            for key, nb, kwr in (
                    (f"unfused {cfg_u.n_bands} bands", cfg_u.n_bands, kw_u),
                    (f"unfused {2 * cfg_u.n_bands} bands",
                     2 * cfg_u.n_bands, kw_u),
                    ("unfused extras", 2 * cfg_u.n_bands, ex)):
                out, diag = calibrate_register_stack(
                    fr[:n_u], config=dataclasses.replace(cfg_u, n_bands=nb),
                    **kwr)
                refs[key] = {
                    "stack": out.cpu(), "n_inliers": diag["n_inliers"].cpu(),
                    "matrices": diag["matrices"].cpu()}
                del out, diag
            out, diag = calibrate_register_stack(
                fr[:n_u], config=unfused_fused_config(), **ex)
            refs["unfused fused"] = {
                "stack": out.cpu(), "n_inliers": diag["n_inliers"].cpu(),
                "matrices": diag["matrices"].cpu()}
            out, diag = calibrate_register_stack_lean(
                fr, config=dataclasses.replace(w["cfg"], noise_center="median"),
                bias=w["bias"], dark=w["dark"], flat=w["flat"], exp_ratios=er)
            refs["lean median"] = {
                "stack": out.cpu(), "n_inliers": diag["n_inliers"].cpu(),
                "matrices": _solved_matrices(diag).cpu()}
            del out, diag
        del fr, masters, er, m
        torch.cuda.empty_cache()
    work["unfused"] = {"frames": snap["frames"][:n_u],
                       **{k: work["snap"][k] for k in ("bias", "dark", "flat")},
                       "er": snap["er"][:n_u],
                       "badpix": torch.from_numpy(_hot(snap)),
                       "flux_scales": _flux_scales(n_u)}
    torch.cuda.synchronize()
    refs_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    ranks = spawn(_multichip_rank, MC_WORLD, device=dev,
                  transport=MC_TRANSPORT, args=(work,))
    spawn_s = time.perf_counter() - t0
    launches, plain = {}, {}

    def add(key, required):
        launches[key] = _rank_launches(key, ranks, key, required)
        for kind, err in _plain_errors(ranks, key).items():
            plain[kind] = max(plain.get(kind, 0.0), err)

    steps = {}
    for label in ("snap", "rotated"):
        key = f"K2 {label}"
        add(key, {"warp_combine": 1})
        got = ranks[0][key]["stack"]
        ref = refs[label]
        err = float((got - ref["banded"]).abs().max())
        _require(err == 0.0 and torch.equal(got == 0, ref["banded"] == 0),
                 f"multichip {key}: differs from the band loop by {err}")
        steps[key] = _mc_record(
            key, {"frame": 1, "space": MC_WORLD}, ranks, key,
            {"shape": list(got.shape), "halo": HALO,
             "vs_banded_max_abs_err": err,
             "vs_whole_frame": _tie_rule(f"multichip {key}", got,
                                         ref["whole"])}, card)

    key = "unfused"
    add(key, {"clip_combine": cfg_u.n_bands, "warp_separable": None,
              "calibrate": 1, "find_exact": None})
    n_in = _same_on_every_rank(key, ranks, key, "n_inliers")
    mats = _same_on_every_rank(key, ranks, key, "matrices")
    one = refs[f"unfused {cfg_u.n_bands} bands"]
    same = refs[f"unfused {2 * cfg_u.n_bands} bands"]
    _require(torch.equal(n_in, one["n_inliers"]),
             f"multichip unfused: inliers {n_in.tolist()} against "
             f"{one['n_inliers'].tolist()}")
    _require(torch.equal(mats, one["matrices"]),
             "multichip unfused: matrices differ from the one-process run's")
    got = ranks[0][key]["stack"]
    err = float((got - same["stack"]).abs().max())
    _require(err == 0.0 and torch.equal(got == 0, same["stack"] == 0),
             f"multichip unfused: differs from the one-process run with the "
             f"same {2 * cfg_u.n_bands} bands by {err}")
    steps[key] = _mc_record(
        key, {"frame": 2, "space": MC_WORLD // 2}, ranks, key,
        {"shape": [n_u, SIZE, SIZE], "n_bands": cfg_u.n_bands,
         "min_inliers": int(n_in.min()),
         "vs_one_process_same_bands_max_abs_err": err,
         "vs_one_process": _tie_rule("multichip unfused", got, one["stack"])},
        card)

    key = "lean"
    add(key, {"detect_tiles": 1, "warp_combine": 1})
    n_in = _same_on_every_rank(key, ranks, key, "n_inliers")
    mats = _same_on_every_rank(key, ranks, key, "matrices")
    halos = {r[key]["halo"] for r in ranks}
    _require(len(halos) == 1, f"multichip lean: halos {halos} differ")
    (halo,) = halos
    _require(torch.equal(n_in, snap["diag"]["n_inliers"]),
             "multichip lean: inliers differ from the lean path's")
    _require(torch.equal(mats, _solved_matrices(snap["diag"])),
             "multichip lean: matrices differ from the lean path's")
    got = ranks[0][key]["stack"]
    fr, masters, er = (t.to(dev) for t in (snap["frames"], snap["masters"],
                                           snap["er"]))
    banded = banded_warp_combine(
        fr, mats.to(dev), MC_WORLD // 2, masters=masters, exp_ratios=er,
        halo=halo, **lean_kernel_kwargs(snap["cfg"], SIZE, SIZE)).cpu()
    del fr, masters, er
    torch.cuda.empty_cache()
    err = float((got - banded).abs().max())
    _require(err == 0.0 and torch.equal(got == 0, banded == 0),
             f"multichip lean: differs from the band loop by {err}")
    steps[key] = _mc_record(
        key, {"frame": 2, "space": MC_WORLD // 2}, ranks, key,
        {"shape": [N_FRAMES, SIZE, SIZE], "min_inliers": int(n_in.min()),
         "halo": halo, "vs_banded_max_abs_err": err,
         "vs_lean_path": _tie_rule("multichip lean", got, snap["stacked"])},
        card)

    key = "unfused extras"
    add(key, {"clip_combine": cfg_u.n_bands, "warp_separable": None,
              "calibrate": 1, "find_exact": None})
    n_in = _same_on_every_rank(key, ranks, key, "n_inliers")
    mats = _same_on_every_rank(key, ranks, key, "matrices")
    want = refs[key]
    _require(torch.equal(n_in, want["n_inliers"]) and
             torch.equal(mats, want["matrices"]),
             f"multichip {key}: inliers or matrices differ from the "
             f"one-process run's")
    got = ranks[0][key]["stack"]
    err = float((got - want["stack"]).abs().max())
    _require(err == 0.0 and torch.equal(got == 0, want["stack"] == 0),
             f"multichip {key}: differs from the one-process run with the "
             f"same {2 * cfg_u.n_bands} bands by {err}")
    steps[key] = _mc_record(
        key, {"frame": 2, "space": MC_WORLD // 2}, ranks, key,
        {"shape": [n_u, SIZE, SIZE], "n_bands": cfg_u.n_bands,
         "badpix_pixels": int(work["unfused"]["badpix"].sum()),
         "min_inliers": int(n_in.min()),
         "vs_one_process_same_bands_max_abs_err": err}, card)

    key = "unfused fused"
    add(key, {"warp_combine": 1, "calibrate": 1, "find_exact": None})
    n_in = _same_on_every_rank(key, ranks, key, "n_inliers")
    mats = _same_on_every_rank(key, ranks, key, "matrices")
    halos = {r[key]["halo"] for r in ranks}
    _require(len(halos) == 1, f"multichip {key}: halos {halos} differ")
    (halo,) = halos
    want = refs[key]
    _require(torch.equal(n_in, want["n_inliers"]) and
             torch.equal(mats, want["matrices"]),
             f"multichip {key}: inliers or matrices differ from the "
             f"one-process run's")
    unf = work["unfused"]
    cal = calibrate_batch(
        unf["frames"].to(dev), *(unf[k].to(dev) for k in ("bias", "dark",
                                                          "flat", "er")),
        dark_still_biased=cfg_u.dark_still_biased,
        badpix_mask=unf["badpix"].to(dev)) \
        * unf["flux_scales"].to(dev)[:, None, None]
    banded = banded_warp_combine(
        cal, mats.to(dev), MC_WORLD // 2, halo=halo,
        **lean_kernel_kwargs(unfused_fused_config(), SIZE, SIZE)).cpu()
    del cal
    torch.cuda.empty_cache()
    got = ranks[0][key]["stack"]
    err = float((got - banded).abs().max())
    _require(err == 0.0 and torch.equal(got == 0, banded == 0),
             f"multichip {key}: differs from the band loop by {err}")
    steps[key] = _mc_record(
        key, {"frame": 2, "space": MC_WORLD // 2}, ranks, key,
        {"shape": [n_u, SIZE, SIZE], "halo": halo,
         "min_inliers": int(n_in.min()), "vs_banded_max_abs_err": err,
         "vs_one_process": _tie_rule(f"multichip {key}", got, want["stack"])},
        card)

    key = "lean median"
    add(key, {"detect_tiles": 1, "warp_combine": 1})
    n_in = _same_on_every_rank(key, ranks, key, "n_inliers")
    mats = _same_on_every_rank(key, ranks, key, "matrices")
    halos = {r[key]["halo"] for r in ranks}
    _require(len(halos) == 1, f"multichip {key}: halos {halos} differ")
    (halo,) = halos
    want = refs[key]
    _require(torch.equal(n_in, want["n_inliers"]) and
             torch.equal(mats, want["matrices"]),
             f"multichip {key}: inliers or matrices differ from the "
             f"one-process lean run's")
    fr, masters, er = (t.to(dev) for t in (snap["frames"], snap["masters"],
                                           snap["er"]))
    banded = banded_warp_combine(
        fr, mats.to(dev), MC_WORLD // 2, masters=masters, exp_ratios=er,
        halo=halo, **lean_kernel_kwargs(snap["cfg"], SIZE, SIZE)).cpu()
    del fr, masters, er
    torch.cuda.empty_cache()
    got = ranks[0][key]["stack"]
    err = float((got - banded).abs().max())
    _require(err == 0.0 and torch.equal(got == 0, banded == 0),
             f"multichip {key}: differs from the band loop by {err}")
    steps[key] = _mc_record(
        key, {"frame": 2, "space": MC_WORLD // 2}, ranks, key,
        {"shape": [N_FRAMES, SIZE, SIZE], "min_inliers": int(n_in.min()),
         "halo": halo, "vs_banded_max_abs_err": err,
         "vs_lean_path": _tie_rule(f"multichip {key}", got, want["stack"])},
        card)

    t0 = time.perf_counter()
    dry = dryrun_multichip(MC_WORLD, size=512, device=dev)
    dry_s = time.perf_counter() - t0
    _require(all(r["launches"]["warp_combine"] == 2 for r in dry),
             "multichip dry run: K2 not launched twice on every rank")
    launches["dry run"] = {name: [r["launches"][name] for r in dry]
                           for name in dry[0]["launches"]}
    res = {"phase": "multichip", "world": MC_WORLD,
           "transport": MC_TRANSPORT, "launches": launches,
           "plain_max_abs_err": plain, "references_s": refs_s,
           "spawn_s": spawn_s, "dryrun_s": dry_s,
           "wall_s": time.perf_counter() - t_phase, "card": card}
    _print(res)
    return res


#: the measurement phase's frame: a 4008 x 2672 sensor, stars of
#: MEASURE_FWHM on a jittered grid, Poisson-like noise on the sky
MEASURE_SHAPE = (2672, 4008)
MEASURE_FWHM = 3.5


def make_starfield(seed: int = 0, shape=MEASURE_SHAPE, grid=(20, 30)):
    """A synthetic float32 starfield, (2672, 4008) by default: a sky of
    800 ADU with a 5 % gradient, one Gaussian star of FWHM 3.5 px in
    each cell of a 20 x 30 grid, jittered by 30 px (600 stars, isolated
    by construction) with fluxes of 2e4 to 2e5 ADU, and Gaussian noise
    of sqrt(800) ADU.

    Returns (image, sky, star x, star y, star flux)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    n = grid[0] * grid[1]
    yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    sky = (SKY * (1.0 + 0.03 * xx + 0.02 * yy)).astype(np.float32)
    gy, gx = np.meshgrid((np.arange(grid[0]) + 0.5) * (h / grid[0]),
                         (np.arange(grid[1]) + 0.5) * (w / grid[1]),
                         indexing="ij")
    xs = gx.ravel() + rng.uniform(-30, 30, n)
    ys = gy.ravel() + rng.uniform(-30, 30, n)
    fl = rng.uniform(2e4, 2e5, n)
    fl[:2] = (1.5e5, 1.0e5)             # the pair whose flux ratio is held
    img = sky.copy()
    for x, y, f in zip(xs, ys, fl):
        x0, y0 = int(x) - 12, int(y) - 12
        img[y0:y0 + 25, x0:x0 + 25] += _gaussian_star(
            (25, 25), x - x0, y - y0, f, MEASURE_FWHM).astype(np.float32)
    img += rng.normal(0, np.sqrt(SKY), (h, w)).astype(np.float32)
    return img, sky, xs, ys, fl


def _op(times, peaks, name, fn):
    """fn()'s result, with its device ms (CUDA events, after a warm-up
    call) and its peak memory recorded under ``name``."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, times[name] = _timed(fn)
    peaks[name] = torch.cuda.max_memory_allocated()
    return out


def run_measure(card: str, dev) -> dict:
    """The repair and measurement ops on one 4008 x 2672 frame, each
    checked against what was planted and timed: bad-pixel mask and
    repair, L.A.Cosmic, source mask and background (both upsamples),
    detection, aperture photometry, PSF fits, the colour stretch."""
    from astrophotography_tpu_torch.ops import (
        aperture_photometry, aperture_radii, background2d, find_stars,
        fix_bad_pixels, isolated_mask, measure_fwhm, median_fwhm,
        sigmaclip_badpix_mask, source_mask)
    from astrophotography_tpu_torch.ops.composite import stretch_channels
    from astrophotography_tpu_torch.ops.cosmic import lacosmic

    t0 = time.perf_counter()
    img_np, sky_np, xs, ys, fl = make_starfield()
    rng = np.random.default_rng(1)
    h, w = img_np.shape
    sigma = float(np.sqrt(SKY))
    near_star = np.zeros((h, w), bool)
    for x, y in zip(xs, ys):
        near_star[int(y) - 12:int(y) + 13, int(x) - 12:int(x) + 13] = True
    # ~0.1 % hot pixels: in a master dark, and on top of the light frame
    hot = rng.random((h, w)) < 1e-3
    dark_np = (40.0 + rng.normal(0, 3.0, (h, w))).astype(np.float32)
    dark_np[hot] += rng.uniform(200, 5000, int(hot.sum())).astype(np.float32)
    hot_img = img_np.copy()
    hot_img[hot] += dark_np[hot]
    # single-pixel cosmic-ray hits off the stars
    hits = (rng.random((h, w)) < 2e-4) & ~near_star
    cr_img = img_np.copy()
    cr_img[hits] += rng.uniform(1000, 8000, int(hits.sum())).astype(np.float32)
    gen_s = time.perf_counter() - t0
    img, sky, dark, hot_t, hits_t, hot_in, cr_in = (
        torch.from_numpy(a).to(dev)
        for a in (img_np, sky_np, dark_np, hot, hits, hot_img, cr_img))
    times, peaks, res = {}, {}, {}

    # bad pixels: every planted one flagged, and repaired to within the
    # noise of its neighbours' median against the frame without it
    mask = _op(times, peaks, "sigmaclip_badpix_mask",
               lambda: sigmaclip_badpix_mask(dark, sigma=4.0))
    _require(bool(mask[hot_t].bool().all()), "planted hot pixels not flagged")
    fixed, still = _op(times, peaks, "fix_bad_pixels",
                       lambda: fix_bad_pixels(hot_in, mask))
    _op(times, peaks, "fix_bad_pixels_deltapix2",
        lambda: fix_bad_pixels(hot_in, mask, deltapix=2))
    _require(not bool(still.any()), "bad pixels left unrepaired")
    off_star = hot_t & ~torch.from_numpy(near_star).to(dev)
    err = (fixed - img).abs()
    _require(float(err[off_star].max()) < 6.0 * sigma,
             f"repaired pixels off by {float(err[off_star].max())} ADU")
    _require(bool((fixed[hot_t] < hot_in[hot_t]).all())
             and bool(torch.equal(fixed[mask == 0], hot_in[mask == 0])),
             "repair touched good pixels or raised a bad one")
    res["badpix"] = {"planted": int(hot.sum()), "flagged": int(mask.sum()),
                     "max_err_off_stars_adu": float(err[off_star].max()),
                     "noise_adu": sigma}
    del mask, fixed, still, err, hot_in, dark

    # cosmic rays: >= 90 % of the planted hits flagged, no star core
    clean, crmask = _op(times, peaks, "lacosmic", lambda: lacosmic(
        cr_in, readnoise=0.0, satlevel_e=65535.0))
    found = float(crmask[hits_t].float().mean())
    cores = crmask[torch.from_numpy(np.rint(ys).astype(np.int64)).to(dev),
                   torch.from_numpy(np.rint(xs).astype(np.int64)).to(dev)]
    _require(found >= 0.9, f"only {found:.3f} of the cosmic-ray hits flagged")
    _require(not bool(cores.any()), f"{int(cores.sum())} star cores flagged")
    _require(float((clean - img).abs()[hits_t & crmask].max()) < 6.0 * sigma,
             "a flagged hit was not cleaned to the noise")
    res["cosmic"] = {"planted": int(hits.sum()), "flagged_fraction": found,
                     "flagged_in_all": int(crmask.sum()),
                     "star_cores_flagged": int(cores.sum())}
    del clean, crmask, cr_in

    # background: within 1 % of the synthetic sky everywhere
    smask = _op(times, peaks, "source_mask", lambda: source_mask(img))
    res["background"] = {"masked_fraction": float(smask.float().mean())}
    for upsample in ("bilinear", "spline"):
        bkg = _op(times, peaks, f"background2d_{upsample}",
                  lambda: background2d(img, smask, nboxes_y=16, nboxes_x=24,
                                       upsample=upsample))
        rel = float(((bkg - sky).abs() / sky).max())
        _require(rel < 0.01, f"background2d {upsample} off by {rel:.4f}")
        res["background"][f"{upsample}_max_rel_err"] = rel
    sub = img - bkg
    del smask

    # stars: detection, photometry, PSF
    stars = _op(times, peaks, "find_stars", lambda: find_stars(
        sub, fwhm=MEASURE_FWHM, threshold=5.0 * sigma, max_stars=1024))
    px, py = (torch.from_numpy(a.astype(np.float32)).to(dev)
              for a in (xs, ys))
    d2 = (stars.x[None, :] - px[:, None]) ** 2 \
        + (stars.y[None, :] - py[:, None]) ** 2
    d2 = torch.where(stars.valid[None, :], d2, torch.inf)
    nearest = d2.argmin(dim=1)                   # detection of each planted
    matched = d2.amin(dim=1) < 1.0
    _require(float(matched.float().mean()) > 0.98,
             f"only {int(matched.sum())} of {len(xs)} planted stars detected")
    r_ap, r_out = aperture_radii(MEASURE_FWHM)
    phot = _op(times, peaks, "aperture_photometry",
               lambda: aperture_photometry(img, stars.x, stars.y, stars.valid,
                                           r_ap, r_out, exposure=30.0))
    ratio = float(phot.aperture_sum[nearest[0]] / phot.aperture_sum[nearest[1]])
    _require(abs(ratio / (fl[0] / fl[1]) - 1.0) < 0.02,
             f"flux ratio {ratio} against {fl[0] / fl[1]}")
    flux_err = float((phot.aperture_sum[nearest][matched]
                      / torch.from_numpy(fl.astype(np.float32)).to(dev)[matched]
                      - 1.0).abs().median())
    iso = isolated_mask(stars.x, stars.y, stars.valid, 16.0)
    fits = _op(times, peaks, "measure_fwhm", lambda: measure_fwhm(
        sub, stars.x, stars.y, iso, init_fwhm=3.0))
    (mfx, sfx), (mfy, sfy) = _op(times, peaks, "median_fwhm",
                                 lambda: median_fwhm(fits))
    for m in (mfx, mfy):
        _require(abs(float(m) / MEASURE_FWHM - 1.0) < 0.1,
                 f"median FWHM {float(m)} against {MEASURE_FWHM}")
    res["stars"] = {"detected": int(stars.valid.sum()),
                    "planted_matched": int(matched.sum()),
                    "flux_ratio": ratio, "flux_ratio_planted": fl[0] / fl[1],
                    "median_flux_rel_err": flux_err,
                    "fits_valid": int(fits.valid.sum()),
                    "median_fwhm_x": float(mfx), "median_fwhm_y": float(mfy),
                    "fwhm_madstd_x": float(sfx), "fwhm_planted": MEASURE_FWHM}

    # colour stretch of three scaled copies
    chans = torch.stack([sub, 0.8 * sub, 1.2 * sub])
    rgb = _op(times, peaks, "stretch_channels",
              lambda: stretch_channels(chans))
    _require(tuple(rgb.shape) == (h, w, 3) and bool(torch.isfinite(rgb).all())
             and float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
             and 0.02 < float(rgb.mean()) < 0.9, "stretch out of range")
    res["stretch_mean"] = float(rgb.mean())
    out = {"phase": "measure", "shape": [h, w], "ms": times,
           "peak_memory_bytes": peaks,
           "max_peak_memory_bytes": max(peaks.values()),
           "workload_gen_s": gen_s, **res, "card": card}
    _print(out)
    del chans, rgb, sub, img
    torch.cuda.empty_cache()
    return out


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _ahd_tie_rule(label, got, want, cands) -> dict:
    """AHD on two devices: equal within 1e-5 * |ref| + 0.05 on all but a
    small share of the pixels, and at every differing pixel the value is
    one of the three the function could have chosen there (the
    horizontal candidate, the vertical one, or their mean)."""
    bad = ((got - want).abs() > 1e-5 * want.abs() + 0.05).any(dim=-1)
    share = float(bad.float().mean())
    _require(share <= 1e-3, f"{label}: AHD differs on {share:.2e} of the "
             "pixels")
    if bool(bad.any()):
        ch, cv = cands
        options = torch.stack([ch[bad], cv[bad], 0.5 * (ch[bad] + cv[bad])])
        err = (options - got[bad][None]).abs().amax(dim=-1).amin(dim=0)
        tol = 1e-5 * got[bad].abs().amax(dim=-1) + 0.05
        _require(bool((err <= tol).all()),
                 f"{label}: an AHD pixel is none of its three candidates")
    return {"pixels_differing": int(bad.sum()), "share": share,
            "max_abs": float((got - want).abs().max())}


def _raw_correctness(tmp: str, card: str, dev) -> dict:
    """One planted 3904^2 scene -> mosaic -> lossless-JPEG DNG ->
    ``RawConv``: every algorithm against the scene at the bounds of the
    JAX package's own tests, measured sites kept exactly, grey = the
    CCIR-601 sum of rgb, split zero off-band, every white-balance
    method, and the card against the port's own CPU run."""
    from astrophotography_tpu_torch import synth
    from astrophotography_tpu_torch.core.raw_conv import RawConv
    from astrophotography_tpu_torch.device import to_uint16
    from astrophotography_tpu_torch.io.raw import write_dng
    from astrophotography_tpu_torch.ops import demosaic as dk

    t0 = time.perf_counter()
    shape = (RAW_SIZE, RAW_SIZE)
    blacks = (512, 500, 520, 508)
    gains = (2.0, 1.0, 1.5, 1.0)
    scene = synth.make_rgb_scene(shape, seed=5, peak=30000)
    mosaic = synth.mosaic_from_rgb(scene, black_levels=blacks,
                                   wb_gains=gains)
    path = os.path.join(tmp, "scene.dng")
    write_dng(path, mosaic, black_levels=blacks, white_level=65535,
              camera_wb=gains, compression=7)
    gen_s = time.perf_counter() - t0
    conv = RawConv(path, device=dev)
    host = RawConv(path, device="cpu")
    _require(torch.equal(conv._mosaic.cpu(), torch.from_numpy(mosaic)),
             "raw: the DNG decodes to the mosaic that was written")
    res = {"phase": "raw correctness", "shape": list(shape),
           "dng_bytes": os.path.getsize(path), "make_scene_s": gen_s}

    # each algorithm against the scene, on the card, and against the CPU
    scale = 65535.0 / (65535.0 - max(blacks))
    inner = (slice(2, -2), slice(2, -2))
    truth = torch.from_numpy((scene * scale).astype(np.float32)).to(dev)
    cmap = conv._color_map
    chans = ((0, 0), (1, 1), (3, 1), (2, 2))      # colour index -> channel
    for algorithm, rtol in (("mhc", 0.25), ("bilinear", 0.15),
                            ("ahd", 0.25)):
        out, _ = conv.rgb(wb_method="camera", demosaic=algorithm)
        _require(out.dtype == np.uint16 and out.shape == shape + (3,),
                 f"raw {algorithm}: uint16 (H, W, 3)")
        got = torch.from_numpy(out.astype(np.float32)).to(dev)
        ratio = got[inner] / truth[inner]
        means = [float(ratio[..., c].mean()) for c in range(3)]
        stds = [float(ratio[..., c].std()) for c in range(3)]
        outside = float(((got[inner] - truth[inner]).abs()
                         > rtol * truth[inner].abs() + 101.0)
                        .float().mean())
        # the bounds are wider than on the 32 x 32 case below: this
        # scene has 238,000 cells of 8 px, among them every sharp kink,
        # where a demosaic overshoots (AHD most: ratio 1.009 +- 0.073 in
        # red at 1024^2 on the CPU, 0.9 % of the pixels outside)
        _require(all(abs(m - 1.0) < 0.02 for m in means)
                 and all(sd < 0.12 for sd in stds) and outside < 0.03,
                 f"raw {algorithm}: scene recovered ({means}, {stds}, "
                 f"{outside})")
        # float results of the same call on both devices
        args_d = (conv._mosaic, cmap, conv._black_levels,
                  conv._wb_array("camera"), 65535.0)
        args_h = (host._mosaic, host._color_map, host._black_levels,
                  host._wb_array("camera"), 65535.0)
        f_d = dk.raw_to_rgb(*args_d, algorithm=algorithm)
        f_h = dk.raw_to_rgb(*args_h, algorithm=algorithm).to(dev)
        # measured sites keep their own (scaled) sample exactly
        sites = dk.raw_to_grey_direct(*args_d[:4]) * _range_scale(conv)
        for color, chan in chans:
            m = cmap == color
            _require(torch.equal(f_d[..., chan][m], sites[m]),
                     f"raw {algorithm}: colour {color} sites kept exactly")
        if algorithm == "ahd":
            cmp_ = _ahd_tie_rule("raw", f_d, f_h,
                                 dk._ahd_candidates(sites, cmap))
        else:
            cmp_ = {"max_abs": float((f_d - f_h).abs().max())}
            _require(cmp_["max_abs"] <= 0.05, f"raw {algorithm}: card "
                     f"against CPU max |d| {cmp_['max_abs']}")
        cmp_["pixels_differing_after_cast"] = int(
            (to_uint16(f_d).view(torch.int16)
             != to_uint16(f_h).view(torch.int16)).any(dim=-1).sum())
        res[algorithm] = {"ratio_mean": means, "ratio_std": stds,
                          "share_outside_pixel_bound": outside,
                          "card_vs_cpu": cmp_}
        del f_h, got, ratio
    # grey linear is the three-term CCIR-601 sum of the clipped rgb
    rgb = dk.raw_to_rgb(*args_d).clamp(0.0, 65535.0)
    luma = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]) + 0.114 * rgb[..., 2]
    grey_d = dk.raw_to_grey_linear(*args_d)
    _require(torch.equal(grey_d, luma), "raw: grey = CCIR-601 sum of rgb")
    grey_h = dk.raw_to_grey_linear(*args_h).to(dev)
    res["grey_linear"] = {
        "card_vs_cpu_max_abs": float((grey_d - grey_h).abs().max()),
        "pixels_differing_after_cast": int(
            (to_uint16(grey_d).view(torch.int16)
             != to_uint16(grey_h).view(torch.int16)).sum())}
    _require(res["grey_linear"]["card_vs_cpu_max_abs"] <= 0.05,
             "raw: grey on the card against the CPU")
    del rgb, luma, grey_h
    # split: each band keeps its own sites, zero elsewhere
    bands = conv.split(subtract_black=True)[:4]
    sub = np.maximum(mosaic.astype(np.int64)
                     - np.asarray(blacks)[host._raw.color_map], 0)
    for color, band in enumerate(bands):
        m = host._raw.color_map == color
        _require(not band[~m].any() and np.array_equal(band[m], sub[m]),
                 f"raw: split band {color}")
    # every white-balance method, the card against the CPU
    wb = {}
    n = RAW_SIZE
    for method in ("daylight", "camera", "auto",
                   f"region[{n // 32},{3 * n // 4},{n // 16},{7 * n // 8}]",
                   "user[2.0,1.0,1.5]"):
        a = np.asarray(conv.get_whitebalance(method))
        b = np.asarray(host.get_whitebalance(method))
        wb[method] = {"card": a.tolist(),
                      "rel_diff_vs_cpu": float(np.abs(a / b - 1).max())}
        _require(wb[method]["rel_diff_vs_cpu"] < 1e-5,
                 f"raw: white balance {method} on the card against the CPU")
        img, _ = conv.grey(wb_method=method)
        _require(img.shape == shape and img.dtype == np.uint16
                 and img.max() > 1000, f"raw: grey with {method}")
    # the scene's channels were divided by the gains: 'auto' finds them
    res["whitebalance"] = wb
    direct, _ = conv.grey(luminance_method="direct", wb_method="camera")
    stretched, _ = conv.grey(wb_method="camera", renorm=True)
    _require(direct.shape == shape and stretched.max() == 65535,
             "raw: direct grey and the percentile stretch")
    res["small_scene"] = _raw_small_scene(tmp, dev)
    res["card"] = card
    _print(res)
    return res


def _raw_small_scene(tmp: str, dev) -> dict:
    """The 32 x 32 scene of the JAX package's own demosaic test through
    DNG and ``RawConv`` on the card, at that test's bounds: ratio to the
    scene 1 +- 0.01 in the mean, under 0.03 in spread, every interior
    pixel within rtol (0.15 bilinear, 0.25 mhc) and 100 ADU, one more
    for the uint16 cast."""
    from astrophotography_tpu_torch import synth
    from astrophotography_tpu_torch.core.raw_conv import RawConv
    from astrophotography_tpu_torch.io.raw import write_dng

    blacks, gains = (512, 500, 520, 508), (2.0, 1.0, 1.5, 1.0)
    scene = synth.make_rgb_scene((32, 32), seed=5, peak=30000)
    path = os.path.join(tmp, "small.dng")
    write_dng(path, synth.mosaic_from_rgb(scene, black_levels=blacks,
                                          wb_gains=gains),
              black_levels=blacks, white_level=65535, camera_wb=gains,
              compression=7)
    conv = RawConv(path, device=dev)
    os.remove(path)
    truth = scene * (65535.0 / (65535.0 - max(blacks)))
    inner = (slice(2, -2), slice(2, -2))
    res = {}
    for algorithm, rtol in (("bilinear", 0.15), ("mhc", 0.25)):
        out = conv.rgb(wb_method="camera", demosaic=algorithm)[0] \
            .astype(np.float64)
        ratio = out[inner] / truth[inner]
        means = ratio.mean(axis=(0, 1))
        stds = ratio.std(axis=(0, 1))
        excess = float((np.abs(out[inner] - truth[inner])
                        - rtol * truth[inner]).max())
        _require(bool((np.abs(means - 1.0) < 0.01).all())
                 and bool((stds < 0.03).all()) and excess <= 101.0,
                 f"raw {algorithm}: the 32 x 32 scene at the test's bounds "
                 f"({means}, {stds}, {excess})")
        res[algorithm] = {"ratio_mean": means.tolist(),
                          "ratio_std": stds.tolist(),
                          "worst_excess_over_rtol": excess}
    return res


def _range_scale(conv) -> torch.Tensor:
    """The range scale ``raw_to_rgb`` applies, as it computes it."""
    white = torch.tensor(float(conv._raw.white_level), dtype=torch.float32,
                         device=conv._device)
    return 65535.0 / (white - conv._black_levels.max()).clamp(min=1.0)


def _raw_pipeline(tmp: str, card: str, dev) -> dict:
    """24 lossless-JPEG DNGs of 3904^2 -> grey FITS: ``api.grey`` frame
    by frame, the three-stage loop (one warm pass, two timed), and one
    serial pass with a sync after every stage for the split."""
    from astrophotography_tpu_torch import api
    from astrophotography_tpu_torch.core.raw_conv import RawConv
    from astrophotography_tpu_torch.device import to_uint16
    from astrophotography_tpu_torch.io.fits import (Header, read_image,
                                                    write_image)
    from astrophotography_tpu_torch.io.raw import load_raw
    from astrophotography_tpu_torch.ops import demosaic as dk
    from astrophotography_tpu_torch.parallel import AsyncWriter
    from bench_rawgrey_torch import write_dngs

    # bench_rawgrey's DNG set: one mosaic of sky statistics (background +
    # noise, not 16-bit white noise: the entropy decoder's cost follows
    # real camera frames), encoded once, written to every file
    t0 = time.perf_counter()
    base, paths = write_dngs(tmp, RAW_FRAMES, RAW_SIZE)
    dng_set_s = time.perf_counter() - t0
    mpix = RAW_SIZE * RAW_SIZE / 1e6

    # what every output must hold: the conversion of the decoded mosaic
    first = RawConv(paths[0], device=dev)
    _require(np.array_equal(first._raw.mosaic, base),
             "raw: the DNG decodes to the frame that was encoded")
    want = to_uint16(dk.raw_to_grey_linear(
        first._mosaic, first._color_map, first._black_levels,
        first._wb_array("daylight"), first._raw.white_level)).cpu().numpy()
    del first

    def verify(names, what):
        for name in names:
            got, _ = read_image(name, as_float32=False)
            _require(got.dtype == np.uint16 and np.array_equal(got, want),
                     f"raw: {what} {os.path.basename(name)} holds the "
                     "conversion of its mosaic")

    # api.grey, file -> FITS, frame by frame
    api.grey(paths[0], os.path.join(tmp, "warm.fits"), device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [p[:-4] + "_api.fits" for p in paths]
    for p, o in zip(paths, outs):
        api.grey(p, o, device=dev)
    api_s = time.perf_counter() - t0
    verify(outs, "api.grey output")
    for o in outs + [os.path.join(tmp, "warm.fits")]:
        os.remove(o)

    # the three-stage loop: decode thread -> device convert -> writer
    def run_once() -> dict:
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        writer = AsyncWriter()
        decoded: "queue.Queue" = queue.Queue(maxsize=2)
        busy = {"decode_s": 0.0}

        def decode_ahead():
            for p in paths:
                t = time.perf_counter()
                raw = load_raw(p)
                busy["decode_s"] += time.perf_counter() - t
                decoded.put((p, raw))
            decoded.put(None)

        thread = threading.Thread(target=decode_ahead, daemon=True)
        thread.start()
        wait_s = 0.0
        while True:
            t = time.perf_counter()
            item = decoded.get()
            wait_s += time.perf_counter() - t
            if item is None:
                break
            p, raw = item
            conv = RawConv(p, raw_image=raw, device=dev)
            img, _exif = conv.grey(wb_method="daylight", renorm=False,
                                   fetch=False)
            writer.submit(p[:-4] + ".fits", img, Header())
        thread.join()
        t = time.perf_counter()
        writer.close()
        drain_s = time.perf_counter() - t
        total = time.perf_counter() - t_start
        return {"seconds": total, "frames_per_s": RAW_FRAMES / total,
                "decode_thread_busy_s": busy["decode_s"],
                "main_waits_for_decode_s": wait_s,
                "writer_drain_s": drain_s}

    run_once()                                          # warm
    torch.cuda.reset_peak_memory_stats()
    passes = [run_once() for _ in range(2)]
    peak = torch.cuda.max_memory_allocated()
    verify([p[:-4] + ".fits" for p in paths], "loop output")

    # the split: the same stages in turn, a sync after each
    split = {k: 0.0 for k in ("decode_s", "upload_ms", "device_ms",
                              "download_ms", "write_s")}
    for p in paths:
        t = time.perf_counter()
        raw = load_raw(p)
        split["decode_s"] += time.perf_counter() - t
        conv, ms = _timed(lambda: RawConv(p, raw_image=raw, device=dev))
        split["upload_ms"] += ms
        (img, _), ms = _timed(lambda: conv.grey(wb_method="daylight",
                                                fetch=False))
        split["device_ms"] += ms
        t = time.perf_counter()
        arr = img.cpu().numpy()
        split["download_ms"] += (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        write_image(p[:-4] + ".fits", arr, Header())
        split["write_s"] += time.perf_counter() - t
    split = {k: v / RAW_FRAMES for k, v in split.items()}
    per_frame_s = (split["decode_s"] + split["write_s"]
                   + (split["upload_ms"] + split["device_ms"]
                      + split["download_ms"]) / 1e3)
    res = {"phase": "raw pipeline", "frames": RAW_FRAMES,
           "frame": [RAW_SIZE, RAW_SIZE], "mpix": mpix,
           "dng_bytes": os.path.getsize(paths[0]),
           "dng_set_s": dng_set_s,
           "api_grey": {"seconds": api_s,
                        "frames_per_s": RAW_FRAMES / api_s},
           "loop_passes": passes,
           "loop_frames_per_s": max(r["frames_per_s"] for r in passes),
           "split_per_frame": split, "split_sum_s": per_frame_s,
           "device_share_of_frame": split["device_ms"] / 1e3 / per_frame_s,
           "peak_bytes": peak, "temp_bytes": _dir_bytes(tmp), "card": card}
    _print(res)
    return res


def _raw_functions(card: str, dev) -> dict:
    """Device ms (CUDA events after a warm-up) and peak memory of each
    ``ops/demosaic`` function on one 3904^2 mosaic."""
    from astrophotography_tpu_torch import synth
    from astrophotography_tpu_torch.device import to_float32
    from astrophotography_tpu_torch.ops import demosaic as dk

    rng = np.random.default_rng(2)
    shape = (RAW_SIZE, RAW_SIZE)
    mosaic = torch.from_numpy(np.clip(
        rng.normal(4000.0, 600.0, shape), 0, 16383).astype(np.uint16)).to(dev)
    cmap = torch.from_numpy(synth.bayer_color_map(shape)).to(dev) \
        .to(torch.int64)
    blacks = torch.tensor([512.0, 500.0, 520.0, 508.0], device=dev)
    wb = torch.tensor([2.0, 1.0, 1.5, 1.0], device=dev)
    vals = to_float32(mosaic)
    sub = dk.safe_subtract_black(mosaic, cmap, blacks)
    times, peaks = {}, {}
    for name in ("demosaic_bilinear", "demosaic_mhc", "demosaic_ahd"):
        out = _op(times, peaks, name, lambda: getattr(dk, name)(vals, cmap))
        _require(out.shape == shape + (3,)
                 and bool(torch.isfinite(out).all()), f"raw: {name}")
        del out
    for name in ("raw_to_rgb", "raw_to_grey_linear"):
        out = _op(times, peaks, name, lambda: getattr(dk, name)(
            mosaic, cmap, blacks, wb, 16383.0))
        _require(bool(torch.isfinite(out).all()), f"raw: {name}")
        del out
    _op(times, peaks, "raw_to_grey_direct",
        lambda: dk.raw_to_grey_direct(mosaic, cmap, blacks, wb))
    _op(times, peaks, "safe_subtract_black",
        lambda: dk.safe_subtract_black(mosaic, cmap, blacks))
    out = _op(times, peaks, "split_channels",
              lambda: dk.split_channels(mosaic, cmap, blacks))
    _require(out.shape == (4,) + shape, "raw: split_channels")
    del out
    region = [0, RAW_SIZE - 1, 0, RAW_SIZE - 1]
    got = _op(times, peaks, "wb_from_region",
              lambda: dk.wb_from_region(sub, cmap, region))
    # 15 M float32 values a band: the card's sum against the CPU's, and
    # both against a float64 sum
    on_cpu = dk.wb_from_region(sub.cpu(), cmap.cpu(), region)
    sub64, cmap_np = sub.cpu().numpy().astype(np.float64), cmap.cpu().numpy()
    avg = np.array([sub64[cmap_np == c].mean() for c in range(4)])
    exact = avg.max() / avg
    wb_cmp = {"card_vs_cpu": float((got.cpu() / on_cpu - 1).abs().max()),
              "card_vs_float64": float(np.abs(got.cpu().numpy() / exact
                                              - 1).max()),
              "cpu_vs_float64": float(np.abs(on_cpu.numpy() / exact
                                             - 1).max())}
    _require(wb_cmp["card_vs_cpu"] < 1e-5 and wb_cmp["card_vs_float64"] < 1e-5,
             f"raw: wb_from_region sums {wb_cmp}")
    out = _op(times, peaks, "percentile_renorm",
              lambda: dk.percentile_renorm(sub))
    lo, hi = np.percentile(sub64, [0.01, 99.99])
    ref = (sub64 - lo) * (65535.0 / (hi - lo))
    pct_err = float(np.abs(out.cpu().numpy() - ref).max())
    _require(pct_err <= 3e-5 * 65535.0,
             f"raw: percentile_renorm against float64 numpy ({pct_err})")
    res = {"phase": "raw functions", "frame": list(shape), "ms": times,
           "peak_bytes": peaks, "wb_from_region": wb_cmp,
           "percentile_renorm_max_abs_vs_float64": pct_err, "card": card}
    _print(res)
    return res


def run_raw(card: str, dev) -> dict:
    """The RAW half at 24 x 3904^2 (lossless-JPEG DNG, black 128)."""
    from astrophotography_tpu_torch import kernels

    from astrophotography_tpu_torch.io import losslessjpeg

    before = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    losslessjpeg._load()                  # builds with g++ at first use
    _require(losslessjpeg.native_loaded(),
             "raw: the native lossless-JPEG library is loaded")
    _print({"phase": "raw native codec", "library": losslessjpeg._so_path(),
            "build_or_load_s": time.perf_counter() - t0, "card": card})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_raw_")
    try:
        res = {"correctness": _raw_correctness(tmp, card, dev)}
        os.remove(os.path.join(tmp, "scene.dng"))
        res["pipeline"] = _raw_pipeline(tmp, card, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["functions"] = _raw_functions(card, dev)
    _require(dict(kernels.launch_counts) == before,
             "raw: the RAW half launches none of K1-K3")
    return res


class _IoSplit:
    """Times one engine call by where it spends it: ``read_image`` and
    ``write_image`` of the engine's module are wrapped (host seconds),
    and CUDA events bracket what lies between, from the first
    ``on_device`` upload to the first write (or the call's end): the
    uploads, the device work, the download and the host work among
    them."""

    def __init__(self, module):
        self.module = module
        self.read_s = self.write_s = 0.0
        self.first_upload = self.first_write = None

    def __enter__(self):
        mod = self.module
        self.saved = (mod.read_image, mod.write_image, mod.on_device)

        def read(*a, **k):
            t = time.perf_counter()
            out = self.saved[0](*a, **k)
            self.read_s += time.perf_counter() - t
            return out

        def write(*a, **k):
            if self.first_write is None:
                self.first_write = torch.cuda.Event(enable_timing=True)
                self.first_write.record()
            t = time.perf_counter()
            self.saved[1](*a, **k)
            self.write_s += time.perf_counter() - t

        def upload(*a, **k):
            if self.first_upload is None:
                self.first_upload = torch.cuda.Event(enable_timing=True)
                self.first_upload.record()
            return self.saved[2](*a, **k)

        mod.read_image, mod.write_image, mod.on_device = read, write, upload
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        mod = self.module
        mod.read_image, mod.write_image, mod.on_device = self.saved
        end = self.first_write
        if end is None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        torch.cuda.synchronize()
        self.total_s = time.perf_counter() - self.t0
        self.device_ms = (self.first_upload.elapsed_time(end)
                          if self.first_upload is not None else 0.0)
        self.peak = torch.cuda.max_memory_allocated()

    def report(self) -> dict:
        return {"seconds": self.total_s, "read_s": self.read_s,
                "device_ms": self.device_ms, "write_s": self.write_s,
                "peak_bytes": self.peak}


def run_files(card: str, dev) -> dict:
    """The calibration-file engines on uint16 FITS frames of 4008 x 2672
    in a temp directory: masters, read noise, the bad-pixel mask and
    column, eight calibrated lights (one cleaned of cosmic rays) and one
    repaired raw light, each held to what was planted."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.core import (badpix_engine, calibrator,
                                                 masters)
    from astrophotography_tpu_torch.io.fits import (Header, read_image,
                                                    write_image)

    before = dict(kernels.launch_counts)
    t0 = time.perf_counter()
    img, sky, xs, ys, _fl = make_starfield()
    h, w = img.shape
    rng = np.random.default_rng(7)
    read_noise, gain = 6.0, 1.5                 # ADU, e-/ADU: 9 e-
    bias_level, dark_rate, dark_exp, light_exp = 300.0, 0.5, 60.0, 120.0
    yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    vig = 1.0 - 0.08 * (xx * xx + yy * yy) / 2.0
    vig = (vig / vig.mean()).astype(np.float32)
    rate = np.full((h, w), dark_rate, np.float32)
    near_star = np.zeros((h, w), bool)
    for x, y in zip(xs, ys):
        near_star[int(y) - 12:int(y) + 13, int(x) - 12:int(x) + 13] = True
    hot = (rng.random((h, w)) < 1e-4) & ~near_star
    hot[:3] = hot[-3:] = False
    hot[:, :3] = hot[:, -3:] = False
    rate[hot] = rng.uniform(20.0, 60.0, int(hot.sum())).astype(np.float32)
    bad_col = (4 * w) // 9
    hot[:, bad_col] = False
    # the readout's fixed pattern: an offset of its own for every column
    # and row (0.5 ADU rms), in every frame.  Without it the column
    # medians of integer frames fall on a few levels, whole windows of
    # them are equal, and the bad-column test (>= sigma * std) fires on
    # a spread of zero
    pattern = (bias_level + rng.normal(0.0, 0.5, (1, w))
               + rng.normal(0.0, 0.5, (h, 1))).astype(np.float32)

    def noise():
        return rng.standard_normal((h, w), dtype=np.float32) * read_noise

    def u16(a):
        return np.clip(np.rint(a), 0, 65535).astype(np.uint16)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_files_")
    try:
        def put(folder, name, data, **keys):
            hdr = Header()
            for k, v in keys.items():
                hdr[k.replace("_", "-")] = v
            os.makedirs(os.path.join(tmp, folder), exist_ok=True)
            path = os.path.join(tmp, folder, name)
            write_image(path, data, hdr)      # uint16: BZERO 32768
            return path

        temps = {"SET_TEMP": -10.0, "CCD_TEMP": -10.1}
        dark_signal = rate * dark_exp
        dark_signal[:, bad_col] += 60.0
        for i in range(CAL_FRAMES):
            put("bias", f"bias{i}.fits", u16(pattern + noise()),
                IMAGETYP="BIAS", EXPTIME=0.0, GAIN=gain, **temps)
            off = i == CAL_FRAMES - 1             # one dark 2 C off
            put("dark", f"dark{i}.fits",
                u16(pattern + dark_signal * (3.0 if off else 1.0)
                    + noise()),
                IMAGETYP="DARK", EXPTIME=dark_exp, SET_TEMP=-10.0,
                CCD_TEMP=-8.0 if off else -10.1)
            put("flat", f"flat{i}.fits",
                u16(pattern + 20000.0 * vig + noise() * 12.0),
                IMAGETYP="FLAT", EXPTIME=2.0, **temps)
        lights = []
        light_signal = rate * light_exp
        light_signal[:, bad_col] += 120.0
        hits = (rng.random((h, w)) < 2e-4) & ~near_star & ~hot
        hits[:, bad_col - 3:bad_col + 4] = False
        for i in range(LIGHT_FRAMES):
            frame = img * vig + pattern + light_signal + noise()
            if i == 0:
                frame[hits] += rng.uniform(1500, 8000, int(hits.sum()))
            lights.append(put("light", f"light{i}.fits", u16(frame),
                              IMAGETYP="LIGHT", EXPTIME=light_exp,
                              GAIN=gain, **temps))
        gen_s = time.perf_counter() - t0
        res = {"phase": "files", "frame": [h, w],
               "frames_written": 3 * CAL_FRAMES + LIGHT_FRAMES,
               "make_frames_s": gen_s, "hot_pixels": int(hot.sum()),
               "cosmic_hits": int(hits.sum()), "engines": {}}
        eng = res["engines"]

        # masters
        paths = {}
        for kind in ("bias", "dark", "flat"):
            paths[kind] = os.path.join(tmp, f"master_{kind}.fits")
            with _IoSplit(masters) as sp:
                hdr = masters.make_master(os.path.join(tmp, kind),
                                          paths[kind], device=dev)
            eng[f"make_master {kind}"] = sp.report()
            want_n = CAL_FRAMES - 1 if kind == "dark" else CAL_FRAMES
            names = [hdr.get(f"IFILE{n:03d}") for n in range(want_n)]
            _require(hdr["NCOMBINE"] == want_n
                     and hdr["IMAGETYP"] == f"MASTER {kind.upper()}"
                     and names == [f"{kind}{n}.fits" for n in range(want_n)]
                     and f"IFILE{want_n:03d}" not in hdr,
                     f"files: master {kind} header ({hdr['NCOMBINE']})")
        mbias, _ = read_image(paths["bias"])
        mdark, _ = read_image(paths["dark"])
        _require(abs(float(np.median(mbias)) - bias_level) < 0.5
                 and abs(float(np.median(mdark))
                         - bias_level - dark_rate * dark_exp) < 0.5,
                 "files: master levels (the warm dark was left out)")

        # read noise from two bias frames
        with _IoSplit(masters) as sp:
            rn = masters.calc_read_noise(
                os.path.join(tmp, "bias", "bias0.fits"),
                os.path.join(tmp, "bias", "bias1.fits"), device=dev)
        eng["calc_read_noise"] = dict(sp.report(), **rn)
        _require(abs(rn["read_noise_e"] / (read_noise * gain) - 1.0) < 0.05
                 and rn["gain"] == gain,
                 f"files: read noise {rn['read_noise_e']} e- against "
                 f"{read_noise * gain}")

        # the bad-pixel mask and the bad column
        mask_path = os.path.join(tmp, "badpix.fits")
        with _IoSplit(badpix_engine) as sp:
            mhdr = badpix_engine.find_badpix(paths["dark"], mask_path,
                                             sigma=5.0, device=dev)
        eng["find_badpix"] = sp.report()
        mask, _ = read_image(mask_path, as_float32=False)
        _require(mask.dtype == np.uint8 and bool(mask[hot].all())
                 and bool(mask[:, bad_col].all()),
                 "files: every planted hot pixel and the column flagged")
        eng["find_badpix"]["flagged"] = int(mhdr["BPIXNAUT"])
        _require(mhdr["BPIXNAUT"] < 2 * (int(hot.sum()) + h),
                 "files: few pixels flagged beside the planted ones")
        with _IoSplit(badpix_engine) as sp:
            cols, rows = badpix_engine.auto_badcol_file(paths["dark"],
                                                        device=dev)
        eng["auto_badcol_file"] = dict(sp.report(), columns=cols.tolist(),
                                       rows=rows.tolist())
        # an 11-sample window's own spread is noisy: a few more columns
        # or rows of the 6,680 may pass 5 sigma by chance
        _require(bad_col in cols.tolist() and cols.size <= 8
                 and rows.size <= 8,
                 f"files: the bad column found ({cols.tolist()[:12]}, "
                 f"{rows.tolist()[:12]}; {cols.size} and {rows.size})")

        # the lights, the first with cosmic-ray cleaning
        cal = calibrator.Calibrator(
            master_bias=paths["bias"], master_dark=paths["dark"],
            master_flat=paths["flat"], master_badpix=mask_path, device=dev)
        inner = (slice(64, -64), slice(64, -64))
        sky_med = float(np.median(sky[inner]))
        per_light = []
        for i, light in enumerate(lights):
            out = os.path.join(tmp, f"cal{i}.fits")
            with _IoSplit(calibrator) as sp:
                hdr = cal.calibrate(light, out, fix_cosmic=(i == 0))
            per_light.append(sp.report())
            data, fhdr = read_image(out)
            for key in ("BIASCORR", "DARKCORR", "FLATCORR"):
                _require(fhdr[key] is True, f"files: {key}")
            _require(fhdr["BPIXFILE"] == "badpix.fits"
                     and fhdr["BUNIT"] == "adu"
                     and any("master_flat.fits" in t for t in fhdr.history),
                     "files: provenance of the calibrated light")
            med = float(np.median(data[inner]))
            _require(abs(med / sky_med - 1.0) < 0.01,
                     f"files: light {i} interior median {med} against the "
                     f"sky {sky_med}")
            resid = (data - sky)[~near_star & ~hot]
            sigma = 1.4826 * float(np.median(np.abs(
                resid - np.median(resid))))
            worst = float(np.abs(data[hot] - sky[hot]).max())
            _require(worst < 6.0 * sigma + 0.01 * SKY,
                     f"files: light {i} hot pixels repaired ({worst} "
                     f"against sigma {sigma})")
            per_light[-1].update(interior_median=med, sigma=sigma,
                                 worst_hot_residual=worst)
            if i == 0:
                _require(fhdr["CR_CLEAN"] is True and fhdr["CR_NPIX"] > 0,
                         "files: CR_CLEAN / CR_NPIX")
                cleaned = float((np.abs(data[hits] - sky[hits])
                                 < 6.0 * sigma).mean())
                _require(cleaned >= 0.9,
                         f"files: cosmic-ray hits cleaned ({cleaned})")
                per_light[-1].update(cr_npix=int(fhdr["CR_NPIX"]),
                                     hits_cleaned=cleaned)
        eng["calibrate fix_cosmic"] = per_light[0]
        rest = per_light[1:]
        eng["calibrate (mean of 7)"] = {
            k: float(np.mean([r[k] for r in rest]))
            for k in ("seconds", "read_s", "device_ms", "write_s")}
        eng["calibrate (mean of 7)"]["peak_bytes"] = max(
            r["peak_bytes"] for r in rest)

        # one more light under the profiler: how long the card is busy
        from astrophotography_tpu_torch.utils import device_trace
        trace_dir = os.path.join(tmp, "trace")
        with device_trace(trace_dir):
            torch.cuda.synchronize()
            t = time.perf_counter()
            cal.calibrate(lights[2], os.path.join(tmp, "cal_traced.fits"))
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t
        with open(os.path.join(trace_dir, "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
        busy = {"kernel": 0.0, "gpu_memcpy": 0.0, "gpu_memset": 0.0}
        n_kernels = 0
        for ev in events:
            if ev.get("cat") in busy and "dur" in ev:
                busy[ev["cat"]] += ev["dur"] / 1e3
                n_kernels += ev["cat"] == "kernel"
        _require(n_kernels > 0, "files: the trace holds the card's kernels")
        eng["calibrate under device_trace"] = {
            "seconds": traced_s, "kernel_ms": busy["kernel"],
            "memcpy_ms": busy["gpu_memcpy"] + busy["gpu_memset"],
            "kernel_events": n_kernels,
            "card_idle_share": 1.0 - sum(busy.values()) / 1e3 / traced_s}
        shutil.rmtree(trace_dir)

        # the frame loaders: a frame moved at its native width, and the
        # lights streamed in chunks through pinned buffers
        from astrophotography_tpu_torch.io import read_image_device
        from astrophotography_tpu_torch.parallel import stream_stacks
        torch.cuda.synchronize()
        t = time.perf_counter()
        host, _ = read_image(lights[0])
        host = torch.from_numpy(host).to(dev)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t
        t = time.perf_counter()
        frame, _ = read_image_device(lights[0], device=dev)
        torch.cuda.synchronize()
        native_s = time.perf_counter() - t
        _require(torch.equal(frame, host),
                 "files: read_image_device gives read_image's frame")
        t = time.perf_counter()
        chunks = list(stream_stacks(lights, chunk=3, depth=4, workers=4,
                                    device=dev))
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t
        _require([c[1].shape[0] for c in chunks] == [3, 3, 2]
                 and [n for c in chunks for n in c[0]] == lights,
                 "files: stream_stacks keeps order and chunk sizes")
        for names, stack, _headers in chunks:
            for k, name in enumerate(names):
                want = torch.from_numpy(read_image(name)[0]).to(dev)
                _require(torch.equal(stack[k], want),
                         f"files: streamed {os.path.basename(name)}")
        eng["loaders"] = {
            "read_image_then_upload_s": host_s,
            "read_image_device_s": native_s,
            "stream_stacks_8_frames_s": stream_s,
            "stream_frames_per_s": LIGHT_FRAMES / stream_s}
        del chunks, host, frame

        # one raw light repaired in place of its flagged pixels
        fixed = os.path.join(tmp, "fixed.fits")
        with _IoSplit(badpix_engine) as sp:
            fhdr = badpix_engine.fix_badpix_files(lights[1], mask_path,
                                                  fixed, deltapix=2,
                                                  device=dev)
        eng["fix_badpix_files"] = sp.report()
        data, _ = read_image(fixed)
        raw_light, _ = read_image(lights[1])
        _require(fhdr["BPIXCORR"] is True
                 and fhdr["BPIXNBAD"] == int((mask != 0).sum())
                 and fhdr["BPIXNFIX"] + fhdr["BPIXNREM"] == fhdr["BPIXNBAD"]
                 and fhdr["BPIXNREM"] == 0,
                 "files: repair counts")
        _require(bool((raw_light[hot] - data[hot] > 0.5 * light_exp
                       * 20.0).all())
                 and np.array_equal(data[mask == 0], raw_light[mask == 0]),
                 "files: flagged pixels repaired, the rest untouched")
        res["temp_bytes"] = sum(
            os.path.getsize(os.path.join(d, f))
            for d, _, fs in os.walk(tmp) for f in fs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _require(dict(kernels.launch_counts) == before,
             "files: the engines launch none of K1-K3")
    res["card"] = card
    _print(res)
    return res


#: the reduce phase: group V (4 lights of 60 s, then 12 of 120 s, the
#: first carrying the planted WCS) and group R (8 lights of 90 s with
#: 0.02-0.05 deg field rotations), one target, 4008 x 2672 uint16
REDUCE_GROUPS = (("V", 16, (60.0,) * 4 + (120.0,) * 12, 0.0),
                 ("R", 8, (90.0,) * 8, 0.05))
#: the planted TAN WCS: M42, 0.9 arcsec/px, CRPIX at the frame centre
REDUCE_CRVAL, REDUCE_SCALE = (83.8221, -5.3911), 0.9 / 3600.0
#: the bias level, dark current (ADU/s) and read noise (ADU) of the run
REDUCE_BIAS, REDUCE_DARK, REDUCE_RN = 300.0, 0.05, 6.0
#: the brightest star's flux per 60 s: the n-th brightest has n^(-2/3) of
#: it (Euclidean star counts, N(>F) ~ F^-1.5), down to 1/71 for the 600th.
#: make_starfield's uniform fluxes give no such ladder: the brightest
#: dozen of one light and of the next then differ by sub-pixel phase, and
#: registration fails on some lights (3 of 16 on an H100 80GB HBM3)
REDUCE_FLUX_MAX = 3.0e5


def _reduce_wcs():
    from astrophotography_tpu_torch.wcs import TanWCS

    h, w = MEASURE_SHAPE
    th = np.deg2rad(0.3)
    s = REDUCE_SCALE
    cd = np.array([[-s * np.cos(th), s * np.sin(th)],
                   [s * np.sin(th), s * np.cos(th)]])
    return TanWCS(REDUCE_CRVAL, ((w + 1) / 2.0, (h + 1) / 2.0), cd)


def make_observing_run(root: str, seed: int = 11) -> dict:
    """A synthetic night of one target in ``root``: ``data/`` holds the
    uint16 lights of REDUCE_GROUPS (the scene of ``make_starfield`` per
    60 s, the sky and the stars scaled by exposure, dithered by +-4 px
    and, in R, rotated about the centre; through a vignetting flat, with
    bias, dark current, 8 hot pixels in 10^4 and Gaussian noise), the
    first light of each group carrying the planted TAN WCS; ``cal/``
    holds master_bias, master_dark (60 s), master_flat_V, master_flat_R
    and master_badpix.  The stars sit where make_starfield puts them, with
    fluxes on the REDUCE_FLUX_MAX ladder in a random order.  Returns the
    truth: the reference star positions, their RA / Dec, each light's star
    positions, the sky per 60 s."""
    from astrophotography_tpu_torch.io.fits import Header, write_image

    rng = np.random.default_rng(seed)
    h, w = MEASURE_SHAPE
    _img, sky, xs, ys, _fl = make_starfield(seed)
    del _img
    fl = rng.permutation(REDUCE_FLUX_MAX
                         * np.arange(1.0, len(xs) + 1.0) ** (-2.0 / 3.0))
    wcs = _reduce_wcs()
    ra, dec = wcs.pix2world(xs + 1.0, ys + 1.0)
    yy = np.linspace(-1.0, 1.0, h, dtype=np.float32)[:, None]
    xx = np.linspace(-1.0, 1.0, w, dtype=np.float32)[None, :]
    pattern = (REDUCE_BIAS + rng.normal(0.0, 0.5, (1, w))
               + rng.normal(0.0, 0.5, (h, 1))).astype(np.float32)
    rate = np.full((h, w), REDUCE_DARK, np.float32)
    hot = rng.random((h, w)) < 8e-5
    rate[hot] = rng.uniform(2.0, 8.0, int(hot.sum())).astype(np.float32)
    data, cal = os.path.join(root, "data"), os.path.join(root, "cal")
    os.makedirs(data)
    os.makedirs(cal)

    def put(path, arr, **keys):
        hdr = Header()
        for k, v in keys.items():
            hdr[k.replace("_", "-")] = v
        write_image(path, arr, hdr)
        return hdr

    put(os.path.join(cal, "master_bias.fits"), pattern, IMAGETYP="MASTER BIAS")
    put(os.path.join(cal, "master_dark.fits"), pattern + rate * 60.0,
        IMAGETYP="MASTER DARK", EXPTIME=60.0)
    put(os.path.join(cal, "master_badpix.fits"), hot.astype(np.uint8),
        IMAGETYP="BADPIX")
    flats = {}
    for filt, amp in (("V", 0.08), ("R", 0.06)):
        flat = 1.0 - amp * (xx * xx + yy * yy) / 2.0
        flats[filt] = (flat / flat.mean()).astype(np.float32)
        put(os.path.join(cal, f"master_flat_{filt}.fits"), flats[filt],
            IMAGETYP="MASTER FLAT", FILTER=filt)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    truth = {"x": xs, "y": ys, "ra": ra, "dec": dec, "sky60": sky,
             "wcs": wcs, "frames": {}, "exptimes": {}}
    for filt, n, exps, rot in REDUCE_GROUPS:
        for i in range(n):
            dx, dy = (0.0, 0.0) if i == 0 else rng.uniform(-4.0, 4.0, 2)
            th = 0.0 if (i == 0 or not rot) else float(
                rng.choice([-1.0, 1.0]) * np.deg2rad(rng.uniform(0.02, rot)))
            c, s = np.cos(th), np.sin(th)
            px = c * (xs - cx) - s * (ys - cy) + cx + dx
            py = s * (xs - cx) + c * (ys - cy) + cy + dy
            k = exps[i] / 60.0
            scene = sky * k
            for x, y, f in zip(px, py, fl):
                x0, y0 = int(x) - 12, int(y) - 12
                scene[y0:y0 + 25, x0:x0 + 25] += _gaussian_star(
                    (25, 25), x - x0, y - y0, f * k, MEASURE_FWHM) \
                    .astype(np.float32)
            noise = rng.standard_normal((h, w), dtype=np.float32) \
                * np.sqrt(scene + REDUCE_RN ** 2)
            raw = scene * flats[filt] + pattern + rate * exps[i] + noise
            name = f"light{filt}{i:02d}"
            keys = dict(IMAGETYP="LIGHT", EXPTIME=exps[i], OBJECT="M42",
                        TELESCOP="T05", FILTER=filt,
                        DATE_OBS=f"2026-01-15T0{i // 10}:{i % 10}0:00")
            hdr = Header()
            for kk, v in keys.items():
                hdr[kk.replace("_", "-")] = v
            if i == 0:
                wcs.to_header(hdr)
            write_image(os.path.join(data, name + ".fits"),
                        np.clip(np.rint(raw), 0, 65535).astype(np.uint16),
                        hdr)
            truth["frames"][name] = (px, py)
            truth["exptimes"][name] = exps[i]
    return truth


class _Recorder:
    """Patches ``StageTimer`` in the given modules with a subclass whose
    instances are kept, so the stages a call timed can be read back."""

    def __init__(self, *modules):
        from astrophotography_tpu_torch.utils.timing import StageTimer

        self.modules = modules
        self.timers = []
        timers = self.timers

        class Recording(StageTimer):
            def __init__(self):
                super().__init__()
                timers.append(self)

        self.cls = Recording

    def __enter__(self):
        self.saved = [m.StageTimer for m in self.modules]
        for m in self.modules:
            m.StageTimer = self.cls
        return self

    def __exit__(self, *exc):
        for m, s in zip(self.modules, self.saved):
            m.StageTimer = s

    def split(self) -> dict:
        """Seconds per stage kind (the stage name's first word, 'combine'
        with its engine), summed, with the count of each."""
        out = {}
        for t in self.timers:
            for r in t.records:
                words = r["stage"].split(" ")
                key = " ".join(words[:2]) if words[0] == "combine" \
                    else words[0]
                sec, cnt = out.get(key, (0.0, 0))
                out[key] = (sec + r["seconds"], cnt + 1)
        return {k: {"seconds": s, "count": c} for k, (s, c) in out.items()}


def _stack_truth(label, path, truth, name0, dev, planted_sky,
                 origin=(0, 0)) -> dict:
    """A stack file against what was planted: finite, interior median
    within 5 % of the planted sky, >= 90 % of the planted stars (at their
    positions in the reference light ``name0``) found within 0.5 px.
    ``origin`` is the (row, column) of the stack's pixel 0 in the
    reference light's grid (a union canvas's CANVASY0 / CANVASX0)."""
    from astrophotography_tpu_torch.io.fits import read_image
    from astrophotography_tpu_torch.ops import find_stars, sigma_clipped_stats

    data, hdr = read_image(path)
    img = torch.from_numpy(data).to(dev)
    _require(bool(torch.isfinite(img).all()), f"{label}: stack not finite")
    m = 128
    h, w = planted_sky.shape
    oy, ox = origin
    inner = img[m - oy:h - m - oy, m - ox:w - m - ox]
    med = float(inner.median())
    want = float(np.median(planted_sky[m:-m, m:-m]))
    _require(abs(med / want - 1.0) < 0.05,
             f"{label}: interior median {med} against the planted {want}")
    _mean, bg, std = sigma_clipped_stats(inner[::4, ::4], sigma=3.0)
    # pixels no frame covers are 0 (a union canvas's margins): read them
    # as the background, or their edge fills the search's top-k
    stars = find_stars(torch.where(img == 0, bg, img) - bg,
                       fwhm=MEASURE_FWHM, threshold=7.0 * std, max_stars=1024)
    px, py = (torch.from_numpy(np.asarray(a - o, np.float32)).to(dev)
              for a, o in zip(truth["frames"][name0], (ox, oy)))
    d2 = (stars.x[None, :] - px[:, None]) ** 2 \
        + (stars.y[None, :] - py[:, None]) ** 2
    d2 = torch.where(stars.valid[None, :], d2, torch.inf)
    found = float((d2.amin(dim=1) < 0.25).float().mean())
    _require(found >= 0.9, f"{label}: {found:.3f} of the planted stars "
                           "found within 0.5 px")
    return {"interior_median": med, "planted_sky": want,
            "stars_found_within_0.5px": found,
            "detected": int(stars.valid.sum()), "header": hdr}


def _nav_truth(path, truth, name) -> float:
    """Largest distance (px) between a light's planted star positions and
    where its nav-*.fits WCS puts their planted RA / Dec."""
    from astrophotography_tpu_torch.io.fits import open_fits
    from astrophotography_tpu_torch.wcs import TanWCS

    wcs = TanWCS.from_header(open_fits(path)[0].header)
    x, y = wcs.world2pix(truth["ra"], truth["dec"])
    px, py = truth["frames"][name]
    return float(np.hypot(x - 1.0 - px, y - 1.0 - py).max())


def _group_stack(dev, cal_paths, exps, ref: int = 0):
    """A group's calibrated lights on the card in FSCALE units, and the
    matrices the unfused pipeline registers them with (reference
    ``ref``), as ``core.reduce.register_and_stack`` makes them."""
    from astrophotography_tpu_torch.core.reduce import load_stack
    from astrophotography_tpu_torch.models import PipelineConfig
    from astrophotography_tpu_torch.models.pipeline import register_frames
    from astrophotography_tpu_torch.utils import StageTimer

    stack, _hdrs = load_stack(cal_paths, dev, StageTimer(), "check")
    stack.mul_(torch.tensor([exps[0] / e for e in exps],
                            device=dev)[:, None, None])
    cfg = PipelineConfig(ref_frame=ref)
    _stars, _sims, mats, _ref = register_frames(stack, cfg)
    return stack, mats, cfg


def check_warp_exact(frames, mats, label, card, reps=3, masters=None,
                     er=None, **kw) -> dict:
    """K2 against warp_combine_plain, bit for bit (max |diff| 0, equal
    zero masks): a calibrated float32 stack, or raw frames with
    ``masters`` and exposure ratios ``er``; ``kw`` are the plan's
    arguments (average, sigma 5)."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.ops import warp_combine as wc

    args = dict(masters=masters, exp_ratios=er, **kw)
    k = wc.warp_combine(frames, mats, **args)
    torch.cuda.synchronize()
    p, plain_ms = _timed(lambda: wc.warp_combine_plain(frames, mats, **args))
    err = _k2_exact(k, p, label)
    covered = float((k != 0).float().mean())
    plan = wc.plan_warp_combine(frames.shape, mats, **kw)
    padded = [plan.n_ti * plan.th, plan.n_tj * plan.tw]
    del k, p
    torch.cuda.empty_cache()
    ms = _time_ms(_k2_kernel(frames, mats, masters, er, **kw), reps)
    res = {"phase": "K2 vs warp_combine_plain", "case": label,
           "shape": list(frames.shape), "max_abs_err": err,
           "route": kernels._warp_route(frames.shape[0], plan.span),
           "covered_fraction": covered, "tile": [plan.th, plan.tw],
           "padded_to": padded,
           "ms": ms, "plain_ms": plain_ms,
           "ns_per_frame_pixel": ms * 1e6 / frames.numel(),
           **_k2_bound(frames, masters, frames[0].numel()), "card": card}
    _print(res)
    return res


def k2_config_times(frames, mats, label, card, reps=3) -> dict:
    """K2's time on one stack under the file path's defaults (span 12,
    dither budget 64, apron) against the lean snap cell's (span 8,
    budget 8, no apron), and each of the three changed alone: where the
    file path's per-pixel cost goes.  Times only; coverage may differ
    between them."""
    configs = {
        "file path: span 12, budget 64, apron": (12, 64, True),
        "span 8": (8, 64, True),
        "budget 8": (12, 8, True),
        "no apron": (12, 64, False),
        "lean snap: span 8, budget 8, no apron": (8, 8, False)}
    times = {name: _time_ms(_k2_kernel(frames, mats, None, None, span=s,
                                       dither_budget=b, apron=a), reps)
             for name, (s, b, a) in configs.items()}
    res = {"phase": "K2 config split", "case": label,
           "shape": list(frames.shape), "ms": times, "card": card}
    _print(res)
    return res


def _busy_share(trace_dir: str, seconds: float) -> dict:
    """The card's busy time in a torch.profiler trace against a wall
    time: kernels, copies and sets."""
    with open(os.path.join(trace_dir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    busy = {"kernel": 0.0, "gpu_memcpy": 0.0, "gpu_memset": 0.0}
    n_kernels = 0
    for ev in events:
        if ev.get("cat") in busy and "dur" in ev:
            busy[ev["cat"]] += ev["dur"] / 1e3
            n_kernels += ev["cat"] == "kernel"
    _require(n_kernels > 0, "the trace holds the card's kernels")
    return {"seconds": seconds, "kernel_ms": busy["kernel"],
            "memcpy_ms": busy["gpu_memcpy"] + busy["gpu_memset"],
            "kernel_events": n_kernels,
            "card_busy_share": sum(busy.values()) / 1e3 / seconds}


def run_reduce(card: str, dev) -> dict:
    """The file-to-file reduction on a synthetic night of 4008 x 2672
    uint16 lights (``make_observing_run``): ``ap_reduce`` with the
    navigate stage and K2 (then again, which must rewrite nothing),
    ``ap_stack`` with every engine and the union canvas on group V's
    calibrated lights, each held to what was planted; K2 (both groups:
    the snap and the 'exact' tap bodies) and K3 against their twins at
    this shape; the entry point's twin.  Prints the file-to-file figure
    with its per-stage split."""
    from astrophotography_tpu_torch import graft_entry, kernels
    from astrophotography_tpu_torch.cli import ap_reduce, ap_stack
    from astrophotography_tpu_torch.core import reduce as reduce_mod
    from astrophotography_tpu_torch.io.fits import read_image
    from astrophotography_tpu_torch.models import PipelineConfig
    from astrophotography_tpu_torch.models import pipeline as pl
    from astrophotography_tpu_torch.utils import device_trace

    tmp = tempfile.mkdtemp(prefix="chip_smoke_reduce_")
    res = {"phase": "reduce", "frame": list(MEASURE_SHAPE)}
    checks = {}
    try:
        t0 = time.perf_counter()
        truth = make_observing_run(tmp)
        res["make_run_s"] = time.perf_counter() - t0
        data, cal = os.path.join(tmp, "data"), os.path.join(tmp, "cal")
        out = os.path.join(tmp, "out")
        n_lights = sum(g[1] for g in REDUCE_GROUPS)
        argv = [data, cal, out, "--astrometry", "--stack_engine", "fused",
                "--ref_frame", "0", "--device", dev.type, "-l", "WARNING"]

        # drive 1: ap_reduce
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with _Recorder(reduce_mod) as rec:
            t0 = time.perf_counter()
            rc = ap_reduce.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        _require(rc == 0, f"ap_reduce exited {rc}")
        check_launches("reduce", launches, {"warp_combine": 2,
                                            "find_exact": None})
        res["ap_reduce"] = {
            "wall_s": wall, "lights": n_lights,
            "lights_per_s": n_lights / wall,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": launches, "split": rec.split()}
        names = sorted(os.listdir(out))
        stacks = {}
        nav_err = 0.0
        for filt, n, exps, _rot in REDUCE_GROUPS:
            group = [f"light{filt}{i:02d}" for i in range(n)]
            for g in group:
                for pre, ext in (("cal-", ".fits"), ("qual_", ".yml"),
                                 ("src-", ".fits"), ("nav-", ".fits")):
                    _require(pre + g + ext in names, f"reduce: {pre}{g}{ext}")
                nav_err = max(nav_err, _nav_truth(
                    os.path.join(out, f"nav-{g}.fits"), truth, g))
            stack = f"stack-M42-T05-{filt}.fits"
            _require(stack in names and "weight-" + stack[6:] in names,
                     f"reduce: {stack} and its weight map")
            sky = truth["sky60"] * (exps[0] / 60.0)
            st = _stack_truth(f"reduce {filt}", os.path.join(out, stack),
                              truth, group[0], dev, sky)
            hdr = st.pop("header")
            _require(hdr["NSTACK"] == n and hdr["EXPTOTAL"] == sum(exps),
                     f"reduce: NSTACK / EXPTOTAL of {stack}")
            # every light registered: the weight map's interior is the sum
            # of 1/fscale^2 over all of them (a frame with < 4 inliers
            # weighs 0)
            wmap = read_image(os.path.join(out, "weight-" + stack[6:]))[0]
            full = sum((e / exps[0]) ** 2 for e in exps)
            st["weight_interior"] = float(np.median(wmap[128:-128, 128:-128]))
            _require(st["weight_interior"] == full,
                     f"reduce: {filt} weight {st['weight_interior']} against "
                     f"{full}: a light did not register")
            stacks[filt] = st
        _require(nav_err < 0.5, f"reduce: nav WCS off by {nav_err} px")
        # the V stack lives on its anchor's grid and carries its WCS
        from astrophotography_tpu_torch.io.fits import open_fits
        from astrophotography_tpu_torch.wcs import TanWCS
        sw, aw = (TanWCS.from_header(open_fits(os.path.join(d, f))[0].header)
                  for d, f in ((out, "stack-M42-T05-V.fits"),
                               (data, "lightV00.fits")))
        _require(sw.crval == aw.crval and sw.crpix == aw.crpix
                 and np.array_equal(sw.cd, aw.cd),
                 "reduce: the V stack inherits the anchor's WCS")
        res["ap_reduce"].update(stacks=stacks, nav_max_err_px=nav_err)

        # the same command again: noclean rewrites nothing
        mtimes = {f: os.path.getmtime(os.path.join(out, f)) for f in names}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        _require(ap_reduce.main(argv) == 0, "ap_reduce rerun")
        res["ap_reduce"]["rerun_s"] = time.perf_counter() - t0
        _require(dict(kernels.launch_counts) == {k: 0 for k in launches},
                 "reduce rerun launched a kernel")
        _require({f: os.path.getmtime(os.path.join(out, f))
                  for f in os.listdir(out)} == mtimes,
                 "reduce rerun rewrote an output")

        # drive 2: ap_stack on group V's calibrated lights
        v_n, v_exps = REDUCE_GROUPS[0][1], REDUCE_GROUPS[0][2]
        v_cal = [os.path.join(out, f"cal-lightV{i:02d}.fits")
                 for i in range(v_n)]
        sky_v = truth["sky60"] * (v_exps[0] / 60.0)
        res["ap_stack"] = {}
        outs = {}
        for key, extra, want in (
                ("xla", ["--engine", "xla"],
                 {"clip_combine": 1, "warp_separable": None,
                  "find_exact": None}),
                ("pallas", ["--engine", "pallas"],
                 {"clip_combine": 1, "warp_separable": None,
                  "find_exact": None}),
                ("fused", ["--engine", "fused"],
                 {"warp_combine": 1, "find_exact": None}),
                ("union", ["--canvas", "union"],
                 {"clip_combine": 1, "warp_separable": None,
                  "find_exact": None})):
            path = os.path.join(tmp, f"ap_stack_{key}.fits")
            kernels.reset_launch_counts()
            with _Recorder(ap_stack) as rec:
                t0 = time.perf_counter()
                rc = ap_stack.main(v_cal + ["-o", path, "--ref_frame", "0",
                                            "--device", dev.type,
                                            "-l", "WARNING"] + extra)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t0
            _require(rc == 0, f"ap_stack {key} exited {rc}")
            launched = dict(kernels.launch_counts)
            check_launches(f"ap_stack {key}", launched, want)
            entry = {"wall_s": sec, "launches": launched,
                     "split": rec.split()}
            origin = (0, 0)
            if key == "union":
                u, uhdr = read_image(path)
                origin = (uhdr["CANVASY0"], uhdr["CANVASX0"])
                _require(u.shape[0] >= MEASURE_SHAPE[0] - origin[0]
                         and u.shape[1] >= MEASURE_SHAPE[1] - origin[1],
                         "ap_stack union: the canvas holds the grid")
                entry.update(canvas=list(u.shape), origin=list(origin))
                del u
            st = _stack_truth(f"ap_stack {key}", path, truth, "lightV00",
                              dev, sky_v, origin)
            hdr = st.pop("header")
            _require(hdr["NSTACK"] == v_n
                     and hdr["EXPTOTAL"] == sum(v_exps),
                     f"ap_stack {key}: NSTACK / EXPTOTAL")
            entry.update(st)
            outs[key] = path
            res["ap_stack"][key] = entry
        a = read_image(outs["xla"])[0]
        b = read_image(outs["pallas"])[0]
        diff = np.abs(a - b)
        tie = {"median_abs_diff": float(np.median(diff)),
               "frac_beyond_1adu": float((diff > 1.0).mean()),
               "max_abs_diff": float(diff.max())}
        # one path: 'xla' and 'pallas' share combine_band
        _require(np.array_equal(a, b), f"ap_stack xla against pallas: {tie}")
        res["ap_stack"]["xla_vs_pallas"] = tie
        del a, b, diff
        # one fused ap_stack under the profiler: how busy the card is
        trace_dir = os.path.join(tmp, "trace")
        with device_trace(trace_dir):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _require(ap_stack.main(v_cal + [
                "-o", os.path.join(tmp, "traced.fits"), "--ref_frame", "0",
                "--engine", "fused", "--device", dev.type,
                "-l", "WARNING"]) == 0, "traced ap_stack")
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        res["ap_stack fused under device_trace"] = _busy_share(trace_dir,
                                                               traced_s)

        # the kernels against their twins at this shape
        for filt, n, exps, _rot in REDUCE_GROUPS:
            paths = [os.path.join(out, f"cal-light{filt}{i:02d}.fits")
                     for i in range(n)]
            stack, mats, cfg = _group_stack(dev, paths, exps)
            body = "exact" if _rot else "snap"
            checks[f"K2 {filt}"] = check_warp_exact(
                stack, mats, f"reduce {filt} {n}x{MEASURE_SHAPE[0]}x"
                f"{MEASURE_SHAPE[1]} f32 {body}", card, apron=True,
                general_taps="exact")
            if filt == "V":
                res["K2 config split"] = k2_config_times(
                    stack, mats, f"reduce V {n}x{MEASURE_SHAPE[0]}x"
                    f"{MEASURE_SHAPE[1]} f32 snap", card)["ms"]
                warped, weights = pl.warp_band(stack, mats,
                                               MEASURE_SHAPE[0], cfg)
                mask = weights > 0.5
                del weights
                checks["K3 V"] = check_clip(
                    warped, mask, f"reduce V warped band {n}x"
                    f"{MEASURE_SHAPE[0]}x{MEASURE_SHAPE[1]}", card, reps=3)
                del warped, mask
            del stack
            torch.cuda.empty_cache()

        # the entry point's twin
        fn, args = graft_entry.entry(device=dev)
        ent = fn(*args)
        torch.cuda.synchronize()
        _require(tuple(ent.shape) == (128, 128)
                 and bool(torch.isfinite(ent).all()), "graft_entry forward")
        res["graft_entry"] = {"shape": list(ent.shape),
                              "mean": float(ent.mean())}
        res["temp_bytes"] = _dir_bytes(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["card"] = card
    _print(res)
    return {"main": res, **checks}


def _kernel_entry(name, replaces, main, by_path, check, route=None) -> dict:
    """One kernel's entry of the ``kernels`` line: ``launches`` is the
    count on its main path (``main``, a key of ``by_path``), each path's
    own counted from 0 in that path's run (the multichip phase's per
    step, one count a rank); error and times of its check at the main
    path's shape, the bound from that check's inputs.  A ``route`` of
    the kernel with an entry of its own (K2's 'wide') is named after the
    kernel and counts only its own launches.  No single PyTorch call
    computes any of the three kernels' functions, so ``library_ms`` is
    null."""
    return {"name": name if route is None else f"{name} ({route} route)",
            "route": "cuda",
            "source": f"astrophotography_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": by_path[main],
            "launches_by_path": by_path,
            "max_abs_err": check["max_abs_err"], "ms": check["ms"],
            "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
            "bound_by": check["bound_by"], "library_ms": None}


def _mc_launches(multichip: dict, name: str) -> dict:
    """A kernel's launches in the multichip steps that ran it, one count
    a rank."""
    return {step: counts[name]
            for step, counts in multichip["launches"].items()
            if any(counts.get(name, [0]))}


def _unfused_split(fr, kw, cfg) -> dict:
    """Device time (ms, CUDA events) of each stage of one unfused run,
    stage by stage as ``calibrate_register_stack`` runs them."""
    from astrophotography_tpu_torch.models import pipeline as pl
    from astrophotography_tpu_torch.ops.calibrate import calibrate_batch
    from astrophotography_tpu_torch.ops.clip_combine import clip_combine

    names, events = [], []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        names.append(name)
        events.append(ev)

    n, h, _w = fr.shape
    torch.cuda.synchronize()
    mark("start")
    cal = calibrate_batch(fr, kw["bias"], kw["dark"], kw["flat"],
                          kw["exp_ratios"],
                          dark_still_biased=cfg.dark_still_biased)
    mark("calibrate")
    stars = pl.detect_calibrated(cal, cfg)
    mark("detect")
    _sims, mats, _ref = pl._solve_frame_similarities(stars, n, cfg)
    mark("register")
    band_h = h // cfg.n_bands
    for b in range(cfg.n_bands):
        warped, weights = pl.warp_band(
            cal, pl.band_matrices(mats, float(b * band_h)), band_h, cfg)
        mark("warp")
        mask = weights > 0.5
        mark("glue")
        out = clip_combine(warped, mask=mask, sigma_lower=cfg.sigma_lower,
                           sigma_upper=cfg.sigma_upper)
        mark("K3")
        torch.where(torch.isnan(out), 0.0, out)
        mark("glue")
        del warped, weights, mask
    torch.cuda.synchronize()
    split = {}
    for name, a, b in zip(names[1:], events, events[1:]):
        split[name] = split.get(name, 0.0) + a.elapsed_time(b)
    split["total"] = events[0].elapsed_time(events[-1])
    return split


def run_unfused_path(card: str, dev, phases) -> dict:
    """K3 against its twin at the unfused path's band shape, then the
    unfused path (``calibrate_register_stack``) at 24x4096^2, as far as
    ``phases`` asks; the warm-up's separable warps (one a band) and its
    exact detection (one call) are replayed on their twins bit for
    bit."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.models import calibrate_register_stack

    label = "unfused path snap"
    cfg = unfused_config()
    n = UNFUSED_FRAMES
    checks = {}
    if "k3" in phases:
        band = (n, SIZE // cfg.n_bands, SIZE)
        stack, mask = _clip_inputs(*band, dev, seed=1)
        checks["clip_combine"] = check_clip(stack, mask,
                                            f"{label} band {band}", card)
        del stack, mask
        torch.cuda.empty_cache()
    if "unfused" not in phases:
        return checks

    t0 = time.perf_counter()
    frames, bias, dark, flat, exp_ratio, max_off, mats = make_workload(
        n, SIZE, rotate=False)
    gen_s = time.perf_counter() - t0
    fr = torch.from_numpy(frames).to(dev)
    del frames
    kw = dict(bias=torch.from_numpy(bias).to(dev),
              dark=torch.from_numpy(dark).to(dev),
              flat=torch.from_numpy(flat).to(dev),
              exp_ratios=torch.full((n,), exp_ratio, dtype=torch.float32,
                                    device=dev))

    def run():
        return calibrate_register_stack(fr, config=cfg, **kw)

    kernels.reset_launch_counts()
    with _FirstCall(*_PIPELINE_CALLS["warp_separable"],
                    keep=cfg.n_bands) as ws, \
            _FirstCall(*_PIPELINE_CALLS["find_exact"]) as fs, \
            _FirstCall(*_PIPELINE_CALLS["calibrate"]) as cs:
        run()                    # warm-up, its kernels' calls kept
    torch.cuda.synchronize()
    sep_routes = dict(kernels.warp_separable_route_counts)
    _require(len(ws.calls) == cfg.n_bands, f"{label}: warp_separable calls")
    _require(sep_routes == {"smem": cfg.n_bands, "scratch": 0},
             f"{label}: warp_separable routes {sep_routes}")
    _require(kernels.launch_counts["find_exact"] == 1,
             f"{label}: find_exact launches")
    sep_checks = [_plain_check("warp_separable", c, f"{label} band {i}")
                  for i, c in enumerate(ws.calls)]
    find_check = _plain_check("find_exact", fs.call, label)
    _require(kernels.launch_counts["calibrate"] == 1,
             f"{label}: calibrate launches")
    cal_check = _plain_check("calibrate", cs.call, label)
    del ws, fs, cs
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stacked, diag = run()
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check_launches(label, launches, {"clip_combine": cfg.n_bands,
                                     "warp_separable": cfg.n_bands,
                                     "calibrate": 1, "find_exact": 1})
    _require("jax" not in sys.modules, "jax was imported")
    k = 3
    t0 = time.perf_counter()
    for _ in range(k):
        out, _d = run()
    torch.cuda.synchronize()
    sustained_s = (time.perf_counter() - t0) / k
    min_in, max_rms, t_err = _check_registration(label, diag, mats,
                                                 UNFUSED_T_ERR_PX)
    med = check_stack(label, stacked)
    del out, stacked
    split = _unfused_split(fr, kw, cfg)

    # once more with a bad-pixel mask: the workload's planted hot pixels,
    # repaired in every calibrated frame (deltapix 2) before detection
    hot = torch.from_numpy(dark - bias > 1000.0).to(dev)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stacked, bdiag = calibrate_register_stack(fr, badpix_mask=hot, config=cfg,
                                              **kw)
    torch.cuda.synchronize()
    badpix_ms = (time.perf_counter() - t0) * 1e3
    blaunches = dict(kernels.launch_counts)
    check_launches(label + " badpix", blaunches,
                   {"clip_combine": cfg.n_bands,
                    "warp_separable": cfg.n_bands, "calibrate": 1,
                    "find_exact": 1})
    b_in, b_rms, b_terr = _check_registration(label + " badpix", bdiag, mats,
                                              UNFUSED_T_ERR_PX)
    b_med = check_stack(label + " badpix", stacked)
    badpix = {"single_run_ms": badpix_ms, "hot_pixels": int(hot.sum()),
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches": blaunches, "min_inliers": b_in, "max_rms_px": b_rms,
              "max_translation_err_px": b_terr, "interior_median": b_med}
    del stacked, hot
    res = {"phase": label, "shape": [n, SIZE, SIZE],
           "config": {"max_stars": cfg.max_stars, "match_k": cfg.match_k,
                      "interp": cfg.interp, "n_bands": cfg.n_bands,
                      "detect_mode": cfg.detect_mode,
                      "combine_impl": cfg.combine_impl},
           "single_run_ms": single_ms,
           "sustained_gpix_s": n * SIZE * SIZE / sustained_s / 1e9,
           "sustained_ms": sustained_s * 1e3,
           "max_memory_allocated_bytes": peak, "launches": launches,
           "warp_separable_routes": sep_routes,
           "warp_separable_plain_checks": sep_checks,
           "warp_separable_max_abs_err": max(c["max_abs_err"]
                                             for c in sep_checks),
           "find_exact_plain_check": find_check,
           "calibrate_plain_check": cal_check,
           "device_ms_split": split, "with_badpix_mask": badpix,
           "min_inliers": min_in, "max_rms_px": max_rms,
           "max_translation_err_px": t_err, "interior_median": med,
           "sky": SKY, "max_offset_px": max_off, "workload_gen_s": gen_s,
           "card": card}
    _print(res)
    del fr, kw
    torch.cuda.empty_cache()
    return {"main": res, **checks}


def _lean_chunked_split(fr, kw, cfg) -> dict:
    """Host-clock and device time (ms) of each stage of one lean run with
    chunked detection, stage by stage as ``calibrate_register_stack_lean``
    runs them, with a synchronise after every stage: ``host`` is the
    stage's wall time (launch overhead and the host's waits on device
    values included), ``device`` the time between its CUDA events,
    ``cuda_mallocs`` the memory segments PyTorch's caching allocator had
    to get from ``cudaMalloc`` during the stage (each such call stalls
    the host and the card)."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.models import pipeline as pl
    from astrophotography_tpu_torch.ops import warp_combine as wc
    from astrophotography_tpu_torch.ops.calibrate import calibrate_batch

    host, device, mallocs = {}, {}, {}

    def segments():
        return torch.cuda.memory_stats()["segment.all.allocated"]

    def stage(name, fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        s0, t0 = segments(), time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        host[name] = host.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        device[name] = device.get(name, 0.0) + start.elapsed_time(end)
        mallocs[name] = mallocs.get(name, 0) + segments() - s0
        return out

    n, h, w = fr.shape
    c = cfg.detect_chunk
    parts = []
    for k in range(0, n, c):
        calc = stage("calibrate", lambda: calibrate_batch(
            fr[k:k + c], kw["bias"], kw["dark"], kw["flat"],
            kw["exp_ratios"][k:k + c],
            dark_still_biased=cfg.dark_still_biased))
        ce, s = stage("noise_stats", lambda: pl.frame_noise_stats(
            calc, center=cfg.noise_center))
        parts.append(stage("find_stars",
                           lambda: pl._find_stars(calc, ce, s, cfg)))
    stars = pl._concat_stars(parts)
    _sims, mats, _ref = stage(
        "register", lambda: pl._solve_frame_similarities(stars, n, cfg))
    planes = stage("masters", lambda: pl._calibration_planes(
        kw["bias"], kw["dark"], kw["flat"], cfg.dark_still_biased, h, w,
        fr.device))
    masters = stage("masters", lambda: torch.stack(planes[:3]))
    plan = stage("K2 plan", lambda: wc.plan_warp_combine(
        fr.shape, mats, kw["exp_ratios"], None, tile=cfg.fused_tile,
        span=cfg.warp_span, apron=cfg.fused_apron or h < 96 or w < 768,
        dither_budget=cfg.dither_budget, general_taps=cfg.general_taps))
    stage("K2", lambda: kernels.warp_combine_cuda(
        fr, masters, plan, combine=wc._COMBINES.index(cfg.combine),
        lowrank=cfg.general_taps == "lowrank", sigma_lower=cfg.sigma_lower,
        sigma_upper=cfg.sigma_upper))
    return {"host_ms": host, "device_ms": device, "cuda_mallocs": mallocs,
            "host_total_ms": sum(host.values()),
            "device_total_ms": sum(device.values())}


#: the bench phase's runs of ``bench_torch.py``: a label, the environment
#: it adds, and the lines it must print in order, each as a fragment of
#: its metric and the launches of one run (None: the line has none)
_LEAN_LAUNCHES = {"detect_tiles": 1, "warp_combine": 1, "clip_combine": 0}
BENCH_RUNS = (
    ("default", {}, (("lean, sub-px dithers", _LEAN_LAUNCHES),
                     ("RAW->grey", None),
                     ("lean, rotated", _LEAN_LAUNCHES))),
    ("pallas", {"BENCH_FRAMES": "24", "BENCH_SIZE": "4096",
                "BENCH_IMPL": "pallas", "BENCH_SKIP_RAWGREY": "1",
                "BENCH_SKIP_ROTATION": "1"},
     (("24x4096^2 pallas, sub-px dithers",
       {"detect_tiles": 0, "warp_combine": 0, "clip_combine": 2,
        "warp_separable": 2, "calibrate": 1, "find_exact": 1}),)),
)
#: what each bench line is held beside: the smoke phase that ran the
#: same configuration in this call
_BENCH_VS_SMOKE = {("default", 0): "snap", ("default", 2): "rotated",
                   ("pallas", 0): "unfused"}


def bench_lines(label: str, stdout: str, want, device: dict,
                smoke: dict) -> tuple:
    """The JSON lines of one run of ``bench_torch.py`` (``label``, the
    lines ``want``, as in :data:`BENCH_RUNS`), each checked: in bench.py's
    order, a finite positive value, ``vs_baseline`` null, ``device`` this
    card's (name, count, a power limit), and on a stacking line the
    launches its path must make.  ``smoke`` holds the main paths' lines
    of this call ({"snap", "rotated", "unfused"}, as far as they ran).
    Returns (lines, each stacking line's single run and best sustained
    run as ratios to the smoke's figure for the same configuration)."""
    lines = [json.loads(t) for t in stdout.splitlines() if t.startswith("{")]
    _require(len(lines) == len(want),
             f"bench {label}: {len(lines)} lines, expected {len(want)}")
    vs_smoke = {}
    for i, (line, (fragment, launches)) in enumerate(zip(lines, want)):
        what = f"bench {label} line {i + 1}"
        _require(fragment in line["metric"],
                 f"{what}: '{line['metric']}' where '{fragment}' comes")
        v = line["value"]
        _require(isinstance(v, float) and math.isfinite(v) and v > 0,
                 f"{what}: value {v}")
        _require(line["vs_baseline"] is None, f"{what}: vs_baseline")
        got = line["device"]
        _require(got["name"] == device["name"]
                 and got["count"] == device["count"]
                 and (got["power_limit_w"] or 0) > 0,
                 f"{what}: device {got}")
        if launches is None:
            continue
        check_launches(what, line["launches"], launches)
        ref = smoke.get(_BENCH_VS_SMOKE[(label, i)])
        if ref:
            vs_smoke[str(i + 1)] = {
                "single_run": line["single_run_ms"] / ref["single_run_ms"],
                "sustained": line["runs_ms"]["min"] / ref["sustained_ms"]}
    return lines, vs_smoke


def run_bench(card: str, smoke: dict) -> dict:
    """``bench_torch.py`` as a subprocess, once as it runs by default and
    once at the unfused ``pallas`` rung (:data:`BENCH_RUNS`): it must exit
    0 and print lines that pass :func:`bench_lines`."""
    device = {"name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    root = os.path.dirname(os.path.abspath(__file__))
    # each run sees only its own BENCH_* settings
    base = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    torch.cuda.empty_cache()
    out = {}
    for label, env, want in BENCH_RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(root, "bench_torch.py")], cwd=root,
            env={**base, **env}, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t0
        _require(proc.returncode == 0, f"bench {label}: exit code "
                                       f"{proc.returncode}: {proc.stderr[-3000:]}")
        lines, vs_smoke = bench_lines(label, proc.stdout, want, device, smoke)
        out[label] = {"env": env, "seconds": seconds, "lines": lines,
                      "vs_smoke": vs_smoke}
    _print({"phase": "bench", "runs": out, "card": card})
    return out


def run_lean_chunked(card: str, dev) -> dict:
    """The lean path with detect_impl='chunked' (calibrate + noise stats
    + find_stars chunk by chunk, then K2) at 16x1024^2: one timed run
    after a warm-up, four more to show how far runs spread, then the
    stage split, twice."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.models import (
        calibrate_register_stack_lean)

    label = "lean path chunked detection"
    n, size = 16, 1024
    cfg = dataclasses.replace(lean_config(False), detect_impl="chunked")
    frames, bias, dark, flat, exp_ratio, _off, mats = make_workload(n, size)
    fr = torch.from_numpy(frames).to(dev)
    kw = dict(bias=torch.from_numpy(bias).to(dev),
              dark=torch.from_numpy(dark).to(dev),
              flat=torch.from_numpy(flat).to(dev),
              exp_ratios=torch.full((n,), exp_ratio, dtype=torch.float32,
                                    device=dev))
    calibrate_register_stack_lean(fr, config=cfg, **kw)      # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    stacked, diag = calibrate_register_stack_lean(fr, config=cfg, **kw)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launch_counts)
    check_launches(label, launches, {"warp_combine": 1, "calibrate": None})
    # find_stars' 5x5 centre-of-mass centroids, as on the unfused path
    min_in, max_rms, t_err = _check_registration(label, diag, mats,
                                                 UNFUSED_T_ERR_PX)
    med = check_stack(label, stacked)
    later_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        calibrate_register_stack_lean(fr, config=cfg, **kw)
        torch.cuda.synchronize()
        later_ms.append((time.perf_counter() - t0) * 1e3)
    res = {"phase": label, "shape": [n, size, size],
           "single_run_ms": single_ms, "later_runs_ms": later_ms,
           "splits": [_lean_chunked_split(fr, kw, cfg) for _ in range(2)],
           "launches": launches,
           "min_inliers": min_in, "max_rms_px": max_rms,
           "max_translation_err_px": t_err, "interior_median": med,
           "card": card}
    _print(res)
    return res


def run_small_matrix(card: str, dev) -> None:
    """The smaller matrix of kernel cases: K1 at 8x1024^2 with masters;
    K2 at 16x1024^2 with masters for every combine, on snapped
    translations and on rotations under 'exact' and 'lowrank'; K3 at
    N x 1024^2 with and without a mask for N in 1, 2, 7, 24, 100 and
    either side of its route boundaries (registers up to 8, 16, 24 and 32
    frames, shared memory above), and at N x 256 x 1024 with a mask on
    either side of its block shapes' limits (128 threads to 227 frames,
    64 to 454, 32 to 908)."""
    from astrophotography_tpu_torch.ops import detect_tiles as dt

    frames, bias, dark, flat, exp_ratio, _off, mats = make_workload(
        16, 1024, rotate=False)
    fr = torch.from_numpy(frames).to(dev)
    er = torch.full((16,), exp_ratio, dtype=torch.float32, device=dev)
    masters, b_t, du_t, f_t = _masters(bias, dark, flat, dev)
    mf = dt.master_densities(b_t, du_t, f_t)
    check_detect(fr[:8], torch.full((8,), 56.0, device=dev), mf, masters[0],
                 er[:8], "8x1024^2", card)
    _fr, _b, _d, _f, _e, _o, rmats = make_workload(16, 1024, rotate=True)
    rfr = torch.from_numpy(_fr).to(dev)
    for combine in ("average", "median", "sum", "mean"):
        check_warp(fr, torch.from_numpy(mats.astype(np.float32)).to(dev),
                   masters, er, f"16x1024^2 snap {combine}", card,
                   combine=combine, span=8, dither_budget=8)
        for taps in ("exact", "lowrank"):
            check_warp(rfr, torch.from_numpy(rmats.astype(np.float32))
                       .to(dev), masters, er,
                       f"16x1024^2 rotated {taps} {combine}", card,
                       combine=combine, general_taps=taps, dither_budget=32)
    del fr, rfr, masters, mf
    torch.cuda.empty_cache()
    for n in (1, 2, 7, 8, 9, 16, 17, 24, 25, 32, 33, 100):
        for masked in (False, True):
            stack, mask = _clip_inputs(n, 1024, 1024, dev, seed=n,
                                       masked=masked)
            check_clip(stack, mask, f"{n}x1024^2", card, reps=3)
    for n in (227, 228, 454, 455, 908):
        stack, mask = _clip_inputs(n, 256, 1024, dev, seed=n)
        check_clip(stack, mask, f"{n}x256x1024", card, reps=3)
        del stack, mask
        torch.cuda.empty_cache()


#: the deep phase: the lean path past the shared-memory routes' 908
#: frames (1200 uint16 frames of 2048^2, 10.1 GB raw), the unfused path
#: (K3) and K2's twin at 1200 x 512^2, K3 at 1200 x 1024 x 2048 (its twin
#: on the first DEEP_K3_TWIN_ROWS rows), K1 at radii 17, 24 and 48 (FWHM
#: 22.7, 32 and 64 px) on 16 x 4096^2
DEEP_FRAMES, DEEP_SIZE, DEEP_SMALL = 1200, 2048, 512
#: K2's lowrank body against its twin on 'cols' (the twin's time follows
#: the frames, not the pixels)
DEEP_LOWRANK_FRAMES = 909
DEEP_K3_SHAPE, DEEP_K3_TWIN_ROWS = (1200, 1024, 2048), 64
#: K3's 'select' route on a planetary lucky-imaging run: 30000 frames of a
#: 640 x 480 region of interest (~4 minutes at ~130 fps), f32 with a
#: mask (46.1 GB); its twin replays the first rows
DEEP_SELECT_SHAPE, DEEP_SELECT_TWIN_ROWS = (30000, 480, 640), 16
DEEP_K1_FRAMES, DEEP_K1_SIZE, DEEP_K1_FWHM = 16, 4096, (22.7, 32.0, 64.0)


def workload_geometry(n_frames: int, size: int, rotate=False, seed: int = 0):
    """The host half of :func:`make_workload_on_device`'s observing run:
    the flat, bias and dark counts, the exposure ratio, 40 star positions
    and fluxes, each frame's matrix (+-4 px dithers, with ``rotate``
    0.1-0.25 deg rotations about the centre), the stars' positions in
    every frame (N, 40) and the largest offset.  One numpy generator
    seeded with ``seed`` draws them all, in that order."""
    rng = np.random.default_rng(seed)
    yy = (np.arange(size, dtype=np.float32) - size / 2) / size
    r2 = yy[:, None] ** 2 + yy[None, :] ** 2
    flat = (1.0 - 0.08 * r2 / r2.max()).astype(np.float32)
    bias = np.full((size, size), 300.0, np.float32)
    dark_counts = np.full((size, size), 40.0, np.float32)
    hot = rng.integers(0, size, (200, 2))
    dark_counts[hot[:, 0], hot[:, 1]] = 5000.0
    xs = rng.uniform(48, size - 48, 40)
    ys = rng.uniform(48, size - 48, 40)
    fl = rng.uniform(20000, 60000, 40)
    cx = cy = (size - 1) / 2.0
    mats = np.zeros((n_frames, 2, 3), np.float64)
    px, py = np.empty((n_frames, 40)), np.empty((n_frames, 40))
    for i in range(n_frames):
        dx = dy = theta = 0.0
        if i:
            dx, dy = rng.uniform(-4.0, 4.0, 2)
            if rotate:
                theta = float(rng.choice([-1.0, 1.0])
                              * np.deg2rad(rng.uniform(0.1, 0.25)))
        c, s = np.cos(theta), np.sin(theta)
        mats[i] = [[c, -s, cx + dx - c * cx + s * cy],
                   [s, c, cy + dy - s * cx - c * cy]]
        px[i] = c * (xs - cx) - s * (ys - cy) + cx + dx
        py[i] = s * (xs - cx) + c * (ys - cy) + cy + dy
    return {"flat": flat, "bias": bias, "dark_counts": dark_counts,
            "exp_ratio": 0.5, "flux": fl, "mats": mats, "px": px, "py": py,
            "max_offset": float(np.hypot(px - xs, py - ys).max())}


def make_workload_on_device(n_frames: int, size: int, dev, rotate=False,
                            seed: int = 0, chunk: int = 32,
                            star_fwhm: float = 3.0):
    """:func:`make_workload`'s observing run made on the card ``chunk``
    frames at a time, for stacks whose float copy would not fit the
    host: the same masters, dithers, rotations and 40 stars
    (:func:`workload_geometry`) of FWHM ``star_fwhm`` (3 px by default),
    each drawn on a patch of at least +-4 sigma (+-12 px at 3 px) times
    the flat, but 8 ADU noise of its own in every frame (a generator on
    ``dev`` seeded with ``seed``) and no host copy of the stack.

    Returns (frames (N, size, size) uint16 on ``dev``, bias, dark_master,
    flat, exp_ratio, max_offset_px, matrices (N, 2, 3)), the masters and
    matrices as numpy."""
    from astrophotography_tpu_torch.device import to_uint16

    geo = workload_geometry(n_frames, size, rotate, seed)
    flat, bias, dark_counts = geo["flat"], geo["bias"], geo["dark_counts"]
    exp_ratio = geo["exp_ratio"]
    flat_t = torch.from_numpy(flat).to(dev)
    base = SKY * flat_t + torch.from_numpy(
        bias + exp_ratio * dark_counts).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    frames = torch.empty((n_frames, size, size), dtype=torch.int16,
                         device=dev)
    sigma = star_fwhm / 2.35482
    half = max(12, math.ceil(4.0 * sigma))
    d = torch.arange(2 * half + 1, device=dev)
    pxt, pyt = (torch.from_numpy(geo[k]).to(dev) for k in ("px", "py"))
    amp = torch.from_numpy(geo["flux"] / (2 * np.pi * sigma * sigma)).to(dev)
    x0, y0 = pxt.long() - half, pyt.long() - half
    for k in range(0, n_frames, chunk):
        sl = slice(k, min(k + chunk, n_frames))
        f = base + 8.0 * torch.randn((sl.stop - k, size, size), generator=g,
                                     device=dev)
        xx = (x0[sl, :, None, None] + d[None, None, None, :]) \
            .expand(-1, -1, d.numel(), -1)
        yy = (y0[sl, :, None, None] + d[None, None, :, None]) \
            .expand(-1, -1, -1, d.numel())
        star = amp[None, :, None, None] * torch.exp(
            -0.5 * (((xx - pxt[sl, :, None, None]) / sigma) ** 2
                    + ((yy - pyt[sl, :, None, None]) / sigma) ** 2))
        fi = torch.arange(sl.stop - k, device=dev)[:, None, None, None] \
            .expand_as(xx)
        f.index_put_((fi, yy, xx), (star * flat_t[yy, xx]).to(torch.float32),
                     accumulate=True)
        frames[sl] = to_uint16(f).view(torch.int16)
        del f, star
    return (frames.view(torch.uint16), bias, bias + dark_counts, flat,
            exp_ratio, geo["max_offset"], geo["mats"])


def _clip_inputs_chunked(n, h, w, dev, seed, chunk=100):
    """:func:`_clip_inputs`' masked stack made ``chunk`` frames at a
    time, so that no temporary of the whole stack's size exists."""
    g = torch.Generator(device=dev).manual_seed(seed)
    stack = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    mask = torch.empty((n, h, w), dtype=torch.bool, device=dev)
    for k in range(0, n, chunk):
        part = stack[k:k + chunk]
        torch.randn(part.shape, generator=g, device=dev, out=part)
        part.mul_(8.0).add_(SKY)
        part.masked_fill_(torch.rand(part.shape, generator=g, device=dev)
                          < 0.02, 40000.0)
        mask[k:k + chunk] = torch.rand(part.shape, generator=g,
                                       device=dev) > 0.2
    mask[:, ::97, :] = False
    return stack, mask


#: the route sweep of the deep phase: K2 on the lean snap and lowrank
#: windows at DEEP_SMALL^2, K3 on SWEEP_K3_SHAPE, every route each count
#: can take, in turns; the twins replay one count of each new route
SWEEP_K2_FRAMES = (100, 150, 200, 300, 400, 600, 908, 1200, 1700)
SWEEP_K3_FRAMES = (33, 64, 128, 192, 227, 228, 256, 454, 908, 1200)
SWEEP_K3_SHAPE = (256, 1024)
#: the counts replayed on the twins: K2 at 200 frames ('cols', snap), K3
#: at 454 ('cols') and at 33 forced onto 'select'
SWEEP_K2_TWIN, SWEEP_K3_TWIN = 200, {454: "cols", 33: "select"}


def _route_times(calls: dict) -> dict:
    """{route: mean ms} of one launch each, in turns (a, b, .., b, a)."""
    names = list(calls)
    times = {r: [] for r in names}
    for r in names + names[::-1]:
        times[r].append(_time_ms(calls[r], 1))
    return {r: sum(v) / len(v) for r, v in times.items()}


def run_route_sweep(card: str, dev) -> dict:
    """K2's and K3's routes against each other at the frame counts of
    SWEEP_K2_FRAMES / SWEEP_K3_FRAMES: every route the launcher has at
    that count (K2: 'smem' where a shared block of 8 rows fits, 'cols',
    and 'wide', which takes every span, against 'cols' whose warp phase
    it could replace; K3: 'smem' up to its 227 frames, 'cols', 'select'),
    forced through the wrapper, their images equal bit for bit, their ms
    in turns, and the route the wrapper picks.  One count of each new
    route is replayed on its twin.  Prints a line per count and one with
    the crossings: the frame count from which 'cols' is faster than every
    other route the launcher picks from at every larger count of the
    sweep, and K2 'wide' over 'cols' at each count."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.ops import clip_combine as cc
    from astrophotography_tpu_torch.ops import warp_combine as wc

    t0 = time.perf_counter()
    out = {"K2": {}, "K3": []}
    size = DEEP_SMALL
    for rotate in (False, True):
        window = "lowrank" if rotate else "snap"
        cfg = lean_config(rotate)
        fr, bias, dark, flat, exp_ratio, _off, mats = make_workload_on_device(
            max(SWEEP_K2_FRAMES), size, dev, rotate=rotate, seed=4)
        masters = _masters(bias, dark, flat, dev)[0]
        rows = []
        for n in SWEEP_K2_FRAMES:
            f = fr[:n]
            er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
            m = torch.from_numpy(mats[:n].astype(np.float32)).to(dev)
            kw = dict(span=cfg.warp_span, apron=True,
                      dither_budget=cfg.dither_budget,
                      general_taps=cfg.general_taps)
            plan = wc.plan_warp_combine(f.shape, m, er, **kw)
            routes = ["cols", "wide"] + (["smem"] if kernels._warp_smem_rows(
                n, plan.span) >= kernels._WARP_SMEM_ROWS else [])
            calls = {r: (lambda r=r: kernels.warp_combine_cuda(
                f, masters, plan, 0, True, 5.0, 5.0, route=r)) for r in routes}
            imgs = {r: c() for r, c in calls.items()}
            label = f"sweep K2 {window} {n}x{size}^2"
            for r in routes:
                _k2_exact(imgs[r], imgs["cols"], f"{label} {r} vs cols")
            rec = {"sweep": f"K2 {window}", "frames": n,
                   "shape": [n, size, size], "span": plan.span,
                   "picked": kernels._warp_route(n, plan.span),
                   "smem_rows": kernels._warp_smem_rows(n, plan.span),
                   "ms": _route_times(calls), "equal_across_routes": True,
                   # 'cols' without its combine: the warp phase and the
                   # samples' writes ('mean' skips the sort)
                   "cols_mean_ms": _time_ms(lambda: kernels.warp_combine_cuda(
                       f, masters, plan, 3, True, 5.0, 5.0, route="cols"), 2),
                   **_k2_bound(f, masters, size * size), "card": card}
            rec["ns_per_frame_pixel"] = {r: v * 1e6 / f.numel()
                                         for r, v in rec["ms"].items()}
            rec["wide_over_cols"] = rec["ms"]["wide"] / rec["ms"]["cols"]
            if n == SWEEP_K2_TWIN and not rotate:
                p, plain_ms = _timed(lambda: wc.warp_combine_plain(
                    f, m, masters=masters, exp_ratios=er, **kw))
                rec["twin"] = {"route": "cols", "plain_ms": plain_ms,
                               "max_abs_err": _k2_exact(imgs["cols"], p,
                                                        f"{label} twin")}
                del p
            _print(rec)
            rows.append(rec)
            del imgs
        out["K2"][window] = rows
        del fr, masters
        torch.cuda.empty_cache()

    n3, (h3, w3) = max(SWEEP_K3_FRAMES), SWEEP_K3_SHAPE
    stack, mask = _clip_inputs_chunked(n3, h3, w3, dev, seed=11)
    for n in SWEEP_K3_FRAMES:
        st, mk = stack[:n], mask[:n]
        routes = ["cols", "select"] + (
            ["smem"] if n <= kernels._CLIP_SMEM_FRAMES else [])
        calls = {r: (lambda r=r: kernels.clip_combine_cuda(
            st, mk, 5.0, 5.0, route=r)) for r in routes}
        imgs = {r: c() for r, c in calls.items()}
        label = f"sweep K3 {n}x{h3}x{w3}"
        for r in routes:
            _k3_exact(imgs[r], imgs["cols"], f"{label} {r} vs cols")
        rec = {"sweep": "K3", "frames": n, "shape": [n, h3, w3],
               "masked": True, "picked": kernels._clip_route(n),
               "ms": _route_times(calls), "equal_across_routes": True,
               **_bound(_nbytes(st, mk) + 4 * h3 * w3,
                        st.numel() * (5 + math.log2(n))),
               "card": card}
        rec["select_over_cols"] = rec["ms"]["select"] / rec["ms"]["cols"]
        if n in SWEEP_K3_TWIN:
            r = SWEEP_K3_TWIN[n]
            p, plain_ms = _timed(lambda: cc.clip_combine_plain(st, mk))
            rec["twin"] = {"route": r, "plain_ms": plain_ms,
                           "max_abs_err": _k3_exact(imgs[r], p,
                                                    f"{label} twin")}
            del p
        _print(rec)
        out["K3"].append(rec)
        del imgs
    del stack, mask
    torch.cuda.empty_cache()

    def crossing(recs):
        """The fewest frames from which 'cols' beats every other route
        the launcher picks from ('wide' is not one below span 193) at
        each larger count of the sweep (None where it never does)."""
        best = None
        for rec in reversed(recs):
            ms = {r: v for r, v in rec["ms"].items() if r != "wide"}
            if min(ms, key=ms.get) != "cols":
                break
            best = rec["frames"]
        return best

    out["crossings"] = {
        **{f"K2 {w}": crossing(r) for w, r in out["K2"].items()},
        "K3": crossing([r for r in out["K3"] if "smem" in r["ms"]]
                       + [r for r in out["K3"] if "smem" not in r["ms"]])}
    out["wall_s"] = time.perf_counter() - t0
    out["K2 wide over cols"] = {
        w: {r["frames"]: r["wide_over_cols"] for r in rs}
        for w, rs in out["K2"].items()}
    out["K3 select over cols"] = {r["frames"]: r["select_over_cols"]
                                  for r in out["K3"]}
    _print({"sweep": "crossings", "crossings": out["crossings"],
            "K2_wide_over_cols": out["K2 wide over cols"],
            "K3_select_over_cols": out["K3 select over cols"],
            "K2_smem_rows": kernels._WARP_SMEM_ROWS,
            "K3_cols_reach": kernels._CLIP_COLS_REACH,
            "wall_s": out["wall_s"], "card": card})
    return out


def k1_split(n: int, size: int, fwhms, card: str) -> dict:
    """K1's time split by kernel at each FWHM on ``n`` x ``size``^2 (the
    same seed-3 stack as the deep phase's K1 checks): ``tools/k1_routes.py``
    in a fresh process, whose torch.profiler sees the card's kernels (in a
    process that has run the earlier phases, a later profiler session
    recorded none).  Requires both of the separable route's kernels at
    every radius."""
    cmd = [sys.executable, os.path.join("tools", "k1_routes.py"), "--reps",
           "3", "--frames", str(n), "--size", str(size), "--fwhm",
           *map(str, fwhms)]
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=600)
    _require(proc.returncode == 0,
             f"tools/k1_routes.py exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    rows = [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]
    out = {}
    for row in rows:
        kms = row["kernel_ms"]
        _require({"detect_vpass_kernel", "detect_planes_kernel"} <= set(kms),
                 f"K1 split radius {row['radius']}: kernels {sorted(kms)}")
        out[f"r={row['radius']}"] = {"ms": row["ms"], "kernel_ms": kms}
    _require(len(out) == len(fwhms), f"K1 split: {len(out)} radii")
    res = {"phase": "K1 split", "shape": [n, size, size], **out,
           "card": card}
    _print(res)
    return res


def run_deep(card: str, dev) -> dict:
    """The kernels' routes past the shared-memory limits and radius 16,
    at sizes users run:

    * the lean path (``calibrate_register_stack_lean``, the snap lean
      config) on 1200 uint16 frames of 2048^2 with bias, dark and flat,
      +-4 px dithers (``make_workload_on_device``): K1 on its rolling
      route, K2 on its 'cols' route; registration and the stack checked
      as on the main path; the wall ms of one run after a warm-up, K1 and
      K2 by CUDA events, the peak device memory; then K1 and K2 held
      against their twins on the exact arguments that run gave them (K2
      bit for bit, K1 by its rule);
    * the unfused path (``calibrate_register_stack``, ``unfused_config``)
      on 1200 frames of 512^2: K3 on its 'cols' route, each of its two
      launches held against the twin bit for bit on its arguments, and
      its bound per launch;
    * K2's lowrank body against its twin bit for bit on 909 rotated
      frames of 512^2 ('cols');
    * K3 against its twin bit for bit on a masked 1200 x 1024 x 2048
      stack (10 GB and 2.5 GB of mask), the twin on the first 64 rows;
    * K3's 'select' route on a masked 30000 x 480 x 640 stack (46.1 GB, a
      lucky-imaging run), timed with its bound, the twin on the first 16
      rows bit for bit;
    * K1 at radii 17, 24 and 48 on 16 x 4096^2 against its twin by its
      rule (the separable route), then its column pass and planes kernel
      timed apart (:func:`k1_split`);
    * the route sweep (:func:`run_route_sweep`)."""
    import contextlib

    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.models import (
        calibrate_register_stack, calibrate_register_stack_lean)
    from astrophotography_tpu_torch.ops import clip_combine as cc
    from astrophotography_tpu_torch.ops import detect_tiles as dt

    t_phase = time.perf_counter()
    out = {}
    n, size = DEEP_FRAMES, DEEP_SIZE
    label = f"deep lean {n}x{size}^2 snap"
    cfg = lean_config(False)
    t0 = time.perf_counter()
    fr, bias, dark, flat, exp_ratio, max_off, mats = \
        make_workload_on_device(n, size, dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    kw = dict(bias=torch.from_numpy(bias).to(dev),
              dark=torch.from_numpy(dark).to(dev),
              flat=torch.from_numpy(flat).to(dev), exp_ratios=er)
    routes = {"K1": kernels._detect_route(dt._kernel_params(cfg.fwhm)[1]),
              "K2": kernels._warp_route(n, cfg.warp_span)}
    _require(routes == {"K1": "rolling", "K2": "cols"},
             f"{label}: routes {routes}")

    def run():
        return calibrate_register_stack_lean(fr, config=cfg, **kw)

    run()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        calls = {kind: stack.enter_context(_FirstCall(*_PIPELINE_CALLS[kind]))
                 for kind in ("K1", "K2")}
        clock = stack.enter_context(_KernelClock())
        stacked, diag = run()
        torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check_launches(label, launches, {"detect_tiles": 1, "warp_combine": 1})
    _require("jax" not in sys.modules, "jax was imported")
    min_in, max_rms, t_err = _check_registration(label, diag, mats)
    med = check_stack(label, stacked)
    del stacked, diag
    torch.cuda.empty_cache()
    checks = [_plain_check(kind, calls[kind].call, label)
              for kind in ("K1", "K2")]
    # K2's bound there: the raw stack, three master planes and the image
    k2_bound = _bound(_nbytes(fr) + 4 * 4 * size * size,
                      fr.numel() * (30 + math.log2(n)))
    out["lean"] = {"phase": label, "shape": [n, size, size],
                   "raw_bytes": _nbytes(fr), "single_run_ms": single_ms,
                   "kernel_ms": clock.ms(), "K2_bound": k2_bound,
                   "routes": routes,
                   "max_memory_allocated_bytes": peak, "launches": launches,
                   "min_inliers": min_in, "max_rms_px": max_rms,
                   "max_translation_err_px": t_err, "interior_median": med,
                   "plain_checks": checks,
                   "max_abs_err": {c["kernel"]: c["max_abs_err"]
                                   for c in checks},
                   "sky": SKY, "max_offset_px": max_off,
                   "workload_gen_s": gen_s, "card": card}
    _print(out["lean"])
    del fr, kw, calls
    torch.cuda.empty_cache()

    # the unfused path at 1200 x 512^2, K3's launches against the twin
    small = DEEP_SMALL
    fr, bias, dark, flat, exp_ratio, _off, mats = \
        make_workload_on_device(n, small, dev, seed=1)
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    ulabel = f"deep unfused {n}x{small}^2 snap"
    ucfg = unfused_config()
    ukw = dict(bias=torch.from_numpy(bias).to(dev),
               dark=torch.from_numpy(dark).to(dev),
               flat=torch.from_numpy(flat).to(dev), exp_ratios=er)
    _require(kernels._clip_route(n) == "cols", f"{ulabel}: K3 route")
    with _FirstCall(*_PIPELINE_CALLS["warp_separable"],
                    keep=ucfg.n_bands) as ws:
        calibrate_register_stack(fr, config=ucfg, **ukw)  # warm-up
    torch.cuda.synchronize()
    _require(len(ws.calls) == ucfg.n_bands, f"{ulabel}: warp_separable calls")
    sep_checks = [_plain_check("warp_separable", c, f"{ulabel} band {i}")
                  for i, c in enumerate(ws.calls)]
    del ws
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        k3 = stack.enter_context(_FirstCall(*_PIPELINE_CALLS["K3"],
                                            keep=ucfg.n_bands))
        clock = stack.enter_context(_KernelClock())
        stacked, diag = calibrate_register_stack(fr, config=ucfg, **ukw)
        torch.cuda.synchronize()
    u_ms = (time.perf_counter() - t0) * 1e3
    ulaunches = dict(kernels.launch_counts)
    u_peak = torch.cuda.max_memory_allocated()
    check_launches(ulabel, ulaunches, {"clip_combine": ucfg.n_bands,
                                       "warp_separable": None,
                                       "calibrate": 1, "find_exact": None})
    u_in, u_rms, u_err = _check_registration(ulabel, diag, mats,
                                             UNFUSED_T_ERR_PX)
    u_med = check_stack(ulabel, stacked)
    del stacked, diag
    _require(len(k3.calls) == ucfg.n_bands, f"{ulabel}: K3 calls")
    u_checks = [_plain_check("K3", c, f"{ulabel} band {i}")
                for i, c in enumerate(k3.calls)]
    # K3's bound per launch: its band's stack, mask and image
    k3_bounds = []
    for (a, kw3, _res) in k3.calls:
        st3 = a[0]
        mk3 = a[1] if len(a) > 1 else kw3.get("mask")
        k3_bounds.append(_bound(
            _nbytes(st3, mk3) + 4 * st3.shape[1] * st3.shape[2],
            st3.numel() * (5 + math.log2(st3.shape[0]))))
    out["unfused"] = {
        "phase": ulabel, "shape": [n, small, small],
        "single_run_ms": u_ms, "kernel_ms": clock.ms(),
        "K3_bound_per_launch": k3_bounds,
        "routes": {"K3": "cols"}, "max_memory_allocated_bytes": u_peak,
        "launches": ulaunches, "min_inliers": u_in, "max_rms_px": u_rms,
        "max_translation_err_px": u_err, "interior_median": u_med,
        "plain_checks": u_checks,
        "max_abs_err": max(c["max_abs_err"] for c in u_checks),
        "warp_separable_plain_checks": sep_checks,
        "warp_separable_max_abs_err": max(c["max_abs_err"]
                                          for c in sep_checks),
        "card": card}
    _print(out["unfused"])
    del fr, ukw, k3
    torch.cuda.empty_cache()

    # K2's lowrank body on 'cols' against the twin
    nl = DEEP_LOWRANK_FRAMES
    fr, bias, dark, flat, exp_ratio, _off, mats = \
        make_workload_on_device(nl, small, dev, rotate=True, seed=2)
    er = torch.full((nl,), exp_ratio, dtype=torch.float32, device=dev)
    masters = _masters(bias, dark, flat, dev)[0]
    lcfg = lean_config(True)
    out["K2 rotated lowrank"] = check_warp_exact(
        fr, torch.from_numpy(mats.astype(np.float32)).to(dev),
        f"deep K2 {nl}x{small}^2 rotated lowrank", card, reps=2,
        masters=masters, er=er, span=lcfg.warp_span, apron=True,
        dither_budget=lcfg.dither_budget, general_taps=lcfg.general_taps)
    _require(out["K2 rotated lowrank"]["route"] == "cols",
             f"deep K2 {nl} frames lowrank: route")
    del fr, masters
    torch.cuda.empty_cache()

    # K3's 'cols' route on a 10 GB masked stack
    n3, h3, w3 = DEEP_K3_SHAPE
    label = f"deep K3 {n3}x{h3}x{w3} masked"
    stack, mask = _clip_inputs_chunked(n3, h3, w3, dev, seed=7)
    k = cc.clip_combine(stack, mask)
    rows = slice(0, DEEP_K3_TWIN_ROWS)
    p, plain_ms = _timed(lambda: cc.clip_combine_plain(stack[:, rows],
                                                       mask[:, rows]))
    err = _k3_exact(k[rows], p, f"{label}, rows 0-{DEEP_K3_TWIN_ROWS - 1}")
    del k, p
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: cc.clip_combine(stack, mask), 2)
    ops = stack.numel() * (5 + math.log2(n3))
    out["K3"] = {"phase": "K3 vs clip_combine_plain", "case": label,
                 "shape": [n3, h3, w3], "route": kernels._clip_route(n3),
                 "twin_rows": DEEP_K3_TWIN_ROWS, "max_abs_err": err,
                 "ms": ms, "plain_ms": plain_ms,
                 "plain_ms_whole_stack_estimate": plain_ms * h3
                 / DEEP_K3_TWIN_ROWS,
                 **_bound(_nbytes(stack, mask) + 4 * h3 * w3, ops),
                 "card": card}
    _print(out["K3"])
    del stack, mask
    torch.cuda.empty_cache()

    # K3's 'select' route (past the 'cols' reach) on a lucky-imaging run
    n3, h3, w3 = DEEP_SELECT_SHAPE
    label = f"deep K3 select {n3}x{h3}x{w3} masked"
    _require(kernels._clip_route(n3) == "select", f"{label}: route")
    stack, mask = _clip_inputs_chunked(n3, h3, w3, dev, seed=13)
    kernels.reset_launch_counts()
    k = cc.clip_combine(stack, mask)
    torch.cuda.synchronize()
    select_launches = kernels.launch_counts["clip_combine"]
    _require(select_launches == 1, f"{label}: {select_launches} launches")
    _require(tuple(k.shape) == (h3, w3), f"{label}: shape {tuple(k.shape)}")
    rows = slice(0, DEEP_SELECT_TWIN_ROWS)
    p, plain_ms = _timed(lambda: cc.clip_combine_plain(stack[:, rows],
                                                       mask[:, rows]))
    err = _k3_exact(k[rows], p,
                    f"{label}, rows 0-{DEEP_SELECT_TWIN_ROWS - 1}")
    nan_pixels = int(torch.isnan(k).sum())
    _require(nan_pixels == (h3 + 96) // 97 * w3,
             f"{label}: {nan_pixels} NaN pixels (every 97th row is masked)")
    del k, p
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: cc.clip_combine(stack, mask), 3)
    ops = stack.numel() * (5 + math.log2(n3))
    out["K3 select"] = {
        "phase": "K3 vs clip_combine_plain", "case": label,
        "shape": [n3, h3, w3], "masked": True, "route": "select",
        "passes": kernels._CLIP_SELECT_PASSES, "launches": select_launches,
        "twin_rows": DEEP_SELECT_TWIN_ROWS, "max_abs_err": err,
        "nan_pixels": nan_pixels, "ms": ms, "plain_ms": plain_ms,
        "plain_ms_whole_stack_estimate": plain_ms * h3
        / DEEP_SELECT_TWIN_ROWS,
        **_bound(_nbytes(stack, mask) + 4 * h3 * w3, ops), "card": card}
    out["K3 select"]["over_bound"] = ms / out["K3 select"]["bound_ms"]
    _print(out["K3 select"])
    del stack, mask
    torch.cuda.empty_cache()

    # K1 past radius 16
    nk, sk = DEEP_K1_FRAMES, DEEP_K1_SIZE
    fr, bias, dark, flat, exp_ratio, _off, _mats = \
        make_workload_on_device(nk, sk, dev, seed=3)
    masters, b_t, du_t, f_t = _masters(bias, dark, flat, dev)
    er = torch.full((nk,), exp_ratio, dtype=torch.float32, device=dev)
    for fwhm in DEEP_K1_FWHM:
        r = dt._kernel_params(fwhm)[1]
        mf = dt.master_densities(b_t, du_t, f_t, fwhm=fwhm)
        # a threshold below every density: each tile's best local peak
        # (the lowered Gaussian of a 32-64 px FWHM leaves most tiles of
        # this field below zero)
        out[f"K1 r={r}"] = check_detect(
            fr, torch.full((nk,), -1e30, device=dev), mf, masters[0], er,
            f"deep {nk}x{sk}^2 radius {r} (fwhm {fwhm})", card, fwhm=fwhm)
        _require(out[f"K1 r={r}"]["route"] == "separable",
                 f"deep K1 radius {r}: route")
        _require(out[f"K1 r={r}"]["max_abs_err"] == 0.0,
                 f"deep K1 radius {r}: maxima not the twin's bits")
        _require(out[f"K1 r={r}"]["live_tiles"] > 0,
                 f"deep K1 radius {r}: no live tile")
    del fr, masters, mf
    torch.cuda.empty_cache()
    out["K1 split"] = k1_split(DEEP_K1_FRAMES, DEEP_K1_SIZE, DEEP_K1_FWHM,
                               card)
    out["sweep"] = run_route_sweep(card, dev)
    out["wall_s"] = time.perf_counter() - t_phase
    _print({"phase": "deep", "wall_s": out["wall_s"],
            "resident_blocks": {"/".join(map(str, k)): v
                                for k, v in kernels._resident.items()},
            "card": card})
    return out


#: the oversampled phase: stars of OVERSAMPLED_FWHM px on the lean
#: workload's 100 x 4096^2 (a C8 at 2032 mm with 2.9 um pixels samples
#: 0.29"/px, so 2.5" seeing is ~8.5 px), detected at that FWHM; then K1 at
#: the FWHMs of the ring route's radii 4, 6, 8, 12 and 16 on the same stack
OVERSAMPLED_FWHM = 8.0
OVERSAMPLED_K1_FWHM = (5.0, 8.0, 10.7, 16.0, 21.0)


def run_oversampled(card: str, dev) -> dict:
    """The lean path (``calibrate_register_stack_lean``, the snap lean
    config with ``fwhm=8.0``) on 100 uint16 frames of 4096^2 with bias,
    dark and flat, +-4 px dithers and 40 stars of 8 px FWHM
    (``make_workload_on_device``): K1 on its ring route at radius 6, K2 on
    its 'smem' snap body, one launch each; registration (5 inliers, rms
    under 0.5 px, translations within 0.5 px of the true dithers) and the
    stack's interior median checked; the wall ms of one run after a
    warm-up, K1 and K2 by CUDA events, the peak device memory; the run's
    own K1 call replayed on its twin.  Then K1 at radii 4, 6, 8, 12 and 16
    on that stack with the masters against its twin (``check_detect``),
    each on the ring route.  The ring kernel rounds op by op as the twin
    does: its tile maxima must be the twin's bits."""
    import contextlib

    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.models import (
        calibrate_register_stack_lean)
    from astrophotography_tpu_torch.ops import detect_tiles as dt

    t_phase = time.perf_counter()
    n, size = N_FRAMES, SIZE
    label = f"oversampled lean {n}x{size}^2 fwhm {OVERSAMPLED_FWHM}"
    cfg = dataclasses.replace(lean_config(False), fwhm=OVERSAMPLED_FWHM)
    t0 = time.perf_counter()
    fr, bias, dark, flat, exp_ratio, max_off, mats = \
        make_workload_on_device(n, size, dev, star_fwhm=OVERSAMPLED_FWHM)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    kw = dict(bias=torch.from_numpy(bias).to(dev),
              dark=torch.from_numpy(dark).to(dev),
              flat=torch.from_numpy(flat).to(dev), exp_ratios=er)
    r = dt._kernel_params(cfg.fwhm)[1]
    routes = {"K1": kernels._detect_route(r),
              "K2": kernels._warp_route(n, cfg.warp_span)}
    _require(routes == {"K1": "ring", "K2": "smem"},
             f"{label}: routes {routes}")

    def run():
        return calibrate_register_stack_lean(fr, config=cfg, **kw)

    run()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        k1 = stack.enter_context(_FirstCall(*_PIPELINE_CALLS["K1"]))
        clock = stack.enter_context(_KernelClock())
        stacked, diag = run()
        torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    check_launches(label, launches, {"detect_tiles": 1, "warp_combine": 1})
    _require("jax" not in sys.modules, "jax was imported")
    min_in, max_rms, t_err = _check_registration(label, diag, mats,
                                                 UNFUSED_T_ERR_PX)
    med = check_stack(label, stacked)
    del stacked, diag
    torch.cuda.empty_cache()
    k1_check = _plain_check("K1", k1.call, label)
    _require(k1_check["max_abs_err"] == 0.0,
             f"{label}: K1 maxima not the twin's bits")
    kernel_ms = clock.ms()
    out = {"main": {
        "phase": label, "shape": [n, size, size], "fwhm": cfg.fwhm,
        "radius": r, "routes": routes, "single_run_ms": single_ms,
        "K1_ms": kernel_ms["detect_tiles"], "K2_ms": kernel_ms["warp_combine"],
        "max_memory_allocated_bytes": peak, "launches": launches,
        "min_inliers": min_in, "max_rms_px": max_rms,
        "max_translation_err_px": t_err, "interior_median": med, "sky": SKY,
        "K1_plain_check": k1_check, "max_offset_px": max_off,
        "workload_gen_s": gen_s, "card": card}}
    _print(out["main"])
    del k1

    # K1 at each radius of the ring route on this stack (threshold: the
    # lean path's nsigma x the 8 ADU noise)
    masters, b_t, du_t, f_t = _masters(bias, dark, flat, dev)
    thr = torch.full((n,), cfg.detect_nsigma * 8.0, device=dev)
    for fwhm in OVERSAMPLED_K1_FWHM:
        rk = dt._kernel_params(fwhm)[1]
        mf = dt.master_densities(b_t, du_t, f_t, fwhm=fwhm)
        res = check_detect(fr, thr, mf, masters[0], er,
                           f"oversampled {n}x{size}^2 radius {rk} "
                           f"(fwhm {fwhm})", card, fwhm=fwhm)
        _require(res["route"] == "ring", f"{label}: K1 radius {rk} route")
        # the ring kernel rounds op by op as its twin does
        _require(res["max_abs_err"] == 0.0,
                 f"{label}: K1 radius {rk} maxima not the twin's bits")
        _require(res["live_tiles"] > 0, f"{label}: K1 radius {rk} no tile")
        out[f"K1 r={rk}"] = res
        del mf
    del fr, masters, kw
    torch.cuda.empty_cache()
    out["max_abs_err"] = max([k1_check["max_abs_err"]]
                             + [v["max_abs_err"] for k, v in out.items()
                                if k.startswith("K1 r=")])
    out["wall_s"] = time.perf_counter() - t_phase
    _print({"phase": "oversampled", "wall_s": out["wall_s"], "card": card})
    return out


#: the 'wide' phase: K2 past span 192 (its 'wide' route) against its twin
#: bit for bit on WIDE_TWIN_FRAMES x WIDE_TWIN_SIZE^2 at each of
#: WIDE_SPANS (193, 256 and the route's reach), every tap body, uint16
#: with masters and float32 without; then the unfused pipeline with the
#: fused combine on a field-rotation stack: WIDE_FRAMES of WIDE_SIZE^2
#: turning 0 to WIDE_MAX_DEG about the centre (an alt-az mount over about
#: an hour), span WIDE_SPAN, tiles WIDE_TILE, a dither budget that keeps
#: the outer tiles' windows holding the turned frames
WIDE_SPANS = (193, 256, 1436)
WIDE_TWIN_FRAMES, WIDE_TWIN_SIZE = 6, 512
WIDE_FRAMES, WIDE_SIZE, WIDE_MAX_DEG = 24, 2048, 12.0
WIDE_SPAN, WIDE_TILE, WIDE_BUDGET = 256, (320, 1024), 256
#: K2 'wide' alone at the sizes its users run (tools/tail_routes.py's
#: cases), uint16 with masters made on the card: the lean cells' 100 x
#: 4096^2 under a 0-12 deg field rotation, and an alt-az hour, 360 subs
#: of 10 s turning 0-15 deg (span 288: at 256 a tenth of the (frame,
#: tile) pairs fail the gate); (label, frames, size, degrees, span)
WIDE_ALONE = (("lean size", 100, 4096, 12.0, 256),
              ("alt-az hour", 360, 2048, 15.0, 288))


def make_field_rotation(n_frames: int, size: int, max_deg: float,
                        seed: int = 5):
    """:func:`make_workload`'s observing run (its masters, sky, noise and
    3 px FWHM stars) with the field turning: frame i rotated by max_deg *
    i / (n - 1) about the centre (0 for the reference) and dithered by up
    to 4 px; the 48 stars lie in a disk that stays inside every frame.
    Returns what :func:`make_workload` returns."""
    rng = np.random.default_rng(seed)
    yy = (np.arange(size, dtype=np.float32) - size / 2) / size
    r2 = yy[:, None] ** 2 + yy[None, :] ** 2
    flat = (1.0 - 0.08 * r2 / r2.max()).astype(np.float32)
    bias = np.full((size, size), 300.0, np.float32)
    dark_counts = np.full((size, size), 40.0, np.float32)
    hot = rng.integers(0, size, (200, 2))
    dark_counts[hot[:, 0], hot[:, 1]] = 5000.0
    exp_ratio = 0.5
    cx = cy = (size - 1) / 2.0
    rad = np.sqrt(rng.uniform(0, 1, 48)) * (0.5 * size - 48)
    ang = rng.uniform(0, 2 * np.pi, 48)
    xs, ys = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
    fl = rng.uniform(20000, 60000, 48)
    base_fixed = SKY * flat + bias + exp_ratio * dark_counts
    noise_bank = [rng.normal(0, 8.0, (size, size)).astype(np.float32)
                  for _ in range(min(4, n_frames))]
    frames = np.empty((n_frames, size, size), np.uint16)
    mats = np.zeros((n_frames, 2, 3), np.float64)
    max_off = 0.0
    for i in range(n_frames):
        theta = np.deg2rad(max_deg * i / max(n_frames - 1, 1))
        dx, dy = rng.uniform(-4.0, 4.0, 2) if i else (0.0, 0.0)
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
    return frames, bias, bias + dark_counts, flat, exp_ratio, max_off, mats


def rotation_mats(n: int, size: int, max_deg: float, seed: int = 0):
    """Frame i turned by max_deg * i / (n - 1) about the centre and
    dithered by up to 4 px (frame 0 the identity), as
    :func:`make_field_rotation` draws them, for frames made elsewhere."""
    rng = np.random.default_rng(seed)
    c0 = (size - 1) / 2.0
    mats = np.zeros((n, 2, 3), np.float64)
    for i in range(n):
        th = np.deg2rad(max_deg * i / max(n - 1, 1))
        dx, dy = rng.uniform(-4.0, 4.0, 2) if i else (0.0, 0.0)
        c, s = np.cos(th), np.sin(th)
        mats[i] = [[c, -s, c0 + dx - c * c0 + s * c0],
                   [s, c, c0 + dy - s * c0 - c * c0]]
    return mats


def wide_alone(label, n, size, deg, span, card, dev) -> dict:
    """K2 on its 'wide' route alone ('exact', combine 'average') on
    ``n`` x ``size``^2 uint16 frames with masters made on the card
    (:func:`make_workload_on_device`) under a 0-``deg`` field rotation at
    ``span``: one launch on 'wide' counted from 0, a finite image of the
    frame's shape, covered and at the sky in its interior; then its ms
    (average) and warp phase alone (mean) in turns, and its bound."""
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.ops import warp_combine as wc

    label = f"wide alone {label} {n}x{size}^2 0-{deg:g} deg"
    t0 = time.perf_counter()
    fr, bias, dark, flat, exp_ratio, _off, _m = make_workload_on_device(
        n, size, dev, seed=6)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    masters = _masters(bias, dark, flat, dev)[0]
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    mats = torch.from_numpy(rotation_mats(n, size, deg).astype(np.float32)) \
        .to(dev)
    plan = wc.plan_warp_combine(fr.shape, mats, er, span=span, tile=WIDE_TILE,
                                dither_budget=WIDE_BUDGET)
    _require(kernels._warp_route(n, plan.span) == "wide", f"{label}: route")

    def call(combine):
        return lambda: kernels.warp_combine_cuda(fr, masters, plan, combine,
                                                 False, 5.0, 5.0)

    kernels.reset_launch_counts()
    img = call(0)()
    torch.cuda.synchronize()
    routes = dict(kernels.warp_route_counts)
    _require(routes == {"smem": 0, "cols": 0, "wide": 1},
             f"{label}: K2 routes {routes}")
    _require(tuple(img.shape) == (size, size), f"{label}: shape")
    covered = float((img != 0).float().mean())
    _require(covered > 0.9, f"{label}: covered {covered}")
    med = check_stack(label, img)
    del img
    times = {"average": [], "mean": []}
    for c in ("average", "mean", "mean", "average"):
        times[c].append(_time_ms(call(0 if c == "average" else 3), 3))
    avg, mean = (sum(times[c]) / 2 for c in ("average", "mean"))
    res = {"phase": label, "shape": [n, size, size], "span": plan.span,
           "tile": list(WIDE_TILE), "dither_budget": WIDE_BUDGET,
           "route": "wide",
           "block_rows": kernels._warp_block_rows(n, plan.span, "wide"),
           "launches": routes["wide"], "covered_fraction": covered,
           "interior_median": med, "ms": avg, "average_ms": times["average"],
           "mean_ms": times["mean"], "warp_phase_ms": mean,
           "combine_ms": avg - mean,
           **_k2_wide_bound(fr, masters, plan, "exact"),
           "workload_gen_s": gen_s, "card": card}
    res["over_bound"] = avg / res["bound_ms"]
    _print(res)
    del fr, masters, plan
    torch.cuda.empty_cache()
    return res


def _wide_mats(n: int, body: str, size: int, seed: int) -> np.ndarray:
    """Matrices of a 'wide' twin check: frame 0 identity and frame 2 a
    pure translation (both snapped), the others translated by up to 4 px
    and, for 'exact', rotated by 5-15 deg about the centre, for 'lowrank'
    by 0.0002-0.0006 rad (its gate, |gy| (th + span) <= 2, admits no more
    at the reach's tile)."""
    rng = np.random.default_rng(seed)
    lo, hi = {"snap": (0.0, 0.0), "exact": (np.deg2rad(5.0), np.deg2rad(15.0)),
              "lowrank": (2e-4, 6e-4)}[body]
    c0 = (size - 1) / 2.0
    mats = np.zeros((n, 2, 3), np.float32)
    for f in range(n):
        th = 0.0 if f in (0, 2) else rng.choice([-1, 1]) * rng.uniform(lo, hi)
        tx, ty = rng.uniform(-4, 4, 2) if f else (0.0, 0.0)
        c, s = np.cos(th), np.sin(th)
        mats[f] = [[c, -s, c0 - c * c0 + s * c0 + tx],
                   [s, c, c0 - s * c0 - c * c0 + ty]]
    return mats


def _k2_wide_bound(frames, masters, plan, body: str) -> dict:
    """K2's least time on its 'wide' route: the stack and the masters read
    once and the image written, against the operations this run's frames
    need.  Per covered (frame, pixel), with the twin's coverage (the
    frame's bounds, its tile's base and gate): 5 flops of calibration
    (with masters), the vertical pass, a reciprocal and log2(N) compares
    of the sort.  Per mid value a covered pixel reads, the horizontal
    pass: a tile column of k covered rows reads |m11| (k - 1) + 6 source
    rows (6 non-zero taps about a line of slope m11).  A pass is 6 taps
    at 2 flops plus, on the 'exact' body's rotated frames, each tap's
    weight (the degree-10 polynomial in t^2: 22 flops) and its sum (1),
    and a reciprocal."""
    n, h0, w0 = frames.shape
    th, tw = plan.th, plan.tw
    dev = plan.table.device
    ys = torch.arange(h0, device=dev, dtype=torch.float32)[:, None]
    xs = torch.arange(w0, device=dev, dtype=torch.float32)[None, :]
    ti = torch.arange(h0, device=dev) // th
    tj = torch.arange(w0, device=dev) // tw
    pad = plan.n_ti * th - h0
    ops = 0.0
    for f in range(n):
        (m00, m01, m02, m10, m11, m12, _er, _fs, trans, vlo, vhi,
         _gx, _gy, _g0, gate, _p) = plan.table[f].tolist()
        if trans <= 0.5 and gate <= 0.5:
            continue
        ok = plan.tiles[f].reshape(plan.n_ti, plan.n_tj, 3)[..., 2] > 0
        v = m10 * xs + m11 * ys + m12
        sx = m00 * xs + m01 * ys + m02
        cov = ((sx >= 2.0) & (sx <= w0 - 4.0) & (v >= vlo) & (v <= vhi)
               & ok[ti][:, tj])
        pixels = int(cov.sum())
        columns = int(torch.nn.functional.pad(cov, (0, 0, 0, pad))
                      .reshape(plan.n_ti, th, w0).any(1).sum())
        mids = abs(m11) * (pixels - columns) + 6 * columns
        tap = 25 if body == "exact" and trans <= 0.5 else 2
        ops += (pixels * ((5 if masters is not None else 0) + 6 * tap + 1
                          + math.log2(max(n, 2)))
                + mids * (6 * tap + 1))
    n_out = h0 * w0
    return _bound(_nbytes(frames, masters) + 4 * n_out, ops)


def run_wide(card: str, dev) -> dict:
    """K2's 'wide' route: the twin checks at each span, body and input
    type (small frames: the twin's 'exact' body costs ~span taps a pixel
    and frame); then ``calibrate_register_stack`` with
    ``combine_impl='fused'`` at span WIDE_SPAN on the field-rotation
    stack through the normal entry point: K2 launched once and on
    'wide', the registration rule, a finite stack at the sky, the
    kernel's call replayed on its twin bit for bit, the kernel alone
    timed on that call's plan, its bound and the twin's time; then K2
    'wide' alone at WIDE_ALONE's sizes (:func:`wide_alone`)."""
    import contextlib

    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.device import to_float32
    from astrophotography_tpu_torch.models import (PipelineConfig,
                                                   calibrate_register_stack)
    from astrophotography_tpu_torch.ops import warp_combine as wc

    t_phase = time.perf_counter()
    out = {"checks": []}
    n, size = WIDE_TWIN_FRAMES, WIDE_TWIN_SIZE
    frames, bias, dark, flat, exp_ratio, _off, _m = make_field_rotation(
        n, size, WIDE_MAX_DEG, seed=9)
    raw = torch.from_numpy(frames).to(dev)
    masters = _masters(bias, dark, flat, dev)[0]
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    cal = (to_float32(raw) * masters[0] - masters[1]
           - exp_ratio * masters[2])
    for span in WIDE_SPANS:
        for body in ("snap", "exact", "lowrank"):
            mats = torch.from_numpy(_wide_mats(n, body, size, span)).to(dev)
            kw = dict(span=span, tile=(span + 8, 128), dither_budget=128,
                      general_taps="lowrank" if body == "lowrank"
                      else "exact")
            plan = wc.plan_warp_combine(raw.shape, mats, er, **kw)
            used = plan.table[:, 8 if body == "snap" else 14] > 0.5
            _require(bool(used.all()), f"wide {body} span {span}: frames "
                                       f"on the body {used.tolist()}")
            for kind, (fr, m_, e_) in (("uint16", (raw, masters, er)),
                                       ("float32", (cal, None, None))):
                label = f"wide {body} span {span} {kind} {n}x{size}^2"
                before = kernels.warp_route_counts["wide"]
                rec = check_warp_exact(fr, mats, label, card, reps=3,
                                       masters=m_, er=e_, **kw)
                _require(rec["route"] == "wide" and kernels.warp_route_counts
                         ["wide"] > before, f"{label}: route {rec['route']}")
                out["checks"].append(dict(rec, body=body, span=span,
                                          input=kind,
                                          block_rows=kernels._warp_block_rows(
                                              n, span)))
    del raw, cal, masters
    torch.cuda.empty_cache()

    n, size = WIDE_FRAMES, WIDE_SIZE
    label = f"wide pipeline {n}x{size}^2 0-{WIDE_MAX_DEG:g} deg"
    t0 = time.perf_counter()
    frames, bias, dark, flat, exp_ratio, max_off, mats = make_field_rotation(
        n, size, WIDE_MAX_DEG)
    gen_s = time.perf_counter() - t0
    fr = torch.from_numpy(frames).to(dev)
    del frames
    kw = dict(bias=torch.from_numpy(bias).to(dev),
              dark=torch.from_numpy(dark).to(dev),
              flat=torch.from_numpy(flat).to(dev),
              exp_ratios=torch.full((n,), exp_ratio, dtype=torch.float32,
                                    device=dev))
    cfg = PipelineConfig(combine_impl="fused", warp_span=WIDE_SPAN,
                         fused_tile=WIDE_TILE, dither_budget=WIDE_BUDGET)
    _require(kernels._warp_route(n, WIDE_SPAN) == "wide", f"{label}: route")
    calibrate_register_stack(fr, config=cfg, **kw)          # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        k2 = stack.enter_context(_FirstCall(*_PIPELINE_CALLS["K2"]))
        clock = stack.enter_context(_KernelClock())
        stacked, diag = calibrate_register_stack(fr, config=cfg, **kw)
        torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(kernels.launch_counts)
    routes = dict(kernels.warp_route_counts)
    check_launches(label, launches, {"warp_combine": 1, "calibrate": 1,
                                     "find_exact": None})
    _require(routes == {"smem": 0, "cols": 0, "wide": 1},
             f"{label}: K2 routes {routes}")
    _require("jax" not in sys.modules, "jax was imported")
    min_in, max_rms, t_err = _check_registration(label, diag, mats,
                                                 UNFUSED_T_ERR_PX)
    theta = diag["theta"].cpu().numpy()
    theta_err = float(np.max(np.abs(theta - np.arctan2(mats[:, 1, 0],
                                                       mats[:, 0, 0]))))
    med = check_stack(label, stacked)
    covered = float((stacked != 0).float().mean())
    del stacked
    a, k, _res = k2.call
    check = _plain_check("K2", k2.call, label)
    plan = wc.plan_warp_combine(
        a[0].shape, a[1], span=k["span"], tile=k["tile"], apron=k["apron"],
        dither_budget=k["dither_budget"], general_taps=k["general_taps"])
    used = ((plan.tiles[:, :, 2] > 0)
            & (plan.table[:, 14, None] > 0.5)).float().mean()
    ms = _time_ms(lambda: kernels.warp_combine_cuda(
        a[0], None, plan, 0, False, cfg.sigma_lower, cfg.sigma_upper), 3)
    out["pipeline"] = {
        "phase": label, "shape": [n, size, size], "span": WIDE_SPAN,
        "tile": list(WIDE_TILE), "dither_budget": WIDE_BUDGET,
        "route": "wide", "block_rows": kernels._warp_block_rows(n, WIDE_SPAN),
        "launches": launches, "warp_routes": routes,
        "single_run_ms": run_ms, "kernel_ms_in_run": clock.ms(),
        "min_inliers": min_in, "max_rms_px": max_rms,
        "max_translation_err_px": t_err, "max_theta_err_rad": theta_err,
        "interior_median": med, "sky": SKY, "covered_fraction": covered,
        "frame_tile_pairs_used": float(used), "max_offset_px": max_off,
        "plain_check": check, "max_abs_err": check["max_abs_err"],
        "ms": ms, "plain_ms": check["plain_ms"],
        **_k2_wide_bound(a[0], None, plan, "exact"),
        "workload_gen_s": gen_s, "card": card}
    _print(out["pipeline"])
    del fr, kw, k2, a, k
    torch.cuda.empty_cache()
    out["alone"] = {case[0]: wide_alone(*case, card, dev)
                    for case in WIDE_ALONE}
    out["max_abs_err"] = max([c["max_abs_err"] for c in out["checks"]]
                             + [check["max_abs_err"]])
    out["wall_s"] = time.perf_counter() - t_phase
    _print({"phase": "wide", "wall_s": out["wall_s"],
            "twin_checks": len(out["checks"]),
            "max_abs_err": out["max_abs_err"], "card": card})
    return out


def main(argv=None) -> int:
    from astrophotography_tpu_torch import kernels
    from astrophotography_tpu_torch.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=PHASES,
                    help="run this group of phases alone (default: all)")
    args = ap.parse_args(argv)
    phases = set(PHASES) if args.only is None else {args.only}
    dev = resolve_device("cuda")        # raises without a usable card
    card = card_line()
    t0 = time.perf_counter()
    libs = kernels.build()
    build_s = time.perf_counter() - t0
    kernels._load()
    _print({"phase": "build", "libraries": {k: str(v) for k, v in libs.items()},
            "seconds": build_s,
            "nvcc": kernels.build_info.get("nvcc_version"),
            "ptxas": kernels.build_info.get("ptxas"),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "card": card})

    snap = rot = unfused = multichip = {}
    if phases & {"k1", "k2", "lean", "bands", "multichip"}:
        snap = run_main_path(False, card, dev, phases)
    if phases & {"k2", "lean", "bands", "multichip"}:
        rot = run_main_path(True, card, dev, phases)
    if phases & {"k3", "unfused"}:
        unfused = run_unfused_path(card, dev, phases)
    bench = {}
    if "bench" in phases:
        bench = run_bench(card, {k: r["main"] for k, r in (
            ("snap", snap), ("rotated", rot), ("unfused", unfused))
            if "main" in r})
    if "multichip" in phases:
        multichip = run_multichip(card, dev, snap.pop("multichip"),
                                  rot.pop("multichip"))
    if "small" in phases:
        run_lean_chunked(card, dev)
        run_small_matrix(card, dev)
    if "bands" in phases:
        check_bounds_geom(card, dev)
    if "measure" in phases:
        run_measure(card, dev)
    if "raw" in phases:
        run_raw(card, dev)
    if "files" in phases:
        run_files(card, dev)
    reduce = deep = wide = oversampled = {}
    if "reduce" in phases:
        reduce = run_reduce(card, dev)
    if "deep" in phases:
        deep = run_deep(card, dev)
    if "oversampled" in phases:
        oversampled = run_oversampled(card, dev)
    if "wide" in phases:
        wide = run_wide(card, dev)

    if args.only is None:
        launches = snap["main"]["launches"]
        red = reduce["main"]
        mc_err = multichip["plain_max_abs_err"]
        deep_err = deep["lean"]["max_abs_err"]
        over = oversampled["main"]["launches"]
        k1 = dict(snap["detect_tiles"],
                  max_abs_err=max(snap["detect_tiles"]["max_abs_err"],
                                  mc_err["K1"], deep_err["K1"],
                                  oversampled["max_abs_err"],
                                  *(deep[f"K1 r={r}"]["max_abs_err"]
                                    for r in (17, 24, 48))))
        k2 = dict(snap["warp_combine"],
                  max_abs_err=max(snap["warp_combine"]["max_abs_err"],
                                  rot["warp_combine"]["max_abs_err"],
                                  reduce["K2 V"]["max_abs_err"],
                                  reduce["K2 R"]["max_abs_err"],
                                  mc_err["K2"], deep_err["K2"],
                                  deep["K2 rotated lowrank"]["max_abs_err"]))
        k3 = dict(unfused["clip_combine"],
                  max_abs_err=max(unfused["clip_combine"]["max_abs_err"],
                                  reduce["K3 V"]["max_abs_err"],
                                  mc_err["K3"], deep["K3"]["max_abs_err"],
                                  deep["K3 select"]["max_abs_err"],
                                  deep["unfused"]["max_abs_err"]))
        deep_lean = deep["lean"]["launches"]
        bench_lean = {f"bench lean {k}": bench["default"]["lines"][i]
                      ["launches"] for k, i in (("snap", 0), ("rotated", 2))}
        bench_k3 = bench["pallas"]["lines"][0]["launches"]["clip_combine"]
        _print({"kernels": [
            _kernel_entry("detect_tiles",
                          "astrophotography_tpu/ops/pallas_detect.py:405",
                          "lean",
                          {"lean": launches["detect_tiles"],
                           "multichip": _mc_launches(multichip,
                                                     "detect_tiles"),
                           "deep": deep_lean["detect_tiles"],
                           "oversampled": over["detect_tiles"],
                           **{k: v["detect_tiles"]
                              for k, v in bench_lean.items()}},
                          k1),
            _kernel_entry("warp_combine",
                          "astrophotography_tpu/ops/pallas_warp_combine.py:658",
                          "lean",
                          {"lean": launches["warp_combine"],
                           "bands": snap["bands"]["launches"]["warp_combine"],
                           "ap_stack fused": red["ap_stack"]["fused"]
                           ["launches"]["warp_combine"],
                           "reduce": red["ap_reduce"]["launches"]
                           ["warp_combine"],
                           "multichip": _mc_launches(multichip,
                                                     "warp_combine"),
                           "deep": deep_lean["warp_combine"],
                           "oversampled": over["warp_combine"],
                           **{k: v["warp_combine"]
                              for k, v in bench_lean.items()}},
                          k2),
            _kernel_entry("clip_combine",
                          "astrophotography_tpu/ops/pallas_combine.py:102",
                          "unfused",
                          {"unfused": unfused["main"]["launches"]["clip_combine"],
                           "unfused with badpix_mask":
                               unfused["main"]["with_badpix_mask"]["launches"]
                               ["clip_combine"],
                           "ap_stack pallas": red["ap_stack"]["pallas"]
                           ["launches"]["clip_combine"],
                           "multichip": _mc_launches(multichip,
                                                     "clip_combine"),
                           "deep unfused": deep["unfused"]["launches"]
                           ["clip_combine"],
                           "deep select": deep["K3 select"]["launches"],
                           "bench pallas": bench_k3},
                          k3),
            _kernel_entry("warp_combine",
                          "astrophotography_tpu/ops/pallas_warp_combine.py:658",
                          "wide pipeline",
                          {"wide pipeline": wide["pipeline"]["warp_routes"]
                           ["wide"],
                           **{f"wide alone {k}": v["launches"]
                              for k, v in wide["alone"].items()}},
                          dict(wide["pipeline"],
                               max_abs_err=wide["max_abs_err"]),
                          route="wide"),
        ]})
    print(card, flush=True)
    _print({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
