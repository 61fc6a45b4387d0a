#!/usr/bin/env python3
"""Exact detection (``ops.detect.find_stars`` in 'exact' mode) timed on
one GPU at the unfused cell's own call, beside its bound and its plain
twin.

Cases (``--only`` picks some):

* ``cell``: the ``unfused-16mpix-n24.dither`` cell's call: its 24 x
  4096^2 raw stack made from ``--seed`` by the benchmark's generator,
  calibrated and measured for noise as ``calibrate_register_stack`` does,
  then ``find_stars`` as ``detect_calibrated`` calls it (FWHM 3, 48 stars
  at 7 sigma, no statistics, the noise centres as floors);
* ``single``: ``core/star_finder``'s call on frame 0 of that stack: 1024
  stars, statistics on, a mask of ~5 % of the pixels;
* ``radii``: 8 frames of that stack at FWHM 3 to 11.3 (radius 2 to 8),
  no statistics.

For each case: ``kernel_ms``, the kernel pair alone
(``kernels.find_exact_cuda``), and ``find_ms``, ``find_stars`` whole (the
kernel and the centroids: what the span ``apt.detect.find`` holds), each
the mean of ``--reps`` calls after a warm-up (CUDA events); ``twin_ms``,
``find_stars_plain`` (mean of ``--twin-reps``); whether the two agree bit
for bit in every ``Stars`` field; the device operations one call of each
launches (``torch.profiler``); the bound of ``stackbench.counts_find``
(each byte once at 3.35 TB/s against the operations at 67 TFLOP/s) and
the kernel over it.  The last line is the card's nvidia-smi line.

On a checkout without the kernel it times what ``find_stars`` is there
(the twin) and says so: run it from that checkout's root,
``PYTHONPATH=. python3 /path/to/tools/find_exact.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.device import card_line
from astrophotography_tpu_torch.models import pipeline as pl
from astrophotography_tpu_torch.ops import detect as dt
from astrophotography_tpu_torch.ops.calibrate import calibrate_batch
from chip_smoke import _time_ms as time_ms
from stackbench import counts, counts_find
from stackbench.registry import Registry
from stackbench.run import pipeline_config

HAS_KERNEL = hasattr(kernels, "find_exact_cuda")
CELL = "unfused-16mpix-n24.dither"
RADII_FWHM = (3.0, 4.0, 5.5, 7.0, 8.5, 9.3, 11.3)


def cell_stack(seed: int, dev):
    """The cell's calibrated stack, its noise (centre, std) and config."""
    reg = Registry.load()
    cell = reg.cell(CELL)
    config = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    obs = reg.generator(mix["generator"]).inputs(config, mix, seed, dev)
    cfg = pipeline_config(config)
    cal = calibrate_batch(obs.frames, obs.bias, obs.dark, obs.flat,
                          obs.exp_ratios,
                          dark_still_biased=cfg.dark_still_biased)
    del obs
    center, std = pl.frame_noise_stats(cal, center=cfg.noise_center)
    return cal, center, std, cfg


def same_bits(a, b) -> bool:
    for x, y in zip(a, b):
        if x.dtype == torch.bool:
            if not torch.equal(x, y):
                return False
            continue
        nx, ny = torch.isnan(x), torch.isnan(y)
        if not (torch.equal(nx, ny) and torch.equal(
                torch.where(nx, 0.0, x).view(torch.int32),
                torch.where(ny, 0.0, y).view(torch.int32))):
            return False
    return True


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) one call launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def case(label, data, kw, reps, twin_reps, card) -> dict:
    fwhm, k = kw["fwhm"], kw["max_stars"]
    n, h, w = data.shape if data.dim() == 3 else (1, *data.shape)
    n_bytes, n_ops = counts_find.find_exact(n, h, w, fwhm, k)
    bound = counts.bound_s(n_bytes, n_ops) * 1e3
    res = {"case": label, "shape": [n, h, w], "fwhm": fwhm,
           "radius": dt._kernel_radius(fwhm), "max_stars": k,
           "stats": kw["stats"], "mask": kw.get("mask") is not None,
           "bound_ms": bound,
           "bound_by": "bytes" if n_bytes / counts.PEAK_BYTES_S
           >= n_ops / counts.PEAK_F32_S else "operations",
           "kernel": HAS_KERNEL, "card": card}
    if HAS_KERNEL:
        kernel, foot, r = dt.daofind_kernel(fwhm)
        res["route"] = dt._find_route(data.shape, k, "global", "exact",
                                      kernel, foot, r)
        batch = data if data.dim() == 3 else data[None]
        thr = dt._per_frame(kw["threshold"], n, data.device)

        def pair():
            return kernels.find_exact_cuda(batch, kernel, r, thr,
                                           kw.get("mask"), k, 2,
                                           kw["stats"])

        kernels.reset_launch_counts()
        res["kernel_ms"] = time_ms(pair, reps)
        res["kernel_over_bound"] = res["kernel_ms"] / bound
        res["kernel_device_ops"] = device_ops(pair)
    res["find_ms"] = time_ms(lambda: dt.find_stars(data, **kw), reps)
    res["find_device_ops"] = device_ops(lambda: dt.find_stars(data, **kw))
    if HAS_KERNEL:
        kernels.reset_launch_counts()
        got = dt.find_stars(data, **kw)
        res["launches_a_call"] = dict(kernels.launch_counts)
        res["twin_ms"] = time_ms(lambda: dt.find_stars_plain(data, **kw),
                                 twin_reps)
        res["twin_device_ops"] = device_ops(
            lambda: dt.find_stars_plain(data, **kw))
        want = dt.find_stars_plain(data, **kw)
        torch.cuda.synchronize()
        res["twin_bit_for_bit"] = same_bits(got, want)
        res["valid_stars"] = int(got.valid.sum())
        del got, want
    torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=["cell", "single", "radii"])
    ap.add_argument("--seed", type=int, default=2**31 + 22)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--twin-reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tools/find_exact.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    cal, center, std, cfg = cell_stack(args.seed, dev)
    if "cell" in args.only:
        case("cell", cal, dict(fwhm=cfg.fwhm,
                               threshold=cfg.detect_nsigma * std,
                               max_stars=cfg.max_stars, stats=False,
                               floor=center),
             args.reps, args.twin_reps, card)
    if "single" in args.only:
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        mask = torch.rand(cal.shape[1:], generator=gen, device=dev) < 0.05
        frame = cal[0] - center[0]
        case("single", frame, dict(fwhm=cfg.fwhm,
                                   threshold=float(cfg.detect_nsigma
                                                   * std[0]),
                                   max_stars=1024, stats=True, mask=mask),
             args.reps, args.twin_reps, card)
        del frame, mask
    if "radii" in args.only:
        sub = cal[:8].contiguous()
        for fwhm in RADII_FWHM:
            case(f"radius {dt._kernel_radius(fwhm)}", sub,
                 dict(fwhm=fwhm, threshold=cfg.detect_nsigma * std[:8],
                      max_stars=cfg.max_stars, stats=False,
                      floor=center[:8]),
                 max(3, args.reps // 4), 1, card)
    print(json.dumps({"nvidia_smi": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
