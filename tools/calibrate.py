#!/usr/bin/env python3
"""Calibration (``ops.calibrate.calibrate_batch``) timed on one GPU at the
unfused cell's own call, beside its bound and its plain twin.

Cases (``--only`` picks some):

* ``cell``: the ``unfused-16mpix-n24.dither`` cell's call: its 24 x
  4096^2 uint16 stack and masters made from ``--seed`` by the benchmark's
  generator, exposure ratio 0.5, the dark still biased;
* ``f32``: the same stack as float32 (the kernel's float32 instance);
* ``ragged``: 24 frames of 4095 x 4097 cut from it (H * W not a multiple
  of 8: the scalar kernel).

For each case: ``kernel_ms``, ``calibrate_batch`` on the card (one
launch), the mean of ``--reps`` back-to-back calls after a warm-up (CUDA
events); ``twin_ms``, ``calibrate_batch_plain`` (mean of
``--twin-reps``); whether the two agree bit for bit (NaNs in place); the
device operations one call of each launches (``torch.profiler``); the
memory each call adds to what its inputs hold (the peak less the
allocated before); the bound of ``stackbench.counts_calibrate`` (each
byte once at 3.35 TB/s against the operations at 67 TFLOP/s) and the
kernel over it.  The last line is the card's nvidia-smi line.

On a checkout without the kernel it times what ``calibrate_batch`` is
there (the twin) and says so: run it from that checkout's root,
``PYTHONPATH=. python3 /path/to/tools/calibrate.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.device import card_line, to_float32
from astrophotography_tpu_torch.ops import calibrate as cb
from chip_smoke import _time_ms as time_ms
from stackbench import counts, counts_calibrate
from stackbench.registry import Registry
from stackbench.run import pipeline_config

HAS_KERNEL = hasattr(kernels, "calibrate_cuda")
CELL = "unfused-16mpix-n24.dither"


def same_bits(x, y) -> bool:
    nx, ny = torch.isnan(x), torch.isnan(y)
    return bool(torch.equal(nx, ny) and torch.equal(
        torch.where(nx, 0.0, x).view(torch.int32),
        torch.where(ny, 0.0, y).view(torch.int32)))


def device_ops(fn) -> int:
    """Device operations (kernels, copies, fills) one call launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def added_bytes(fn) -> int:
    """The device memory one call holds at its peak beyond what was
    allocated before it (its result included)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def case(label, imgs, kw, reps, twin_reps, card) -> dict:
    n, h, w = imgs.shape
    n_bytes, n_ops = counts_calibrate.calibrate(n, h, w,
                                                imgs.element_size())
    bound = counts.bound_s(n_bytes, n_ops) * 1e3
    res = {"case": label, "shape": [n, h, w], "dtype": str(imgs.dtype),
           "bound_ms": bound,
           "bound_by": "bytes" if n_bytes / counts.PEAK_BYTES_S
           >= n_ops / counts.PEAK_F32_S else "operations",
           "kernel": HAS_KERNEL, "card": card}

    def call():
        return cb.calibrate_batch(imgs, **kw)

    ms = time_ms(call, reps)
    res["calibrate_batch_ms"] = ms
    res["calibrate_batch_over_bound"] = ms / bound
    res["calibrate_batch_device_ops"] = device_ops(call)
    res["calibrate_batch_added_bytes"] = added_bytes(call)
    if HAS_KERNEL:
        res["kernel_ms"] = ms
        kernels.reset_launch_counts()
        got = call()
        res["launches_a_call"] = {k: v for k, v in
                                  kernels.launch_counts.items() if v}

        def twin():
            return cb.calibrate_batch_plain(imgs, **kw)

        res["twin_ms"] = time_ms(twin, twin_reps)
        res["twin_device_ops"] = device_ops(twin)
        res["twin_added_bytes"] = added_bytes(twin)
        want = twin()
        torch.cuda.synchronize()
        res["twin_bit_for_bit"] = same_bits(got, want)
        del got, want
    torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=["cell", "f32", "ragged"])
    ap.add_argument("--seed", type=int, default=2**31 + 24)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--twin-reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tools/calibrate.py needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    reg = Registry.load()
    cell = reg.cell(CELL)
    config = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    obs = reg.generator(mix["generator"]).inputs(config, mix, args.seed, dev)
    kw = dict(bias=obs.bias, dark=obs.dark, flat=obs.flat,
              exp_ratios=obs.exp_ratios,
              dark_still_biased=pipeline_config(config).dark_still_biased)
    if "cell" in args.only:
        case("cell", obs.frames, kw, args.reps, args.twin_reps, card)
    if "f32" in args.only:
        case("f32", to_float32(obs.frames), kw, args.reps, args.twin_reps,
             card)
    if "ragged" in args.only:
        h, w = obs.frames.shape[1] - 1, obs.frames.shape[2] + 1
        sub = obs.frames.reshape(-1)[:obs.frames.shape[0] * h * w] \
            .view(-1, h, w)
        rkw = dict(kw, **{k: kw[k].reshape(-1)[:h * w].view(h, w)
                          for k in ("bias", "dark", "flat")})
        case("ragged", sub, rkw, args.reps, args.twin_reps, card)
    print(json.dumps({"nvidia_smi": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
