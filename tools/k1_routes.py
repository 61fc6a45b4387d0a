#!/usr/bin/env python3
"""K1's time at every filter radius the lean path can take, on one GPU.

Makes chip_smoke.py's observing run on the card (uint16 frames with
bias, dark and flat masters, +-4 px dithers, 40 stars) and times K1
(``ops.detect_tiles.detect_tiles``) on it with the masters at each FWHM
asked for: the mean device time of ``--reps`` back-to-back calls after a
warm-up (CUDA events), the route the launcher takes, and K1's bound as
chip_smoke.py's ``check_detect`` counts it (each input and output byte
once at 3.35 TB/s against 3 (2r + 1) + 9.5 operations per raw pixel at
67 TFLOP/s, the larger).  The same calls run once more under
``torch.profiler``, which splits the time by kernel name (the separable
route's column pass and its tile pass).

The script imports only what every tree of the port has had since the
separable route came in, so it times an older checkout as well: run it
from the root of that checkout with this file's path, e.g.
``PYTHONPATH=. python3 /path/to/tools/k1_routes.py``.

Defaults: FWHM 3, 4, 5, 8, 10.7, 16, 21 px (radii 2, 3, 4, 6, 8, 12, 16)
on 100 x 4096^2, then FWHM 22.7, 32, 64 px (radii 17, 24, 48) on
16 x 4096^2.  Prints one JSON line per radius, then the card's
nvidia-smi line.  chip_smoke.py's deep phase runs it with ``--frames 16
--fwhm 22.7 32 64`` for the separable route's split.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import torch

import chip_smoke as cs
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.device import card_line
from astrophotography_tpu_torch.ops import detect_tiles as dt
from bench_torch import lean_config

#: (frames, size, FWHMs): the lean path's radii on its stack, and the
#: separable route's on deep's 16 x 4096^2
GROUPS = ((100, 4096, (3.0, 4.0, 5.0, 8.0, 10.7, 16.0, 21.0)),
          (16, 4096, (22.7, 32.0, 64.0)))


def _device_us(evt) -> float:
    """An averaged profiler event's device time in us (the attribute's
    name differs between PyTorch releases)."""
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def kernel_split(fn, reps: int) -> dict:
    """{kernel name: mean device ms per call of fn} from torch.profiler
    over ``reps`` calls (kernels named ``detect_*`` only)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        m = re.search(r"detect_\w+_kernel", evt.key)
        if m:
            out[m.group(0)] = (out.get(m.group(0), 0.0)
                               + _device_us(evt) / 1e3 / reps)
    return out


def time_group(n: int, size: int, fwhms, reps: int, card: str, dev) -> list:
    fr, bias, dark, flat, exp_ratio, _off, _mats = \
        cs.make_workload_on_device(n, size, dev, seed=3)
    masters, b_t, du_t, f_t = cs._masters(bias, dark, flat, dev)
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    # the lean path's threshold: nsigma x the workload's 8 ADU noise
    thr = torch.full((n,), lean_config(False).detect_nsigma * 8.0,
                     device=dev)
    rows = []
    for fwhm in fwhms:
        r = dt._kernel_params(fwhm)[1]
        mf = dt.master_densities(b_t, du_t, f_t, fwhm=fwhm)

        def call():
            return dt.detect_tiles(fr, thr, mf_bc=mf, a_plane=masters[0],
                                   exp_ratios=er, fwhm=fwhm)

        ms = cs._time_ms(call, reps)
        split = kernel_split(call, reps)
        k = call()
        n_bytes = cs._nbytes(fr, thr, mf, masters[0], er, *k)
        row = {"shape": [n, size, size], "fwhm": fwhm, "radius": r,
               "route": kernels._detect_route(r), "ms": ms,
               "kernel_ms": split, "reps": reps,
               "live_tiles": int((k[0] > -1e37).sum()),
               **cs._bound(n_bytes, fr.numel() * (3 * (2 * r + 1) + 9.5)),
               "card": card}
        row["ms_over_bound"] = ms / row["bound_ms"]
        print(json.dumps(row), flush=True)
        rows.append(row)
        del mf, k
    del fr, masters
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--fwhm", type=float, nargs="*",
                    help="time these FWHMs on --frames x --size^2 only")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--size", type=int, default=4096)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_routes: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    kernels._load()
    groups = GROUPS if not args.fwhm else (
        (args.frames, args.size, tuple(args.fwhm)),)
    for n, size, fwhms in groups:
        time_group(n, size, fwhms, args.reps, card, dev)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
