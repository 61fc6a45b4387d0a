#!/usr/bin/env python3
"""K2's 'wide' route and K3's 'select' route timed at the sizes their
users run, on one GPU.

K2 'wide' (``kernels.warp_combine_cuda``, 'exact' body, combine
'average' and, for the warp phase alone, 'mean', in turns average,
mean, mean, average as chip_smoke.py's ``k2_split`` times them), each
case uint16 with bias, dark and flat masters, the field turning about
the centre from 0 to the case's angle over the stack (+-4 px dithers):

* ``pipeline``: 24 x 2048^2, 0-12 deg (chip_smoke.py's
  ``make_field_rotation``), span 256, tile (320, 1024), dither budget 256,
  as the wide phase's pipeline runs it;
* ``lean size``: 100 x 4096^2 made on the card
  (``make_workload_on_device(100, 4096)``) under 0-12 deg matrices, span
  256, tile (320, 1024), dither budget 256 (every (frame, tile) pair of the
  plan is used at that span);
* ``alt-az hour``: 360 x 2048^2 made on the card under 0-15 deg
  matrices (360 subs of 10 s), span 288, tile (320, 1024), dither budget
  256 (at span 256 a tenth of the (frame, tile) pairs fail the gate).

K3 'select' (``kernels.clip_combine_cuda``) on chip_smoke.py's masked
stack made on the card (``_clip_inputs_chunked``: 20 % masked, 2 %
outliers at 40000, every 97th row fully masked): 30000 x 480 x 640 (a
planetary lucky-imaging run) and 29025 x 256 x 512 (the first count past
the 'cols' route's reach).  Where one call of the whole stack would take
more than ``--band-limit-s`` (estimated from a band of ``--band-rows``
rows), the band's time is scaled to the whole stack and the line says
so (``scaled_from_rows``).

Every case prints one JSON line with the route the launcher takes, the
mean ms of ``--reps`` calls after a warm-up (CUDA events) and the bound
as chip_smoke.py counts it (``_k2_wide_bound``; ``check_clip``'s each
byte once against (5 + log2 N) operations per sample), then the card's
nvidia-smi line.

The script imports only what the port has had since the 'wide' route
came in, so it times an older checkout as well: run it from the root of
that checkout, ``PYTHONPATH=. python3 /path/to/tools/tail_routes.py``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.device import card_line
from astrophotography_tpu_torch.ops import warp_combine as wc

#: (label, frames, size, degrees, span, made on the card)
K2_CASES = (("pipeline", 24, 2048, 12.0, 256, False),
            ("lean size", 100, 4096, 12.0, 256, True),
            ("alt-az hour", 360, 2048, 15.0, 288, True))
K2_TILE, K2_BUDGET = (320, 1024), 256
#: (label, frames, rows, columns)
K3_CASES = (("lucky imaging", 30000, 480, 640),
            ("reach", 29025, 256, 512))


def rotation_mats(n: int, size: int, max_deg: float, seed: int = 0):
    """Frame i turned by max_deg * i / (n - 1) about the centre and
    dithered by up to 4 px (frame 0 the identity), as
    chip_smoke.make_field_rotation draws them."""
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


def k2_case(label, n, size, deg, span, on_card, reps, card, dev) -> dict:
    if on_card:
        fr, bias, dark, flat, exp_ratio, _off, _m = \
            cs.make_workload_on_device(n, size, dev, seed=6)
        mats = rotation_mats(n, size, deg)
    else:
        frames, bias, dark, flat, exp_ratio, _off, mats = \
            cs.make_field_rotation(n, size, deg)
        fr = torch.from_numpy(frames).to(dev)
        del frames
    masters = cs._masters(bias, dark, flat, dev)[0]
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    m = torch.from_numpy(mats.astype(np.float32)).to(dev)
    plan = wc.plan_warp_combine(fr.shape, m, er, span=span, tile=K2_TILE,
                                dither_budget=K2_BUDGET,
                                general_taps="exact")
    used = float(((plan.tiles[:, :, 2] > 0)
                  & ((plan.table[:, 14, None] > 0.5)
                     | (plan.table[:, 8, None] > 0.5))).float().mean())

    def call(combine):
        return lambda: kernels.warp_combine_cuda(fr, masters, plan, combine,
                                                 False, 5.0, 5.0)

    route = kernels._warp_route(n, plan.span)
    before = kernels.warp_route_counts.get("wide", 0)
    times = {"average": [], "mean": []}
    for c in ("average", "mean", "mean", "average"):
        times[c].append(cs._time_ms(call(0 if c == "average" else 3), reps))
    avg, mean = (sum(times[c]) / 2 for c in ("average", "mean"))
    bound = cs._k2_wide_bound(fr, masters, plan, "exact")
    res = {"kernel": "K2", "case": label, "shape": [n, size, size],
           "degrees": deg, "span": plan.span, "tile": list(K2_TILE),
           "dither_budget": K2_BUDGET, "frame_tile_pairs_used": used,
           "route": route,
           "wide_launches": kernels.warp_route_counts.get("wide", 0) - before,
           "block_rows": kernels._warp_block_rows(n, plan.span, route),
           "ms": avg, "average_ms": times["average"],
           "mean_ms": times["mean"], "warp_phase_ms": mean,
           "combine_ms": avg - mean, **bound,
           "over_bound": avg / bound["bound_ms"], "reps": reps, "card": card}
    del fr, masters, plan
    torch.cuda.empty_cache()
    return res


def k3_case(label, n, h, w, reps, band_rows, limit_s, card, dev) -> dict:
    t0 = time.perf_counter()
    stack, mask = cs._clip_inputs_chunked(n, h, w, dev, seed=13)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    route = kernels._clip_route(n)
    bound = cs._bound(cs._nbytes(stack, mask) + 4 * h * w,
                      stack.numel() * (5 + math.log2(n)))
    sb, mb = (t[:, :band_rows].contiguous() for t in (stack, mask))
    band_ms = cs._time_ms(
        lambda: kernels.clip_combine_cuda(sb, mb, 5.0, 5.0), 1)
    del sb, mb
    est_s = band_ms * h / band_rows / 1e3
    scaled = est_s > limit_s
    if scaled:
        ms = band_ms * h / band_rows
    else:
        ms = cs._time_ms(
            lambda: kernels.clip_combine_cuda(stack, mask, 5.0, 5.0),
            reps if est_s < 2.0 else 1)
    res = {"kernel": "K3", "case": label, "shape": [n, h, w],
           "masked": True, "route": route, "ms": ms,
           "band_rows": band_rows, "band_ms": band_ms,
           "scaled_from_rows": band_rows if scaled else None, **bound,
           "over_bound": ms / bound["bound_ms"],
           "workload_gen_s": gen_s, "card": card}
    del stack, mask
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--only", choices=("K2", "K3"))
    ap.add_argument("--band-rows", type=int, default=8)
    ap.add_argument("--band-limit-s", type=float, default=60.0)
    ap.add_argument("--ptxas", help="write ptxas' report of K2 and K3 "
                    "(registers, spills) to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tail_routes.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    kernels._load()
    if args.ptxas:
        rep = kernels.build_info.get("ptxas", {})
        with open(args.ptxas, "w") as fh:
            for name in ("warp_combine", "clip_combine"):
                fh.write(f"== {name}\n{rep.get(name, '(already built)')}\n")
    if args.only in (None, "K2"):
        for case in K2_CASES:
            print(json.dumps(k2_case(*case, args.reps, card, dev)),
                  flush=True)
    if args.only in (None, "K3"):
        for case in K3_CASES:
            print(json.dumps(k3_case(*case, args.reps, args.band_rows,
                                     args.band_limit_s, card, dev)),
                  flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
