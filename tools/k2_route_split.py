#!/usr/bin/env python3
"""K2's two routes on the same stacks, on one GPU.

Up to 908 frames K2 keeps each pixel's N samples in shared memory (the
'smem' route, as many rows of 32 pixels per block as fit: at span 8,
8 rows to 216 frames, 4 at 350, 2 at 585, 1 from 879); past it, in a
scratch of device memory (the 'global' route, 8 rows, the grid of
resident blocks walking the output).  Shared memory would still hold one row's columns up to
1759 frames at the lean snap window.  This script launches both routes
directly (``warp_combine_launch``, with and without a scratch) on
chip_smoke.py's snap workload made on the card (512^2, the lean snap
configuration: span 8, budget 8, lowrank taps, 'average') at 200, 400,
600, 908, 909, 1200 and 1700 frames, in turns (smem, global, global,
smem), checks that the two images are equal bit for bit, and prints which
route the wrapper picks.

Run from the repository root: ``PYTHONPATH=. python3 tools/k2_route_split.py``.
Prints one JSON line per frame count, then the card's nvidia-smi line.
"""

from __future__ import annotations

import ctypes
import json

import numpy as np
import torch

import chip_smoke as cs
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import warp_combine as wc

FRAMES = (200, 400, 600, 908, 909, 1200, 1700)
SIZE = 512


def _smem_rows(n: int, span: int) -> int:
    """The most rows (<= 8) of a shared-route block with ``n`` columns."""
    return max((r for r in range(1, 9)
                if kernels._warp_smem_bytes(n, r, span) <= kernels._SMEM_MAX),
               default=0)


def main() -> int:
    dev = torch.device("cuda")             # raises without a usable card
    card = cs.card_line()
    lib = kernels._load()["warp_combine"]
    cfg = cs.lean_config(False)
    for n in FRAMES:
        fr, bias, dark, flat, exp_ratio, _off, mats = \
            cs.make_workload_on_device(n, SIZE, dev)
        er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
        masters = cs._masters(bias, dark, flat, dev)[0]
        plan = wc.plan_warp_combine(
            fr.shape, torch.from_numpy(mats.astype(np.float32)).to(dev), er,
            span=cfg.warp_span, apron=True, dither_budget=cfg.dither_budget,
            general_taps=cfg.general_taps)
        rows = _smem_rows(n, plan.span)
        grows = kernels._WARP_MAX_ROWS
        blocks = (plan.n_tj * -(-plan.tw // kernels._WARP_BX)
                  * plan.n_ti * -(-plan.th // grows))
        grid = min(blocks, kernels._resident_blocks("warp_combine", dev, 1,
                                                     plan.span, grows))
        scratch = torch.empty(
            (kernels._warp_scratch_bytes(n, grows, grid) // 4,), device=dev)
        outs = {}

        def launcher(name, by, scr, nblk):
            out = outs[name] = torch.empty((SIZE, SIZE), device=dev)

            def go():
                err = lib.warp_combine_launch(
                    kernels._ptr(fr), 1, kernels._ptr(masters),
                    kernels._ptr(plan.table), kernels._ptr(plan.tiles),
                    kernels._ptr(out), n, SIZE, SIZE, plan.th, plan.tw,
                    plan.n_ti, plan.n_tj, plan.span, 1, 0, 5.0, 5.0, by,
                    kernels._ptr(scr), nblk,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return go

        order = [(f"smem ({rows} rows)", launcher("smem", rows, None, 0)),
                 (f"global ({grows} rows)",
                  launcher("global", grows, scratch, grid))]
        for _k, fn in order:
            fn()
        torch.cuda.synchronize()
        a, b = outs["smem"], outs["global"]
        ms = {k: [] for k, _fn in order}
        for k, fn in order + order[::-1]:
            ms[k].append(cs._time_ms(fn, 3))
        print(json.dumps({
            "frames": n, "shape": [n, SIZE, SIZE], "span": plan.span,
            "wrapper_route": kernels._warp_route(n, plan.span),
            "global_grid": grid,
            "equal": bool(torch.equal(a, b)),
            "max_abs_diff": float((a - b).abs().max()), "ms": ms,
            "ns_per_frame_pixel": {k: min(v) * 1e6 / fr.numel()
                                   for k, v in ms.items()},
            "card": card}), flush=True)
        del fr, masters, scratch, outs, a, b
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
