#!/usr/bin/env python3
"""The plain separable warp (``ops.warp.warp_affine_separable``) timed on
one GPU at the sizes the unfused path runs, beside its bound, the compute
floor of its op-by-op arithmetic and its plain twin.

Each case warps a float32 stack made on the card from a seed (a sky of
800 ADU with noise) by similarity matrices drawn from a seed (frame 0
the identity), onto one output band given by
``models.pipeline.band_matrices``, as ``warp_band`` calls it:

* ``cell band``: band 0 of the ``unfused-16mpix-n24.dither`` cell, 24 x
  2048 x 4096 out of a 24 x 4096^2 stack, span 12, analytic coverage,
  +-4 px dithers and turns of +-0.01 deg (what the cell's solves give);
* ``span 256``: 24 x 1024 x 2048 out of a 24 x 2048^2 stack, span 256,
  analytic coverage, turns of 0-5 deg (a window for field rotation);
* ``sweep``: 24 x 512 x 4096 out of 24 x 1024 x 4096 at spans 12 to 256,
  where the route rule's crossing (``kernels._SEP_SMEM_MAX_SPAN``) is
  read.

For each case and each route the kernel can take ('smem' with the tile
the rule picks, 'scratch'): the mean ms of ``--reps`` calls after a
warm-up (CUDA events) and whether it is the twin's output bit for bit.
Then the twin's ms (one call), the bound of ``stackbench.counts.warp``
(each byte once at 3.35 TB/s against 24 operations a pixel at 67
TFLOP/s) and ``floor_ms``: the twin's arithmetic (~26 operations a shift
in each pass, over the band + span mid rows each band computes) at one
unfused float32 operation a lane a clock (33.5 T/s on 132 SMs).  The
kernel evaluates the polynomial only inside the kernel's support, so it
may run under that floor.  The last line is the card's nvidia-smi line.

On a checkout without the kernel it times what ``warp_affine_separable``
is there (the twin) and says so: run it from that checkout's root,
``PYTHONPATH=. python3 /path/to/tools/warp_separable.py``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.device import card_line
from astrophotography_tpu_torch.models.pipeline import band_matrices
from astrophotography_tpu_torch.ops import warp as wp
from chip_smoke import _time_ms as time_ms
from stackbench import counts

HAS_KERNEL = hasattr(kernels, "warp_separable_cuda")
#: the twin's operations a shift (argument, square, 10 Horner steps of a
#: multiply and an add, the test, the product, two sums)
TWIN_OPS_PER_SHIFT = 26
#: one unfused float32 operation a lane a clock (FMA counted as two
#: operations in PEAK_F32_S)
OPS_S = counts.PEAK_F32_S / 2
SWEEP_SPANS = (12, 24, 48, 64, 96, 128, 256)


def matrices(n: int, seed: int, max_deg: float, shift: float = 4.0):
    rng = np.random.default_rng(seed)
    th = np.deg2rad(rng.uniform(-max_deg, max_deg, n))
    t = rng.uniform(-shift, shift, (n, 2))
    th[0], t[0] = 0.0, 0.0
    c, s = np.cos(th), np.sin(th)
    return torch.from_numpy(np.stack(
        [np.stack([c, -s, t[:, 0]], 1), np.stack([s, c, t[:, 1]], 1)],
        1).astype(np.float32))


def stack(n: int, h: int, w: int, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    for f in range(n):
        out[f] = 800.0 + 8.0 * torch.randn((h, w), generator=gen, device=dev)
    return out


def same_bits(a, b) -> bool:
    return all(torch.equal(torch.isnan(x), torch.isnan(y)) and torch.equal(
        torch.where(torch.isnan(x), 0.0, x).view(torch.int32),
        torch.where(torch.isnan(y), 0.0, y).view(torch.int32))
        for x, y in zip(a, b))


def case(label, n, h, w, rows, span, max_deg, reps, twin, card, dev):
    imgs = stack(n, h, w, seed=span, dev=dev)
    mats = band_matrices(matrices(n, seed=n + span, max_deg=max_deg)
                         .to(dev), 0.0)
    out_shape = (rows, w)
    kw = dict(span=span, analytic_coverage=True)
    n_bytes, n_ops = counts.warp(n, rows, w)
    bound = counts.bound_s(n_bytes, n_ops) * 1e3
    band = min(64, h, rows)
    mid_rows = -(-rows // band) * (band + span)
    floor_ops = n * w * TWIN_OPS_PER_SHIFT * span * (rows + mid_rows)
    res = {"case": label, "shape": [n, h, w], "out": [n, rows, w],
           "span": span, "max_deg": max_deg, "bound_ms": bound,
           "bound_by": "bytes" if n_bytes / counts.PEAK_BYTES_S
           >= n_ops / counts.PEAK_F32_S else "operations",
           "floor_ms": floor_ops / OPS_S * 1e3, "kernel": HAS_KERNEL,
           "reps": reps, "card": card}
    want = wp.warp_affine_separable_plain(imgs, mats, out_shape, **kw) \
        if HAS_KERNEL else None
    if HAS_KERNEL:
        band_, pad, pad_t = wp._separable_geometry(h, out_shape, 64, span,
                                                   None)
        rule = kernels._warp_separable_route(band_, span, 1)
        res.update(route=rule, tile=kernels._warp_separable_tile(band_, span,
                                                                 1))
        for route in ("smem", "scratch"):
            if route == "smem" and not res["tile"]:
                continue

            def call(route=route):
                return kernels.warp_separable_cuda(
                    imgs, mats, out_shape, band_, span, True, None, pad,
                    pad_t, route=route)

            ms = time_ms(call, reps)
            got = call()
            res[f"{route}_ms"] = ms
            res[f"{route}_bits_equal"] = same_bits(got, want)
            res[f"{route}_over_bound"] = ms / bound
            del got
        res["ms"] = res[f"{rule}_ms"]
    else:
        res["ms"] = time_ms(
            lambda: wp.warp_affine_separable(imgs, mats, out_shape, **kw), 1)
    if twin:
        res["twin_ms"] = time_ms(
            lambda: wp.warp_affine_separable_plain(imgs, mats, out_shape,
                                                   **kw), 1) \
            if HAS_KERNEL else res["ms"]
    del imgs, want
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--only", choices=("cell", "span256", "sweep"))
    ap.add_argument("--ptxas", help="write ptxas' report of the kernel "
                    "(registers, spills) to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("warp_separable.py: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    kernels._load()
    if args.ptxas:
        with open(args.ptxas, "w") as fh:
            fh.write(kernels.build_info.get("ptxas", {}).get(
                "warp_separable", "(already built)") + "\n")
    lines = []
    if args.only in (None, "cell"):
        lines.append(("cell band", 24, 4096, 4096, 2048, 12, 0.01, True))
    if args.only in (None, "span256"):
        lines.append(("span 256", 24, 2048, 2048, 1024, 256, 5.0, True))
    if args.only in (None, "sweep") and HAS_KERNEL:
        lines += [("sweep", 24, 1024, 4096, 512, s, 0.01, False)
                  for s in SWEEP_SPANS]
    for label, n, h, w, rows, span, deg, twin in lines:
        print(json.dumps(case(label, n, h, w, rows, span, deg, args.reps,
                              twin, card, dev)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
