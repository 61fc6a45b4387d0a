#!/usr/bin/env python3
"""Where K2's 'wide' route spends its warp phase, on one GPU.

Compiles edited copies of ``astrophotography_tpu_torch/csrc/warp_combine.cu``
and times each one's 'wide' kernel with ``combine='mean'`` (the warp
phase alone: no sort, no clip) and ``'average'`` on tools/tail_routes.py's
three field-rotation cases ('exact': 24 x 2048^2 and 100 x 4096^2 at
span 256, 360 x 2048^2 at span 288), in turns on one card:

* ``base``: the source as it is;
* ``one_block``: ``__launch_bounds__(256, 1)`` (no spills, one block an
  SM);
* ``serial_taps``: the 'exact' passes' taps one after another (a loop
  that skips a zero weight), not eight weights side by side;
* ``three_blocks``: ``__launch_bounds__(256, 3)`` (85 registers, three
  blocks an SM);
* ``no_vertical`` / ``no_horizontal``: that pass left out (wrong images;
  the time of the rest).

Prints ptxas' registers and spills of each variant's kernels, then one
JSON line per case with the mean ms of each variant (CUDA events), and
the card's nvidia-smi line.  The edits are anchored on lines of the
source and fail loudly when the source no longer has them.

Run from the repository root: ``PYTHONPATH=. python3 tools/wide_variants.py``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import warp_combine as wc

sys.path.insert(0, str(Path(__file__).resolve().parent))
from tail_routes import K2_BUDGET, K2_TILE, rotation_mats  # noqa: E402

SRC = Path("astrophotography_tpu_torch/csrc/warp_combine.cu")
OUT = Path("build/wide_variants")
CASES = (("pipeline", 24, 2048, 12.0, 256), ("lean size", 100, 4096, 12.0, 256),
         ("alt-az hour", 360, 2048, 15.0, 288))


def _rep(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"anchor not in {SRC}: {old!r}")
    return text.replace(old, new, 1)


def _variants(src: str) -> dict:
    one_block = _rep(src, "__global__ void __launch_bounds__(BX * WIDE_WARPS, 2)",
                     "__global__ void __launch_bounds__(BX * WIDE_WARPS, 1)")
    no_vertical = _rep(src, "    const float* mid = midb;\n"
                            "    auto run = [&](auto K) {\n"
                            "      constexpr int kind = decltype(K)::value;\n"
                            "      float vw[HT];",
                       "    const float* mid = midb;\n"
                       "    if (f >= 0) return;\n"
                       "    auto run = [&](auto K) {\n"
                       "      constexpr int kind = decltype(K)::value;\n"
                       "      float vw[HT];")
    no_horizontal = _rep(src, "    if (qlo > qhi || qhi - qlo < wp) return;",
                         "    if (qlo >= -1) return;")
    serial_taps = _rep(src, """  float w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q)
    w[q] = lo + q <= hi ? l3(t - (float)(b + lo + q)) : 0.0f;
  float acc = 0.0f, wsum = 0.0f;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    if (lo + q <= hi && w[q] != 0.0f) {
      acc = add(acc, mul(w[q], at(lo + q)));
      wsum = add(wsum, w[q]);
    }""", """  float acc = 0.0f, wsum = 0.0f;
  for (int s = lo; s <= hi; ++s) {
    const float wt = l3(t - (float)(b + s));
    if (wt == 0.0f) continue;
    acc = add(acc, mul(wt, at(s)));
    wsum = add(wsum, wt);
  }""")
    three_blocks = _rep(
        src, "__global__ void __launch_bounds__(BX * WIDE_WARPS, 2)",
        "__global__ void __launch_bounds__(BX * WIDE_WARPS, 3)")
    return {"base": src, "serial_taps": serial_taps,
            "three_blocks": three_blocks,
            "one_block": one_block,
            "no_vertical": no_vertical, "no_horizontal": no_horizontal}


def _build(sources: dict) -> dict:
    """{name: loaded library}, one nvcc each, all at once; prints each
    one's wide kernels' registers and spills."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{err}")
        lines = err.splitlines()
        for k, line in enumerate(lines):
            m = re.search(r"warp_combine_wide_kernelI(\w)Li(\d)", line)
            if m and "Compiling entry" in line:
                spill = lines[k + 2].strip()
                regs = lines[k + 3].strip()
                print(json.dumps({"variant": name, "kernel": m.group(0)[-7:],
                                  "spills": spill, "registers": regs}))
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.warp_combine_wide_launch.argtypes = [
            p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f, i, p, i, i, p]
        lib.warp_combine_wide_blocks.argtypes = [i, i, i, i, i]
        libs[name] = lib
    return libs


def main() -> int:
    dev = torch.device("cuda")             # raises without a usable card
    card = cs.card_line()
    libs = _build(_variants(SRC.read_text()))
    for label, n, size, deg, span in CASES:
        fr, bias, dark, flat, exp_ratio, _o, _m = \
            cs.make_workload_on_device(n, size, dev, seed=6)
        masters = cs._masters(bias, dark, flat, dev)[0]
        er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
        mats = torch.from_numpy(rotation_mats(n, size, deg)
                                .astype(np.float32)).to(dev)
        plan = wc.plan_warp_combine(fr.shape, mats, er, span=span,
                                    tile=K2_TILE, dither_budget=K2_BUDGET)
        rows = kernels._warp_block_rows(n, plan.span, "wide")
        run = kernels._warp_cols_run(kernels._WARP_WIDE_WARPS, plan.span)
        blocks = plan.n_tj * -(-plan.tw // 32) * plan.n_ti * -(-plan.th // rows)
        out = torch.empty((size, size), device=dev)

        def launcher(lib, combine):
            with torch.cuda.device(dev):
                resident = lib.warp_combine_wide_blocks(1, min(n, run), plan.span,
                                                        rows, run)
            grid = kernels._warp_wide_grid(n, rows, blocks, resident)
            scratch = torch.empty((kernels._warp_scratch_bytes(n, rows, grid)
                                   // 4,), device=dev)

            def go():
                err = lib.warp_combine_wide_launch(
                    kernels._ptr(fr), 1, kernels._ptr(masters),
                    kernels._ptr(plan.table), kernels._ptr(plan.tiles),
                    kernels._ptr(out), n, size, size, plan.th, plan.tw,
                    plan.n_ti, plan.n_tj, plan.span, 0, combine, 5.0, 5.0, rows,
                    kernels._ptr(scratch), grid, run,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return go

        for combine, cname in ((3, "mean"), (0, "average")):
            calls = {k: launcher(lib, combine) for k, lib in libs.items()}
            names = list(calls)
            times = {k: [] for k in names}
            for name in names + names[::-1]:
                times[name].append(cs._time_ms(calls[name], 3))
            print(json.dumps({"case": label, "shape": [n, size, size],
                              "span": plan.span, "combine": cname,
                              "ms": {k: sum(v) / len(v)
                                     for k, v in times.items()},
                              "ms_each": times, "card": card}), flush=True)
            del calls
        del fr, masters, out
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
