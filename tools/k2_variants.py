#!/usr/bin/env python3
"""Where K2's warp phase spends its time, on one GPU.

Compiles edited copies of ``astrophotography_tpu_torch/csrc/warp_combine.cu``
and times each on chip_smoke.py's 100x4096^2 workloads (snap and rotated)
with ``combine='mean'`` (the warp phase alone), in turns on one card:

* ``base``: the source as it is;
* ``no_raw``: the raw pixels are not loaded (a constant instead);
* ``no_masters``: the masters are not loaded (calibration reads stale
  registers);
* ``no_loads``: neither;

then runs a copy instrumented with ``clock64()`` and prints, per warp of
a block, the mean cycles per frame of each step of the frame loop.  The
edited copies give wrong images; only their times mean anything.  The
edits are anchored on lines of the source and fail loudly when the
source no longer has them.

Run from the repository root: ``PYTHONPATH=. python3 tools/k2_variants.py``.
Prints one JSON line per measurement and the card's nvidia-smi line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import warp_combine as wc

SRC = Path("astrophotography_tpu_torch/csrc/warp_combine.cu")
OUT = Path("build/k2_variants")
STEPS = ("top", "stage", "horizontal", "fetch", "vertical", "ring",
         "barrier", "tail")


def _rep(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"anchor not in {SRC}: {old!r}")
    return text.replace(old, new, 1)


def _variants(src: str) -> dict:
    def no_raw(t):
        return _rep(t, "            raw[m][e] = fr[o];\n",
                    "            raw[m][e] = (T)(o & 1023);\n")

    def no_masters(t):
        return _rep(t, "            if (S.masters != nullptr) {\n"
                       "              a[m][e]",
                    "            if (false) {\n              a[m][e]")

    return {"base": src, "no_raw": no_raw(src), "no_masters": no_masters(src),
            "no_loads": no_raw(no_masters(src))}


def _profiled(src: str) -> str:
    t = _rep(src, "namespace {\n",
             "__device__ unsigned long long g_prof[128];\nnamespace {\n")
    t = _rep(t, "  int kp = OFF;  // how the block used frame f-1\n",
             "  int kp = OFF;  // how the block used frame f-1\n"
             "  long long A_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
             "  long long T_ = clock64();\n"
             "#define MARK(i) { long long t_ = clock64(); A_[i] += t_ - T_; "
             "T_ = t_; }\n")
    t = _rep(t, "    float* mid = midb + (f & 1) * wrn * BX;\n",
             "    float* mid = midb + (f & 1) * wrn * BX;\n    MARK(0)\n")
    t = _rep(t, "      __syncwarp();\n    }\n    if (k == SNAP) {",
             "      __syncwarp();\n    }\n    MARK(1)\n    if (k == SNAP) {")
    t = _rep(t, "    if (f + 1 < n) {\n      fetch(f + 1);",
             "    MARK(2)\n    if (f + 1 < n) {\n      fetch(f + 1);")
    t = _rep(t, "    if (kp == SNAP || kp == LOW) vertical(f - 1, kp);\n"
                "    if (ahead)",
             "    MARK(3)\n    if (kp == SNAP || kp == LOW) vertical(f - 1, kp);"
             "\n    MARK(4)\n    if (ahead)")
    t = _rep(t, "    __syncthreads();\n    if (k == EXACT) {",
             "    MARK(5)\n    __syncthreads();\n    MARK(6)\n"
             "    if (k == EXACT) {")
    t = _rep(t, "    kp = k;\n  }\n",
             "    kp = k;\n    MARK(7)\n  }\n"
             "  if (lane == 0) for (int q = 0; q < 8; ++q) "
             "atomicAdd(&g_prof[ty * 8 + q], (unsigned long long)A_[q]);\n"
             "  if (tid == 0) atomicAdd(&g_prof[127], 1ull);\n")
    return t + ('\nextern "C" int prof_read(unsigned long long* h) {\n'
                "  return (int)cudaMemcpyFromSymbol(h, g_prof, sizeof(g_prof));"
                "\n}\n"
                'extern "C" int prof_reset() {\n'
                "  unsigned long long z[128] = {0};\n"
                "  return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n}\n")


def _build(sources: dict) -> dict:
    """{name: loaded library}, one nvcc each, all at once."""
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
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        lib.warp_combine_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i,
                                            i, i, i, i, f, f, i, p, i, i, p]
        libs[name] = lib
    return libs


def main() -> int:
    dev = torch.device("cuda")             # raises without a usable card
    card = cs.card_line()
    src = SRC.read_text()
    libs = _build({**_variants(src), "profiled": _profiled(src)})
    for rotate in (False, True):
        label = "rotated" if rotate else "snap"
        fr, bias, dark, flat, exp_ratio, _o, mats, _g = \
            cs._workload_on_device(rotate, dev)[:8]
        n, h, w = fr.shape
        er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
        masters = cs._masters(bias, dark, flat, dev)[0]
        cfg = cs.lean_config(rotate)
        plan = wc.plan_warp_combine(
            fr.shape, torch.from_numpy(mats.astype(np.float32)).to(dev), er,
            span=cfg.warp_span, apron=False, dither_budget=cfg.dither_budget,
            general_taps=cfg.general_taps)
        rows = kernels._warp_block_rows(n, plan.span)
        out = torch.empty((h, w), device=dev)

        def launcher(lib):
            def go():
                err = lib.warp_combine_launch(
                    kernels._ptr(fr), 1, kernels._ptr(masters),
                    kernels._ptr(plan.table), kernels._ptr(plan.tiles),
                    kernels._ptr(out), n, h, w, plan.th, plan.tw, plan.n_ti,
                    plan.n_tj, plan.span, 1, 3, 5.0, 5.0, rows, None, 0, 0,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return go

        names = [k for k in libs if k != "profiled"]
        times = {k: [] for k in names}
        for name in names + names[::-1]:
            times[name].append(cs._time_ms(launcher(libs[name]), 3))
        print(json.dumps({"case": label, "combine": "mean", "ms": times,
                          "card": card}), flush=True)

        prof = libs["profiled"]
        go = launcher(prof)
        go()
        torch.cuda.synchronize()
        prof.prof_reset()
        _out, ms = cs._timed(go)
        acc = (ctypes.c_ulonglong * 128)()
        prof.prof_read(acc)
        blocks = acc[127]
        per_warp = [{s: round(acc[wp * 8 + q] / blocks / n)
                     for q, s in enumerate(STEPS)} for wp in range(rows)]
        print(json.dumps({"case": label, "profiled_ms": ms,
                          "cycles_per_frame_by_warp": per_warp, "card": card}),
              flush=True)
        del fr, masters, out
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
