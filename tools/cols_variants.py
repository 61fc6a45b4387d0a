#!/usr/bin/env python3
"""Where the many-frame routes ('cols') of K2 (warp_combine) and K3
(clip_combine) spend their time, on one GPU.

Compiles edited copies of ``astrophotography_tpu_torch/csrc/`` (each in
its own directory with its own ``warp_sort.cuh``) and times each beside
the sources as they are, in turns on one card, after printing ptxas'
registers and spills of the 'cols' kernels:

* ``nosort``: the warps do not sort (the ranks read an unsorted column);
* ``run2048``: runs of 2048 in registers (R = 64 a lane) and the longer
  columns merged on chip, instead of runs of 1024 (R <= 32);
* ``nosum`` (K3): the frame-order sum is not taken;
* ``noranks`` (K2): the combine reads the sorted column's ends only.

Then K2's two routes, 'smem' and 'cols', on the lean cells' shape
(100 x 4096^2, snap and rotated lowrank, 'average', no apron as the lean
path runs it) and at 100 and 150 frames of 512^2 (snap, with the apron
as the sweep runs it), through the wrapper.

K2 runs on the lean snap window at 1200 x 512^2 ('average', route
'cols'); K3 on a masked 1200 x 256 x 1024 stack (route 'cols').  The
edited copies give wrong results; only their times mean anything.  The
edits are anchored on lines of the sources and fail loudly when the
sources no longer have them.

Run from the repository root: ``PYTHONPATH=. python3 tools/cols_variants.py``.
Prints one JSON line per build and per measurement, then the card's
nvidia-smi line.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import warp_combine as wc

CSRC = Path("astrophotography_tpu_torch/csrc")
OUT = Path("build/cols_variants")
FLAGS = [f for f in kernels.NVCC_FLAGS if f != str(CSRC.resolve())
         and f != "-I"]


def _rep(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"anchor not in source: {old!r}")
    return text.replace(old, new)


def _run2048(sort_h: str, k2: str):
    sort_h = _rep(sort_h, "constexpr int SORT_RUN = 1024;",
                  "constexpr int SORT_RUN = 2048;")
    sort_h = _rep(sort_h, "    default: sort_col_r<32>(col, L, lane); break;",
                  "    case 32: sort_col_r<32>(col, L, lane); break;\n"
                  "    default: sort_col_r<64>(col, L, lane); break;")
    k2 = _rep(k2, "  if (n <= SORT_RUN)\n    return combine_run<32>(",
              "  if (n <= 1024)\n    return combine_run<32>(col, n, count, "
              "combine, sigma_lo, sigma_hi, lane);\n  if (n <= SORT_RUN)\n"
              "    return combine_run<64>(")
    return sort_h, k2


def variants() -> dict:
    """{name: {file: text}} of the edited sources (K2's and K3's)."""
    sort_h = (CSRC / "warp_sort.cuh").read_text()
    net_h = (CSRC / "sort_network.cuh").read_text()
    k2 = (CSRC / "warp_combine.cu").read_text()
    k3 = (CSRC / "clip_combine.cu").read_text()
    out = {"base": {"warp_combine.cu": k2, "clip_combine.cu": k3,
                    "warp_sort.cuh": sort_h}}
    out["nosort"] = {
        "warp_combine.cu": k2, "clip_combine.cu": _rep(
            k3, "      sort_col(col, n, lane);\n      const Sorted c{col, s};",
            "      const Sorted c{col, s};"),
        "warp_sort.cuh": _rep(sort_h, "  warp_sort_regs<R>(v, lane);\n#pragma unroll\n"
                              "  for (int r = 0; r < R; ++r) {\n"
                              "    const int e = lane * R + r;\n"
                              "    if (e < L) col[swz(e, S)] = v[r];",
                              "#pragma unroll\n"
                              "  for (int r = 0; r < R; ++r) {\n"
                              "    const int e = lane * R + r;\n"
                              "    if (e < L) col[swz(e, S)] = v[r];")}
    h64, k2_64 = _run2048(sort_h, k2)
    out["run2048"] = {"warp_combine.cu": k2_64, "clip_combine.cu": k3,
                      "warp_sort.cuh": h64}
    out["nosum"] = {
        "warp_combine.cu": _rep(
            k2, "  const float acc = run_sum<R>(v, k.below, k.below + k.cnt, lane);",
            "  const float acc = v[0];"),
        "clip_combine.cu": _rep(
            k3, "        for (int f = 0; f < n; ++f) clip.take(o[swz(f, s)], acc, kept);",
            "        clip.take(o[0], acc, kept);"),
        "warp_sort.cuh": sort_h}
    out["noranks"] = {
        "warp_combine.cu": _rep(
            k2, "  const Kept k = clip_sorted(c, n, count, sigma_lo, sigma_hi);\n"
                "  if (k.cnt == 0) return 0.0f;\n  if (combine == 1) return kept_median(c, k);\n"
                "  const float acc = run_sum<R>",
            "  const Kept k{0, count};\n"
            "  if (k.cnt == 0) return 0.0f;\n  if (combine == 1) return kept_median(c, k);\n"
            "  const float acc = run_sum<R>"),
        "clip_combine.cu": k3, "warp_sort.cuh": sort_h}
    for files in out.values():
        files["sort_network.cuh"] = net_h
    return out


def build(srcs: dict) -> dict:
    """{(variant, kernel): loaded library}, one nvcc each, all at once."""
    procs = {}
    for name, files in srcs.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for fn, text in files.items():
            (d / fn).write_text(text)
        for kern in ("warp_combine", "clip_combine"):
            so = d / f"lib{kern}.so"
            procs[name, kern] = (so, subprocess.Popen(
                [kernels._nvcc(), *FLAGS, "-I", str(d), "-o", str(so),
                 str(d / f"{kern}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {key}:\n{err}")
        lines = err.splitlines()
        regs = [ln.strip() for i, ln in enumerate(lines)
                if ("spill" in ln or "registers" in ln)
                and any(k in "".join(lines[max(0, i - 3):i + 1])
                        for k in ("cols_kernel", "clip_warp"))]
        print(json.dumps({"built": "/".join(key), "ptxas": regs}), flush=True)
        libs[key] = ctypes.CDLL(str(so))
    return libs


def _turns(launchers: dict, reps: int) -> dict:
    names = list(launchers)
    times = {k: [] for k in names}
    for name in names + names[::-1]:
        times[name].append(cs._time_ms(launchers[name], reps))
    return times


def _err(e):
    if e:
        raise RuntimeError(f"launch failed: CUDA error {e}")


def main() -> int:
    dev = torch.device("cuda")             # raises without a usable card
    card = cs.card_line()
    libs = build(variants())
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    # K2: the lean snap window at 1200 x 512^2 on 'cols'
    n, size = 1200, 512
    cfg = cs.lean_config(False)
    fr, bias, dark, flat, exp_ratio, _o, mats = cs.make_workload_on_device(
        n, size, dev, seed=4)
    masters = cs._masters(bias, dark, flat, dev)[0]
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    plan = wc.plan_warp_combine(
        fr.shape, torch.from_numpy(mats.astype(np.float32)).to(dev), er,
        span=cfg.warp_span, apron=True, dither_budget=cfg.dither_budget,
        general_taps=cfg.general_taps)
    rows = kernels._warp_block_rows(n, plan.span, "cols")
    run = kernels._warp_cols_run(rows, plan.span)
    grid = kernels._resident_blocks("warp_combine", "cols", dev, 1,
                                    min(n, run), plan.span, rows, run)
    scratch = torch.empty((kernels._warp_scratch_bytes(n, rows, grid) // 4,),
                          device=dev)
    out = torch.empty((size, size), device=dev)

    def k2(lib):
        fn = lib.warp_combine_launch
        fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f, f,
                       i, p, i, i, p]
        ptr = kernels._ptr
        return lambda: _err(fn(
            ptr(fr), 1, ptr(masters), ptr(plan.table), ptr(plan.tiles),
            ptr(out), n, size, size, plan.th, plan.tw, plan.n_ti, plan.n_tj,
            plan.span, 1, 0, 5.0, 5.0, rows, ptr(scratch), grid, run,
            stream()))

    k2_libs = {name: k2(lib) for (name, kern), lib in libs.items()
               if kern == "warp_combine"}
    fn3 = kernels._load()["warp_combine"].warp_combine_launch
    mean = lambda: _err(fn3(
        kernels._ptr(fr), 1, kernels._ptr(masters), kernels._ptr(plan.table),
        kernels._ptr(plan.tiles), kernels._ptr(out), n, size, size, plan.th,
        plan.tw, plan.n_ti, plan.n_tj, plan.span, 1, 3, 5.0, 5.0, rows,
        kernels._ptr(scratch), grid, run, stream()))
    print(json.dumps({"kernel": "K2", "shape": [n, size, size],
                      "route": "cols", "ms": _turns({**k2_libs, "mean": mean},
                                                    3),
                      "card": card}), flush=True)
    del fr, scratch
    torch.cuda.empty_cache()

    # K3: a masked 1200 x 256 x 1024 stack on 'cols'
    stack, mask = cs._clip_inputs_chunked(1200, 256, 1024, dev, seed=11)
    mk = mask.view(torch.uint8)
    out3 = torch.empty((256, 1024), device=dev)
    warps = kernels._clip_cols_warps(1200)

    def k3(lib):
        fn = lib.clip_combine_launch
        fn.argtypes = [p, p, p, i, i, i, f, f, i, i, p]
        ptr = kernels._ptr
        return lambda: _err(fn(ptr(stack), ptr(mk), ptr(out3), 1200, 256,
                               1024, 5.0, 5.0,
                               kernels._CLIP_ROUTE_CODES["cols"], warps,
                               stream()))

    print(json.dumps({"kernel": "K3", "shape": [1200, 256, 1024],
                      "masked": True, "route": "cols",
                      "ms": _turns({name: k3(lib) for (name, kern), lib
                                    in libs.items()
                                    if kern == "clip_combine"}, 3),
                      "card": card}), flush=True)
    del stack, mask, mk
    torch.cuda.empty_cache()

    # K2's routes where they cross: the lean cells and 100 / 150 x 512^2
    cases = [(False, 100, 4096), (True, 100, 4096), (False, 100, 512),
             (False, 150, 512)]
    for rotate, n, size in cases:
        cfg = cs.lean_config(rotate)
        if size == 4096:
            fr, bias, dark, flat, exp_ratio, _o, mats = \
                cs._workload_on_device(rotate, dev)[:7]
        else:
            fr, bias, dark, flat, exp_ratio, _o, mats = \
                cs.make_workload_on_device(n, size, dev, rotate=rotate, seed=4)
        masters = cs._masters(bias, dark, flat, dev)[0]
        er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
        plan = wc.plan_warp_combine(
            fr.shape, torch.from_numpy(mats.astype(np.float32)).to(dev), er,
            span=cfg.warp_span, apron=size < 4096,
            dither_budget=cfg.dither_budget, general_taps=cfg.general_taps)
        calls = {r: (lambda r=r: kernels.warp_combine_cuda(
            fr, masters, plan, 0, True, 5.0, 5.0, route=r))
            for r in ("smem", "cols")}
        same = bool(torch.equal(calls["smem"](), calls["cols"]()))
        print(json.dumps({"kernel": "K2 routes", "shape": [n, size, size],
                          "window": "lowrank" if rotate else "snap",
                          "picked": kernels._warp_route(n, plan.span),
                          "equal": same, "ms": _turns(calls, 2),
                          "card": card}), flush=True)
        del fr, masters
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
