#!/usr/bin/env python3
"""Where K1 (detect_tiles) and K3 (clip_combine) spend their time, on
one GPU.

Compiles edited copies of ``astrophotography_tpu_torch/csrc/detect_tiles.cu``
and ``clip_combine.cu`` and times each beside the source as it is, in
turns on one card, after printing ptxas' registers and spills of each
and the instruction mix of K1's row loop (uint16, radius 2) from
``cuobjdump -sass``.

* K1 runs on chip_smoke.py's 100x4096^2 snap workload with A and both
  master densities: without the step's barrier, with raw loads that all
  hit the cache (a variant without loads would let the compiler fold
  the arithmetic away), without the peak test; and, on the source as it
  is, without A, without the densities and under other block shapes
  (tile columns x strip tiles).  An edited copy named ``...@CxS`` runs
  with C tile columns and S strip tiles.
* K3 runs on chip_smoke.py's 24x2048x4096 band (20% masked) and on
  100x1024^2 (masked and not): without either sorting network (one read
  of the stack and the mask, the clip and the sum).

The edited copies give wrong results; only their times mean anything.
The edits are anchored on lines of the source and fail loudly when the
source no longer has them.

Run from the repository root: ``PYTHONPATH=. python3 tools/k1_variants.py``.
Prints one JSON line per build and per measurement, then the card's
nvidia-smi line.
"""

from __future__ import annotations

import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import detect_tiles as dt

CSRC = Path("astrophotography_tpu_torch/csrc")
OUT = Path("build/k1_variants")


def _rep(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) < count:
        raise SystemExit(f"anchor not in source {count} times: {old!r}")
    return text.replace(old, new, count)


def k1_variants(src: str) -> dict:
    def no_barrier(t):  # the step's barrier is gone (neighbours are stale)
        return _rep(t, "    __syncthreads();\n    float G[", "    float G[")

    def cached_raw(t):  # every raw load hits rows 0-3 of the frame (L2)
        return _rep(t, "const T* src = fr + (size_t)(2 * yb) * w;",
                    "const T* src = fr + (size_t)(2 * (yb & 1)) * w;")

    def no_peak(t):     # no candidates: the peak test never runs
        return _rep(t, "    cand0 &= col_ok;", "    cand0 = 0;")

    return {"base": src, "no_barrier": no_barrier(src),
            "cached_raw": cached_raw(src), "no_peak": no_peak(src),
            "cached_raw_no_barrier": no_barrier(cached_raw(src))}


def k3_variants(src: str) -> dict:
    def no_sort(t):     # one read, neither network
        t = _rep(t, "    sort_regs<M>(srt);\n", "")
        t = _rep(t, "    merge_regs<M>(srt);\n", "")
        return _rep(t, "    sort_column(srt, n, nt);\n", "")

    return {"base": src, "no_sort": no_sort(src)}


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
    for name, proc in procs.items():
        _out, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{err}")
        regs = [ln.strip() for ln in err.splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"built": name, "ptxas": regs}), flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"{name}.so"))
    return libs


def sass_row_loop(lib: Path, kernel: str) -> dict:
    """The instructions of ``kernel``'s longest loop in ``lib`` (the span
    of its widest backward branch, rarely taken branches included), by
    opcode, from ``cuobjdump -sass``."""
    tool = Path(kernels._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    body = next(f for f in sass.split("Function : ")[1:]
                if f.split("\n")[0].find(kernel) >= 0)
    ins = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4})\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)([^;]*);", body)]
    loops = [(a - int(m.group(1), 16), int(m.group(1), 16), a)
             for a, op, rest in ins if op.startswith("BRA")
             for m in [re.search(r"0x([0-9a-f]+)", rest)]
             if m and int(m.group(1), 16) < a]
    _span, lo, hi = max(loops)
    ops = collections.Counter(op.split(".")[0] for a, op, _r in ins
                              if lo <= a <= hi)
    return {"kernel": kernel, "loop_instructions": sum(ops.values()),
            "function_instructions": len(ins),
            "by_opcode": dict(ops.most_common())}


def _turns(launchers: dict, reps: int) -> dict:
    """{name: [ms, ms]}: every variant timed in turns, there and back."""
    names = list(launchers)
    times = {k: [] for k in names}
    for name in names + names[::-1]:
        times[name].append(cs._time_ms(launchers[name], reps))
    return times


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _run(fn, *args):
    err = fn(*args)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def time_k1(libs: dict, dev, card: str) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fr, bias, dark, flat, exp_ratio, _o, _m, _g = \
        cs._workload_on_device(False, dev)[:8]
    n, h, w = fr.shape
    er = torch.full((n,), exp_ratio, dtype=torch.float32, device=dev)
    masters, b_t, du_t, f_t = cs._masters(bias, dark, flat, dev)
    a_plane = masters[0].contiguous()
    mf = dt.master_densities(b_t, du_t, f_t)
    thr = torch.full((n,), 5.0 * 8.0, device=dev)
    params, r = dt._kernel_params(3.0)
    par = ctypes.cast(kernels._params_block(params), p)
    lay = kernels._detect_layout(n, h, w)
    shape = (n, h // 64, w // 256)
    outs = [torch.empty(shape, dtype=t, device=dev)
            for t in (torch.float32, torch.int32, torch.float32,
                      torch.float32)]

    def launcher(lib, a=a_plane, m=mf, tile_cols=lay["tile_cols"],
                 strip_tiles=lay["strip_tiles"]):
        fn = lib.detect_tiles_launch
        fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                       p, i, p]
        ptr = kernels._ptr
        return lambda: _run(fn, ptr(fr), 1, ptr(a), ptr(m), ptr(thr), ptr(er),
                            par, *(ptr(o) for o in outs), n, h, w, r,
                            tile_cols, strip_tiles, None, 0, _stream())

    # a variant named "...@CxS" runs with C tile columns and S strip tiles
    runs = {}
    for k, v in libs.items():
        shape_kw = {}
        if "@" in k:
            tc, st = k.split("@")[1].split("x")
            shape_kw = dict(tile_cols=int(tc), strip_tiles=int(st))
        runs[k] = launcher(v, **shape_kw)
    base = libs["base"]
    runs.update(no_a=launcher(base, a=None), no_mf=launcher(base, m=None),
                no_a_no_mf=launcher(base, a=None, m=None))
    for tc, st in ((2, 16), (2, 4), (2, 2), (1, 8)):
        runs[f"block_{tc}x{st}"] = launcher(base, tile_cols=tc, strip_tiles=st)
    print(json.dumps({"kernel": "K1", "shape": [n, h, w], "layout": lay,
                      "ms": _turns(runs, 3), "card": card}), flush=True)


def k3_launcher(lib, stack, mask, out):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.clip_combine_launch
    fn.argtypes = [p, p, p, i, i, i, f, f, i, i, p]
    n, h, w = stack.shape
    ptr = kernels._ptr
    route = kernels._clip_route(n)
    param = kernels._clip_cols_warps(n) if route == "cols" else 0
    code = kernels._CLIP_ROUTE_CODES["regs" if route.startswith("regs")
                                     else route]
    return lambda: _run(fn, ptr(stack), ptr(mask), ptr(out), n, h, w, 5.0, 5.0,
                        code, param, _stream())


def time_k3(libs: dict, dev, card: str) -> None:
    for shape, seed, masked in (((24, 2048, 4096), 1, True),
                                ((100, 1024, 1024), 100, True),
                                ((100, 1024, 1024), 100, False)):
        stack, mask = cs._clip_inputs(*shape, dev, seed=seed, masked=masked)
        mk = None if mask is None else mask.view(torch.uint8)
        out = torch.empty(shape[1:], device=dev)
        times = _turns({k: k3_launcher(v, stack, mk, out)
                        for k, v in libs.items()}, 3)
        print(json.dumps({"kernel": "K3", "shape": list(shape),
                          "masked": masked, "ms": times, "card": card}),
              flush=True)
        del stack, mask, mk, out
        torch.cuda.empty_cache()


def main() -> int:
    dev = torch.device("cuda")             # raises without a usable card
    card = cs.card_line()
    k1 = {f"k1_{k}": v for k, v in
          k1_variants((CSRC / "detect_tiles.cu").read_text()).items()}
    k3 = {f"k3_{k}": v for k, v in
          k3_variants((CSRC / "clip_combine.cu").read_text()).items()}
    libs = _build({**k1, **k3})
    print(json.dumps({"sass": sass_row_loop(
        OUT / "k1_base.so", "detect_rolling_kernelItLi2")}), flush=True)
    time_k3({k[3:]: libs[k] for k in k3}, dev, card)
    time_k1({k[3:]: libs[k] for k in k1}, dev, card)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
