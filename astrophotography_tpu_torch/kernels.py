"""Build, bind and launch the hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface.  At the first CUDA
use each is compiled with ``nvcc`` for ``sm_90a`` into its own shared
library under ``build/torch_kernels/`` of the checkout (named by a hash
of the source, so an edit rebuilds it); the ``nvcc`` processes run
together, and the libraries are loaded with ``ctypes``.  Each C entry
point launches on PyTorch's current stream and returns
``cudaGetLastError()``; the wrapper raises if that is not 0.

Each kernel has a launch counter: a plain integer in
:data:`launch_counts`, raised by one where the wrapper launches the
kernel and nowhere else, so a run can show that its main path went
through the kernels; :data:`route_counts` splits those of the kernels
that have routes by route (K2's and the separable warp's, seen also as
:data:`warp_route_counts` and :data:`warp_separable_route_counts`).
Exact detection's two kernels (its tiles and its merge) count once a
call.  :func:`_launched` raises them, and the span counters ``launch.<kernel>``
and ``launch.<kernel>.<route>`` (``utils.timing``) with them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from .utils import timing

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
#: kernel name -> its source under csrc/ (one library each)
_SOURCES = {"detect_tiles": "detect_tiles.cu",
            "warp_combine": "warp_combine.cu",
            "clip_combine": "clip_combine.cu",
            "warp_separable": "warp_separable.cu",
            "find_exact": "find_exact.cu",
            "calibrate": "calibrate.cu"}
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
#: ``-Xptxas -v`` reports each kernel's registers, shared memory, stack
#: frame and spills on stderr, kept in ``build_info["ptxas"]``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(_SRC))

#: launches of each kernel since the last :func:`reset_launch_counts`
launch_counts = {name: 0 for name in _SOURCES}
#: launches by kernel and route since the last :func:`reset_launch_counts`,
#: for the kernels that have routes (the separable warp's 'scratch' counts
#: its two kernels)
route_counts = {"warp_combine": {"smem": 0, "cols": 0, "wide": 0},
                "warp_separable": {"smem": 0, "scratch": 0}}
#: K2's launches by route (a view of :data:`route_counts`)
warp_route_counts = route_counts["warp_combine"]
#: the separable warp's launches by route (a view of :data:`route_counts`)
warp_separable_route_counts = route_counts["warp_separable"]

_lock = threading.Lock()
_libs: Optional[dict] = None
#: what the last build did: nvcc path, version line, seconds, libraries
build_info: dict = {}


def reset_launch_counts() -> None:
    for counts in (launch_counts, *route_counts.values()):
        for k in counts:
            counts[k] = 0


def _launched(kernel: str, route: Optional[str] = None) -> None:
    """Count one launch of ``kernel`` (by ``route`` for the kernels of
    :data:`route_counts`): the process totals and the innermost span's
    counters."""
    launch_counts[kernel] += 1
    timing.count(f"launch.{kernel}")
    if route is not None:
        route_counts[kernel][route] += 1
        timing.count(f"launch.{kernel}.{route}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _library(name: str) -> Path:
    """The shared library of kernel ``name``, named by a hash of its
    source, of every header under csrc/ (an edit of a shared header
    rebuilds every library) and of the flags."""
    h = hashlib.sha256((_SRC / _SOURCES[name]).read_bytes())
    for header in sorted(_SRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile every kernel whose library for this source hash does not
    exist yet, one ``nvcc`` process per source, all started together.
    Returns {kernel name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {name: _library(name) for name in _SOURCES}
    todo = [name for name, lib in libs.items() if not lib.exists()]
    build_info.update(libraries={k: str(v) for k, v in libs.items()},
                      built=todo, seconds=0.0)
    if not todo:
        return libs
    nvcc = _nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = libs[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_SRC / _SOURCES[name])]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed, ptxas = [], {}
    for name, (cmd, tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)} ({proc.returncode}):\n{out}\n{err}")
        else:
            os.replace(tmp, libs[name])
            ptxas[name] = err.strip()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_info.update(seconds=time.perf_counter() - t0, nvcc=nvcc,
                      nvcc_version=version.splitlines()[-1], ptxas=ptxas)
    return libs


def _load() -> dict:
    """{kernel name: loaded library}, built and bound at the first call."""
    global _libs
    with _lock:
        if _libs is None:
            libs = {name: ctypes.CDLL(str(path))
                    for name, path in build().items()}
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn = libs["detect_tiles"].detect_tiles_launch
            fn.argtypes = [p, i, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                           p, i, p]
            fn.restype = i
            for route in ("", "_wide"):
                fn = getattr(libs["warp_combine"],
                             f"warp_combine{route}_launch")
                fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, i,
                               i, f, f, i, p, i, i, p]
                fn.restype = i
            for route in ("cols", "wide"):
                fn = getattr(libs["warp_combine"],
                             f"warp_combine_{route}_blocks")
                fn.argtypes = [i, i, i, i, i]
                fn.restype = i
            fn = libs["clip_combine"].clip_combine_launch
            fn.argtypes = [p, p, p, i, i, i, f, f, i, i, p]
            fn.restype = i
            fn = libs["warp_separable"].warp_separable_launch
            fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, i, i,
                           i, p]
            fn.restype = i
            q = ctypes.c_longlong
            fn = libs["find_exact"].find_exact_launch
            fn.argtypes = [p, p, q, p, p, i, i, i, i, i, i, p, p, p, p, q, p,
                           p, p, p]
            fn.restype = i
            fn = libs["calibrate"].calibrate_launch
            fn.argtypes = [p, i, p, p, p, p, i, i, q, p, p]
            fn.restype = i
            _libs = libs
        return _libs


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check(t: Optional[torch.Tensor], name: str, device, shape=None,
           dtype=torch.float32) -> Optional[torch.Tensor]:
    """``t`` as a contiguous ``dtype`` tensor on ``device`` (None stays
    None); raises on the wrong device or shape."""
    if t is None:
        return None
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t.to(dtype).contiguous()


def _frames_arg(frames: torch.Tensor):
    if frames.dtype not in (torch.uint16, torch.float32):
        raise ValueError(f"frames must be uint16 or float32, got "
                         f"{frames.dtype}")
    return frames.contiguous(), int(frames.dtype == torch.uint16)


@functools.lru_cache(maxsize=None)
def _params_block(params: tuple):
    """A kernel's parameter block (K1's, exact detection's taps) as a C
    float array in host memory: the launch passes it to the kernel by
    value."""
    return (ctypes.c_float * len(params))(*params)


#: K1's tile (binned rows x columns), the columns per thread of its strip
#: kernels, their largest block (tile columns) and strip (tiles), and the
#: blocks that fill the card twice over (132 SMs x 3 blocks x 2)
_DET_TTY, _DET_TTX, _DET_CPT = 32, 256, 4
_DET_MAX_TILE_COLS, _DET_MAX_STRIP_TILES, _DET_FILL_BLOCKS = 2, 8, 792
#: the largest filter radius K1 takes, the TPU kernel's reach (its lane
#: filter's 128 columns and its band of 128 binned rows each side), and
#: the largest of the ring route (csrc/detect_tiles.cu)
_DET_MAX_RADIUS, _DET_RING_MAX_RADIUS = 128, 16
#: the most bytes the separable route's G and Box planes take at once
#: (frames go in chunks)
_DET_SCRATCH_MAX = 1 << 30
#: floats of padding each side of a shared row of the ring and planes
#: kernels (``HPAD``)
_DET_HPAD = 16


def _detect_route(r: int) -> str:
    """Which of K1's routes filter radius ``r`` takes (mirrors
    ``launch`` in csrc/detect_tiles.cu): 'rolling' for r = 2 and 3,
    'ring' for 1 and 4 to 16, 'separable' for 17 to 128."""
    if not 1 <= r <= _DET_MAX_RADIUS:
        raise ValueError(f"detect_tiles kernel takes filter radii 1 to "
                         f"{_DET_MAX_RADIUS}, got {r}")
    if r in (2, 3):
        return "rolling"
    return "ring" if r <= _DET_RING_MAX_RADIUS else "separable"


def _detect_chunk(n: int, h: int, w: int) -> int:
    """Frames per chunk of the separable route: as many as keep the G
    and Box planes (8 B per binned pixel) within 1 GiB, at least one."""
    return max(1, min(n, _DET_SCRATCH_MAX // (8 * (h // 2) * w)))


def _detect_layout(n: int, h: int, w: int, r: int = 2) -> dict:
    """The launch shape of K1's strip kernel for ``n`` frames of ``h`` x
    ``w`` at filter radius ``r`` (mirrors ``launch_rolling``,
    ``launch_ring`` and ``launch_separable`` in csrc/detect_tiles.cu; on
    the separable route ``n`` is the chunk's frames): a block owns
    ``tile_cols`` tile columns (the most, up to 2, that divide the
    frame's) with 64 threads each and walks ``strip_tiles`` tiles of 32
    binned rows; the strip is halved from 8 tiles while the grid has
    fewer blocks than fill the card.  Beside the strip's threads, the
    rolling kernel has one halo thread each side, the ring kernel
    ceil((r + 1) / 4), the planes kernel one.  Shared memory: the rolling
    kernel's 8 rows of the strip (two buffers of the G and Box rows, a
    ring of 4 density rows); the ring kernel's 2r binned rows more, each
    row as long as a strip of 2 tile columns makes it; the
    planes kernel's 8 rows with ceil(r / 4) + 1 groups of 4 columns left
    of the strip and 3 more right of it, and the row taps (padded to a
    multiple of 4)."""
    route = _detect_route(r)
    tyn, txn = h // (2 * _DET_TTY), w // _DET_TTX
    tile_cols = next(k for k in range(_DET_MAX_TILE_COLS, 0, -1)
                     if txn % k == 0)
    strip_tiles = min(_DET_MAX_STRIP_TILES, tyn)

    def blocks(s):
        return n * (txn // tile_cols) * -(-tyn // s)

    while strip_tiles > 1 and blocks(strip_tiles) < _DET_FILL_BLOCKS:
        strip_tiles = (strip_tiles + 1) // 2
    core = _DET_TTX // _DET_CPT * tile_cols
    cpt = _DET_CPT
    if route == "rolling":
        halo = 1
        words = 8 * (cpt * (core + 2) + 8)
    elif route == "ring":
        # its rows are as long for one tile column as for two
        halo = -(-(r + 1) // cpt)
        words = (2 * r + 8) * (cpt * (_DET_TTX // cpt * _DET_MAX_TILE_COLS
                                      + 2 * halo) + 2 * _DET_HPAD)
    else:
        halo = 1
        nv = core + 2 * (-(-r // cpt) + 1) + 3
        words = 8 * cpt * nv + (2 * r + 1 + 3) // 4 * 4
    threads = -(-(core + 2 * halo) // 32) * 32
    return {"tile_cols": tile_cols, "strip_tiles": strip_tiles,
            "threads": threads,
            "segments": -(-tyn // strip_tiles), "smem_bytes": 4 * words}


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def detect_tiles_cuda(frames, thresholds, mf_bc, a_plane, exp_ratios,
                      params, r: int):
    """Launch K1 (``csrc/detect_tiles.cu``); see
    ``ops.detect_tiles.detect_tiles`` for the arguments and results."""
    dev = frames.device
    n, h, w = frames.shape
    route = _detect_route(r)            # raises past the TPU kernel's reach
    frames, is_u16 = _frames_arg(frames)
    thr = _check(thresholds, "thresholds", dev, (n,))
    if exp_ratios is None:
        exp_ratios = torch.ones((n,), dtype=torch.float32, device=dev)
    er = _check(exp_ratios, "exp_ratios", dev, (n,))
    a = _check(a_plane, "a_plane", dev, (h, w))
    mf = _check(mf_bc, "mf_bc", dev, (2, h // 2, w))
    par = _params_block(tuple(params))
    scratch, chunk = None, 0
    if route == "separable":
        chunk = _detect_chunk(n, h, w)
        scratch = torch.empty((2 * chunk * (h // 2) * w,),
                              dtype=torch.float32, device=dev)
    lay = _detect_layout(chunk or n, h, w, r)
    shape = (n, h // 64, w // 256)
    out_max = torch.empty(shape, dtype=torch.float32, device=dev)
    out_idx = torch.empty(shape, dtype=torch.int32, device=dev)
    out_yoff = torch.empty(shape, dtype=torch.float32, device=dev)
    out_xoff = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = _load()["detect_tiles"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.detect_tiles_launch(
        _ptr(frames), is_u16, _ptr(a), _ptr(mf), _ptr(thr), _ptr(er),
        ctypes.cast(par, ctypes.c_void_p), _ptr(out_max), _ptr(out_idx),
        _ptr(out_yoff), _ptr(out_xoff), n, h, w, r, lay["tile_cols"],
        lay["strip_tiles"], _ptr(scratch), chunk, ctypes.c_void_p(stream))
    _raise_on(err, "detect_tiles")
    _launched("detect_tiles")
    return out_max, out_idx, out_yoff, out_xoff


#: the shared memory one block may use (227 KB)
_SMEM_MAX = 232448
#: K2's block: 32 output columns by up to 8 rows (csrc/warp_combine.cu)
_WARP_BX, _WARP_MAX_ROWS = 32, 8
#: K2's 'smem' route takes blocks of this many rows only (their columns
#: and window must fit: up to 216 frames at span 8, 214 at span 12); and
#: K2 takes 'cols' from _WARP_COLS_FRAMES frames on.  chip_smoke.py's
#: route sweep (deep phase, 512^2, lean snap / lowrank windows, H100):
#: 'smem' wins at 100 frames (1.33 against 2.39 ms / 2.02 against 3.22;
#: 68.5 against 138.8 ms on the lean cell, 100 x 4096^2,
#: tools/cols_variants.py), 'cols' from 150 (3.39 / 3.48 ms, 4.43 /
#: 4.72; a tie, 3.31 / 3.30, in tools/cols_variants.py) and 200 (4.12 /
#: 4.41, 6.06 / 6.39) on, 1.5-2x at 300-400 where a shared block would
#: keep 5 or 4 rows, 7-24x from 600.
_WARP_SMEM_ROWS, _WARP_COLS_FRAMES = 8, 150
#: K2's 'wide' route, for windows that leave no room for one row of a
#: shared block (span past 192): blocks of 8 warps and up to 32 output
#: rows of 32 columns (4 rows a thread), whose mid rows ((rows + span) x
#: 32 floats) are what shared memory must
#: hold; each thread combines its own pixels, in registers up to
#: _WARP_WIDE_REG_FRAMES frames, in a column of its warp's [n][32] words
#: of shared memory up to _WARP_WIDE_COL_FRAMES; past that the block
#: combines through the 'cols' combine; its scratch is capped at 1 GiB
#: (218 blocks of 32 rows at 1200 frames)
_WARP_WIDE_WARPS, _WARP_WIDE_ROWS = 8, 32
_WARP_WIDE_REG_FRAMES, _WARP_WIDE_COL_FRAMES = 32, 112
_WARP_WIDE_SCRATCH_MAX = 1 << 30
#: the widest window K2 takes, the 'wide' route's reach since it came in
#: (one output row's mid rows and the 8 warps' window rows filled its
#: first layout's 227 KB there); the present layout holds 8 rows at it
_WARP_WIDE_MAX_SPAN = 1436


#: (kernel, route, device index, *arguments) -> blocks of a persistent
#: route the card keeps resident at once
_resident: dict = {}


def _resident_blocks(kernel: str, route: str, dev, *args) -> int:
    """Blocks of K2's 'cols' or 'wide' route the card keeps resident at
    once (the route's grid and scratch slots), from the occupancy API;
    cached per route, device and arguments."""
    key = (kernel, route, dev.index, *args)
    if key not in _resident:
        fn = getattr(_load()[kernel], f"{kernel}_{route}_blocks")
        with torch.cuda.device(dev):
            blocks = fn(*args)
        if blocks < 1:
            raise RuntimeError(f"{kernel}: occupancy query failed ({blocks})")
        _resident[key] = blocks
    return _resident[key]


def _warp_smem_bytes(n: int, rows: int, span: int) -> int:
    """Shared memory of one K2 block of ``rows`` x 32 pixels on the
    'smem' route (mirrors ``layout`` in csrc/warp_combine.cu): the
    N-sample columns (``n`` = 0: the warp phase alone, as on 'cols'), the
    calibrated source window, the horizontal pass, the tap weights, the
    ring of frame parameters."""
    bx = _WARP_BX
    wr, wc = rows + span, bx + span
    words = (n * bx * rows + wr * wc + 2 * wr * bx + wr * 8 + wr
             + 2 * 8 * bx + 4 * bx + 3 * 16 + 5 * 20)
    return 4 * words


def _cols_stride(length: int, warps: int) -> int:
    """Words of one warp's column on K2's and K3's 'cols' routes (mirrors
    ``cols_stride`` in both sources): the samples rounded up to 32 and a
    pad that spreads a tile load over the banks."""
    pad = 4 if warps >= 8 else 8 if warps >= 4 else 16 if warps >= 2 else 0
    return -(-length // 32) * 32 + pad


def _warp_smem_rows(n: int, span: int) -> int:
    """The most rows (<= 8) of a K2 'smem' block with ``n`` columns and a
    window of ``span`` in shared memory; 0 where not even one fits."""
    return next((r for r in range(_WARP_MAX_ROWS, 0, -1)
                 if _warp_smem_bytes(n, r, span) <= _SMEM_MAX), 0)


def _warp_wide_smem_bytes(rows: int, span: int) -> int:
    """Shared memory of one K2 'wide' block's warp phase of ``rows``
    output rows (mirrors ``wide_layout`` in csrc/warp_combine.cu): the mid
    rows, a window row per warp, then for the two frames prepared at once
    the snap weights and the range of mid rows read, and the ring of 4
    frames' parameters."""
    bx = _WARP_BX
    words = ((rows + span) * bx + _WARP_WIDE_WARPS * (bx + span) + 2 * 16
             + 4 * 20 + 2 * 2)
    return 4 * words


def _warp_wide_rows(span: int) -> int:
    """The output rows of a K2 'wide' block at ``span``: the most of
    :data:`_WARP_WIDE_ROWS` (32), 16, 8, 4, 2, 1 whose warp phase fits
    shared memory; 0 past the route's reach
    (:data:`_WARP_WIDE_MAX_SPAN`)."""
    if span > _WARP_WIDE_MAX_SPAN:
        return 0
    rows = _WARP_WIDE_ROWS
    while rows and _warp_wide_smem_bytes(rows, span) > _SMEM_MAX:
        rows //= 2
    return rows


assert _warp_wide_rows(_WARP_WIDE_MAX_SPAN) > 0


def _warp_route(n: int, span: int) -> str:
    """Which of K2's routes ``n`` frames with a window of ``span`` take:
    'wide' where not even one output row's window fits a shared block
    (span past 192), its mid rows in shared memory and its samples in the
    'cols' scratch; else 'smem' below :data:`_WARP_COLS_FRAMES` frames
    where a block keeps :data:`_WARP_SMEM_ROWS` rows with its columns and
    window in shared memory, the threads sorting their own columns;
    'cols' otherwise, the samples in a scratch of device memory and the
    warps sorting one column each on chip (the wrapper passes the scratch
    only there, and ``warp_combine_launch`` follows it)."""
    if _warp_smem_rows(0, span) == 0:
        return "wide"
    if n < _WARP_COLS_FRAMES and _warp_smem_rows(n, span) >= _WARP_SMEM_ROWS:
        return "smem"
    return "cols"


def _warp_block_rows(n: int, span: int, route: Optional[str] = None) -> int:
    """The rows of a K2 block with ``n`` frames on ``route`` (by default
    the one :func:`_warp_route` picks): 8 on 'smem', which takes no
    smaller block (its columns and window must fit 8 rows); on 'cols' the
    most (<= 8) whose window fits; on 'wide' :func:`_warp_wide_rows`.
    Raises for a window that a route's block does not fit: one row's
    window on 'smem' and 'cols' (span past 192), one row's mid rows on
    'wide' (span past :data:`_WARP_WIDE_MAX_SPAN`)."""
    route = route or _warp_route(n, span)
    if route == "wide":
        rows = _warp_wide_rows(span)
        if rows == 0:
            raise ValueError(
                f"warp_combine kernel: a window of span {span} is past the "
                f"reach of {_SMEM_MAX} B of shared memory per block for one "
                f"output row's mid rows; the 'wide' route takes spans up "
                f"to {_WARP_WIDE_MAX_SPAN}")
        return rows
    rows = _warp_smem_rows(n if route == "smem" else 0, span)
    if route == "smem" and 0 < rows < _WARP_SMEM_ROWS:
        raise ValueError(f"warp_combine 'smem' route: {n} frames at span "
                         f"{span} leave a block {rows} rows, not "
                         f"{_WARP_SMEM_ROWS}")
    if rows == 0:
        raise ValueError(f"warp_combine kernel '{route}' route: a window of "
                         f"span {span} needs more than {_SMEM_MAX} B of "
                         f"shared memory per block (the 'wide' route takes "
                         f"it)")
    return rows


def _warp_cols_run(rows: int, span: int) -> int:
    """The reach of K2's 'cols' route: the most samples of a column a
    warp sorts on chip at once (a multiple of 32): the block's shared
    memory split into ``rows`` columns.  Longer columns are sorted in runs
    of this length and merged (``combine_runs`` in
    csrc/warp_combine.cu)."""
    return (_SMEM_MAX // 4 // rows - _cols_stride(0, rows)) // 32 * 32


def _warp_cols_smem_bytes(n: int, rows: int, span: int, run: int) -> int:
    """Shared memory of one K2 'cols' block (mirrors ``cols_words``): the
    warp phase's window and the combine's tile of ``rows`` columns of
    min(n, run) samples over the same words."""
    tile = rows * _cols_stride(min(n, run), rows)
    return 4 * max(_warp_smem_bytes(0, rows, span) // 4, tile)


def _warp_scratch_bytes(n: int, rows: int, blocks: int) -> int:
    """The 'cols' and 'wide' routes' scratch: for each of the 32 x
    ``rows`` pixels of each of ``blocks`` resident blocks an N-sample
    column and two words (its count of covered samples and its output
    offset)."""
    return 4 * (n + 2) * _WARP_BX * rows * blocks


def _warp_wide_smem_total(n: int, rows: int, span: int, run: int) -> int:
    """Shared memory of one K2 'wide' block (mirrors ``wide_words``): its
    warp phase and, over the same words, the combine's: nothing up to
    :data:`_WARP_WIDE_REG_FRAMES` frames (registers), each warp's n x 32
    columns up to :data:`_WARP_WIDE_COL_FRAMES`, else the 'cols' tile of
    8 columns of min(n, run) samples."""
    warp = _warp_wide_smem_bytes(rows, span)
    if n <= _WARP_WIDE_REG_FRAMES:
        tile = 0
    elif n <= _WARP_WIDE_COL_FRAMES:
        tile = _WARP_WIDE_WARPS * n * _WARP_BX
    else:
        tile = _WARP_WIDE_WARPS * _cols_stride(min(n, run), _WARP_WIDE_WARPS)
    return 4 * max(warp // 4, tile)


def _warp_wide_min_blocks(n: int, rows: int, span: int, run: int) -> int:
    """The blocks an SM must keep of K2's 'wide' kernel (mirrors
    ``wide_min_blocks``): 3 where three blocks' shared memory fits an SM's
    233,472 bytes (1 KB of each reserved), 85 registers a thread; else 2,
    128 registers."""
    total = _warp_wide_smem_total(n, rows, span, run)
    return 3 if 3 * (total + 1024) <= 233472 else 2


def _warp_wide_grid(n: int, rows: int, blocks: int, resident: int) -> int:
    """The 'wide' route's grid: the output ``blocks``, at most the
    ``resident`` ones, and no more than a scratch of
    :data:`_WARP_WIDE_SCRATCH_MAX` holds (at least one)."""
    cap = max(1, _WARP_WIDE_SCRATCH_MAX // _warp_scratch_bytes(n, rows, 1))
    return min(blocks, resident, cap)


def warp_combine_cuda(frames, masters, plan, combine: int, lowrank: bool,
                      sigma_lower: float, sigma_upper: float,
                      route: Optional[str] = None):
    """Launch K2 (``csrc/warp_combine.cu``) on a prepared
    ``ops.warp_combine.WarpPlan``; see ``ops.warp_combine.warp_combine``
    for the semantics.  ``route`` ('smem', 'cols' or 'wide') overrides
    :func:`_warp_route`, for the route sweep."""
    dev = frames.device
    n, h0, w0 = frames.shape
    route = route or _warp_route(n, plan.span)
    if route not in warp_route_counts:
        raise ValueError(f"warp_combine kernel has no route {route!r}")
    rows = _warp_block_rows(n, plan.span, route)
    frames, is_u16 = _frames_arg(frames)
    masters = _check(masters, "masters", dev, (3, h0, w0))
    table = _check(plan.table, "plan.table", dev, (n, 16))
    tiles = _check(plan.tiles, "plan.tiles", dev,
                   (n, plan.n_ti * plan.n_tj, 3), dtype=torch.int32)
    out = torch.empty((h0, w0), dtype=torch.float32, device=dev)
    scratch, grid, run = None, 0, 0
    if route != "smem":
        run = _warp_cols_run(_WARP_WIDE_WARPS if route == "wide" else rows,
                             plan.span)
        blocks = (plan.n_tj * -(-plan.tw // _WARP_BX)
                  * plan.n_ti * -(-plan.th // rows))
        resident = _resident_blocks("warp_combine", route, dev, is_u16,
                                    min(n, run), plan.span, rows, run)
        grid = (min(blocks, resident) if route == "cols"
                else _warp_wide_grid(n, rows, blocks, resident))
        scratch = torch.empty((_warp_scratch_bytes(n, rows, grid) // 4,),
                              dtype=torch.float32, device=dev)
    lib = _load()["warp_combine"]
    launch = (lib.warp_combine_wide_launch if route == "wide"
              else lib.warp_combine_launch)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(
        _ptr(frames), is_u16, _ptr(masters), _ptr(table), _ptr(tiles),
        _ptr(out), n, h0, w0, plan.th, plan.tw, plan.n_ti, plan.n_tj,
        plan.span, int(lowrank), combine, sigma_lower, sigma_upper, rows,
        _ptr(scratch), grid, run, ctypes.c_void_p(stream))
    _raise_on(err, "warp_combine")
    _launched("warp_combine", route)
    timing.annotate(route=route, span=plan.span,
                    taps="lowrank" if lowrank else "exact")
    return out


#: K3 sorts N <= 32 samples in registers (padded to 8, 16, 24 or 32);
#: then each thread sorts its pixel's column of shared memory ('smem',
#: blocks of 128 threads, two columns of N x 4 B each: at most 227
#: frames); from _CLIP_COLS_FRAMES a block of 8, 4, 2 or 1 warps keeps
#: its pixels' columns in shared memory and each warp sorts one ('cols');
#: past the reach, where one pixel's two columns outgrow a block, each
#: rank pair is a radix select over the stack ('select')
#: (csrc/clip_combine.cu)
_CLIP_REG_FRAMES = (8, 16, 24, 32)
_CLIP_COLS_WARPS = (8, 4, 2, 1)
_CLIP_SMEM_THREADS = 128
_CLIP_SMEM_FRAMES = _SMEM_MAX // (2 * 4 * _CLIP_SMEM_THREADS)
#: K3 takes 'cols' from this many frames on: chip_smoke.py's route sweep
#: (deep phase, masked 256 x 1024, H100): 'smem' wins at 33, 64 and 128
#: frames (0.11 / 0.18 / 0.85 ms against 0.66 / 0.77 / 1.12), 'cols' from
#: 192 (1.48 / 1.63) on, 2.5-9x from 228, where 'smem' blocks would halve
_CLIP_COLS_FRAMES = 192
#: the route codes of ``clip_combine_launch``
_CLIP_ROUTE_CODES = {"regs": 0, "smem": 1, "cols": 2, "select": 3}


def _clip_cols_smem_bytes(n: int, warps: int) -> int:
    """Shared memory of one K3 'cols' block of ``warps`` pixels (mirrors
    ``cols_smem_bytes``): two columns per pixel, a count per warp and
    pixel, two clip bounds per pixel."""
    return 4 * (2 * warps * _cols_stride(n, warps) + warps * warps
                + 2 * warps)


def _clip_cols_warps(n: int) -> int:
    """Warps (pixels) of a K3 'cols' block: the most whose columns fit,
    0 past the reach."""
    return next((w for w in _CLIP_COLS_WARPS
                 if _clip_cols_smem_bytes(n, w) <= _SMEM_MAX), 0)


#: the reach of K3's 'cols' route: the most frames whose two columns one
#: warp keeps in a block's shared memory (29024)
_CLIP_COLS_REACH = max(n for n in range(32, 32768, 32)
                       if _clip_cols_smem_bytes(n, 1) <= _SMEM_MAX)


#: K3's 'select' route (``clip_select_kernel``): a block of 8 warps owns
#: 32 neighbouring pixels of a row (a 128 B line of each frame row); per
#: pixel a histogram of 256 digit counts; four 8-bit digits for the
#: median's pair of ranks, four for the MAD's, one clip pass (9 passes
#: over the stack whatever the data), the clip pass staging chunks of 64
#: frame rows in two buffers over the histograms' words
_CLIP_SELECT_PIXELS, _CLIP_SELECT_WARPS = 32, 8
_CLIP_SELECT_BINS, _CLIP_SELECT_CHUNK = 256, 64
_CLIP_SELECT_PASSES = 2 * 4 + 1


def _clip_select_smem_bytes() -> int:
    """Shared memory of one K3 'select' block (mirrors ``SelShared``): the
    histograms [256][32] (the clip pass's two chunks of 64 x 32 floats
    over the same words), the six words of a rank pair's state per pixel,
    and the count, median and two clip bounds per pixel."""
    p = _CLIP_SELECT_PIXELS
    hist = _CLIP_SELECT_BINS * p
    chunks = 2 * _CLIP_SELECT_CHUNK * p
    return 4 * (max(hist, chunks) + 6 * p + 4 * p)


def _clip_select_grid(h: int, w: int):
    """The 'select' route's grid (mirrors ``clip_combine_launch``): a
    block per 32 columns, a row of blocks per image row up to 65535 (the
    blocks walk the rest)."""
    return -(-w // _CLIP_SELECT_PIXELS), min(h, 65535)


def _clip_route(n: int) -> str:
    """Which of K3's routes ``n`` frames take: 'regs8', 'regs16',
    'regs24', 'regs32', 'smem', 'cols' or 'select'."""
    if n < 1:
        raise ValueError(f"clip_combine kernel needs at least 1 frame, got {n}")
    for p in _CLIP_REG_FRAMES:
        if n <= p:
            return f"regs{p}"
    if n < _CLIP_COLS_FRAMES:
        return "smem"
    return "cols" if n <= _CLIP_COLS_REACH else "select"


def _clip_smem_threads(n: int) -> int:
    """Threads of a K3 'smem' block (128), whose two columns per thread
    must fit shared memory: at most 227 frames."""
    if not 1 <= n <= _CLIP_SMEM_FRAMES:
        raise ValueError(f"clip_combine 'smem' route takes 1 to "
                         f"{_CLIP_SMEM_FRAMES} frames, got {n}")
    return _CLIP_SMEM_THREADS


def clip_combine_cuda(stack, mask, sigma_lower: float, sigma_upper: float,
                      route: Optional[str] = None):
    """Launch K3 (``csrc/clip_combine.cu``); see
    ``ops.clip_combine.clip_combine`` for the semantics.  ``route``
    ('regs', 'smem', 'cols' or 'select') overrides :func:`_clip_route`,
    for the route sweep."""
    dev = stack.device
    if stack.dim() != 3:
        raise ValueError(f"stack must be (N, H, W), got {tuple(stack.shape)}")
    n, h, w = stack.shape
    route = route or _clip_route(n)      # raises without a frame
    route = "regs" if route.startswith("regs") else route
    if route == "regs" and n > _CLIP_REG_FRAMES[-1]:
        raise ValueError(f"clip_combine 'regs' route takes at most "
                         f"{_CLIP_REG_FRAMES[-1]} frames, got {n}")
    param = {"smem": _clip_smem_threads, "cols": _clip_cols_warps}.get(
        route, lambda n: 0)(n)
    if route == "cols" and param == 0:
        raise ValueError(f"clip_combine 'cols' route takes at most "
                         f"{_CLIP_COLS_REACH} frames, got {n}")
    if stack.dtype != torch.float32:
        raise ValueError(f"stack must be float32, got {stack.dtype}")
    stack = _check(stack, "stack", dev)
    if mask is not None:
        if mask.dtype != torch.bool:
            mask = mask > 0.5
        mask = _check(mask, "mask", dev, (n, h, w), dtype=torch.bool) \
            .view(torch.uint8)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    lib = _load()["clip_combine"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.clip_combine_launch(
        _ptr(stack), _ptr(mask), _ptr(out), n, h, w, sigma_lower,
        sigma_upper, _CLIP_ROUTE_CODES[route], param,
        ctypes.c_void_p(stream))
    _raise_on(err, "clip_combine")
    _launched("clip_combine")
    return out


#: the separable warp's 'smem' tile widths, widest first
#: (csrc/warp_separable.cu): a block takes the widest whose shared memory
#: leaves room for _SEP_BLOCKS_PER_SM blocks an SM (233,472 bytes, 1 KB of
#: each reserved), else the widest that fits a block at all
_SEP_TILE_COLS = (128, 64, 32, 16)
_SEP_BLOCKS_PER_SM = 4
#: past this span the separable warp takes 'scratch' even where a tile
#: fits: a 'smem' block recomputes its band's band + span mid rows, which
#: every band shares with its neighbours, and past it that costs more than
#: the round trip of each mid row through device memory once.
#: tools/warp_separable.py's sweep (24 x 512 x 4096 of 24 x 1024 x 4096,
#: H100): 'smem' wins at spans 12 and 24 (1.71 against 1.96 ms, 2.87
#: against 3.06), ties at 48 (5.41 / 5.37), 'scratch' wins from 64 (7.49
#: / 6.96; 12.59 / 10.21 at 96, 54.55 / 28.72 at 256)
_SEP_SMEM_MAX_SPAN = 48
#: the most bytes the 'scratch' route's mid image holds at once (frames
#: go in chunks)
_SEP_SCRATCH_MAX = 1 << 30
#: the route codes of ``warp_separable_launch``
_SEP_ROUTE_CODES = {"smem": 0, "scratch": 1}


def _warp_separable_smem_bytes(band: int, span: int, channels: int,
                               tw: int) -> int:
    """Shared memory of one 'smem' block of the separable warp (mirrors
    ``smem_words`` in csrc/warp_separable.cu): the band + span mid rows
    of ``tw`` columns in each channel, and each mid row's window start
    and base."""
    rows = band + span
    return 4 * (channels * rows * tw + 2 * rows)


def _warp_separable_tile(band: int, span: int, channels: int) -> int:
    """The columns of a separable warp 'smem' block: the widest of
    :data:`_SEP_TILE_COLS` whose shared memory leaves room for
    :data:`_SEP_BLOCKS_PER_SM` blocks an SM, else the widest that fits a
    block's :data:`_SMEM_MAX`; 0 where not even 16 columns fit."""
    fits = [tw for tw in _SEP_TILE_COLS
            if _warp_separable_smem_bytes(band, span, channels, tw)
            <= _SMEM_MAX]
    roomy = [tw for tw in fits
             if _warp_separable_smem_bytes(band, span, channels, tw) + 1024
             <= 233472 // _SEP_BLOCKS_PER_SM]
    return (roomy or fits or [0])[0]


def _warp_separable_route(band: int, span: int, channels: int) -> str:
    """Which route the separable warp takes for a window of ``span`` past
    bands of ``band`` rows with ``channels`` (1 with analytic coverage, 2
    with the warped ones): 'smem' up to :data:`_SEP_SMEM_MAX_SPAN` where a
    16-column tile fits, else 'scratch'."""
    if span > _SEP_SMEM_MAX_SPAN or _warp_separable_tile(band, span,
                                                         channels) == 0:
        return "scratch"
    return "smem"


def _warp_separable_chunk(n: int, channels: int, h_in: int,
                          w_out: int) -> int:
    """Frames per launch pair of the 'scratch' route: as many as keep its
    mid image (``channels`` x ``h_in`` x ``w_out`` floats a frame) within
    :data:`_SEP_SCRATCH_MAX`, at least one."""
    return max(1, min(n, _SEP_SCRATCH_MAX // (4 * channels * h_in * w_out)))


def warp_separable_cuda(imgs, mats, out_shape, band: int, span: int,
                        analytic_coverage: bool, translation_budget,
                        pad: int, pad_t: int, route: Optional[str] = None):
    """Launch the separable warp (``csrc/warp_separable.cu``) on an (N,
    H, W) float32 stack and its (N, 2, 3) matrices, with the geometry
    ``ops.warp.warp_affine_separable`` resolved (``band``, ``pad``,
    ``pad_t``); returns (warped, coverage), each (N, H_out, W_out).
    ``route`` ('smem' or 'scratch') overrides :func:`_warp_separable_route`,
    for the route sweep."""
    dev = imgs.device
    if imgs.dim() != 3 or imgs.dtype != torch.float32:
        raise ValueError(f"warp_separable kernel takes an (N, H, W) float32 "
                         f"stack, got {tuple(imgs.shape)} {imgs.dtype}")
    n, h_in, w_in = imgs.shape
    if n < 1:
        raise ValueError("warp_separable kernel needs at least 1 frame")
    h_out, w_out = (int(v) for v in out_shape)
    chans = 1 if analytic_coverage else 2
    route = route or _warp_separable_route(band, span, chans)
    if route not in warp_separable_route_counts:
        raise ValueError(f"warp_separable kernel has no route {route!r}")
    tw = 0
    if route == "smem":
        tw = _warp_separable_tile(band, span, chans)
        if tw == 0:
            raise ValueError(f"warp_separable 'smem' route: a window of "
                             f"span {span} past bands of {band} rows does "
                             f"not fit a block of 16 columns in "
                             f"{_SMEM_MAX} B of shared memory")
    imgs = imgs.contiguous()
    mats = _check(mats, "matrices", dev, (n, 2, 3))
    out = torch.empty((n, h_out, w_out), dtype=torch.float32, device=dev)
    cov = torch.empty_like(out)
    chunk, scratch = n, None
    if route == "scratch":
        chunk = _warp_separable_chunk(n, chans, h_in, w_out)
        scratch = torch.empty((chunk * chans * h_in * w_out,),
                              dtype=torch.float32, device=dev)
    budget = -1 if translation_budget is None else int(translation_budget)
    lib = _load()["warp_separable"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for k in range(0, n, chunk):
        m = min(chunk, n - k)
        err = lib.warp_separable_launch(
            _ptr(imgs[k:k + m]), _ptr(mats[k:k + m]), _ptr(out[k:k + m]),
            _ptr(cov[k:k + m]), _ptr(scratch), m, h_in, w_in, h_out, w_out,
            band, span, pad, pad_t, budget, int(analytic_coverage),
            _SEP_ROUTE_CODES[route], tw, ctypes.c_void_p(stream))
        _raise_on(err, "warp_separable")
        for _ in range(1 if route == "smem" else 2):
            _launched("warp_separable", route)
    return out, cov


#: exact detection's tile (csrc/find_exact.cu): 32 x 126 core pixels, which
#: hold at most 16 x 63 peaks (no two peaks are 8-adjacent, so a 2 x 2 cell
#: holds one); the radii with an instance of the kernel (fwhm 2.67 to
#: 11.33); the most stars a frame keeps (the merge block's selection in
#: shared memory)
_FIND_TH, _FIND_TW = 32, 126
_FIND_TILE_PEAKS = (_FIND_TH // 2) * (_FIND_TW // 2)
_FIND_RADII = range(2, 9)
_FIND_MAX_STARS = 2048


def _find_exact_cap(h: int, w: int, k: int) -> int:
    """Candidate slots a frame of ``h`` x ``w`` needs in exact detection's
    buffer: each tile's peaks, or its ``k`` best where it holds more."""
    tiles = -(-h // _FIND_TH) * -(-w // _FIND_TW)
    return tiles * min(k, _FIND_TILE_PEAKS)


def find_exact_cuda(data, taps, r: int, thresholds, mask, max_stars: int,
                    border: int, stats: bool):
    """Launch exact detection (``csrc/find_exact.cu``) on an (N, H, W)
    float32 stack: ``taps`` the (2r + 1)^2 float32 filter of
    ``ops.detect.daofind_kernel``, ``thresholds`` (N,), ``mask`` None or
    bool (H, W), (1, H, W) or (N, H, W) (True = excluded).  Returns the
    ``max_stars`` best peaks of each frame in ``_top_k``'s order, as
    (values (N, k) float32, rows (N, k) int64, columns (N, k) int64;
    -inf at (0, 0) past the last peak) and, with ``stats``, the masked
    density plane (N, H, W), else None."""
    dev = data.device
    if data.dim() != 3 or data.dtype != torch.float32:
        raise ValueError(f"find_exact kernel takes an (N, H, W) float32 "
                         f"stack, got {tuple(data.shape)} {data.dtype}")
    n, h, w = data.shape
    if n < 1 or h * w >= 1 << 31:
        raise ValueError(f"find_exact kernel takes 1 or more frames of "
                         f"fewer than 2**31 pixels, got {tuple(data.shape)}")
    if r not in _FIND_RADII or not 1 <= max_stars <= _FIND_MAX_STARS:
        raise ValueError(f"find_exact kernel takes radii 2 to 8 and 1 to "
                         f"{_FIND_MAX_STARS} stars, got radius {r}, "
                         f"{max_stars} stars")
    if tuple(taps.shape) != (2 * r + 1, 2 * r + 1):
        raise ValueError(f"find_exact taps must be {2 * r + 1} x "
                         f"{2 * r + 1}, got {tuple(taps.shape)}")
    data = data.contiguous()
    thr = _check(thresholds, "thresholds", dev, (n,))
    stride = 0
    if mask is not None:
        if mask.device != dev or mask.dtype != torch.bool:
            raise ValueError(f"mask must be bool on {dev}, got "
                             f"{mask.dtype} on {mask.device}")
        if (mask.dim() not in (2, 3) or tuple(mask.shape[-2:]) != (h, w)
                or (mask.dim() == 3 and mask.shape[0] not in (1, n))):
            raise ValueError(f"mask must be (H, W), (1, H, W) or (N, H, W) "
                             f"of {(n, h, w)}, got {tuple(mask.shape)}")
        if mask.dim() == 3 and mask.shape[0] == n and n > 1:
            stride = h * w
        mask = mask.contiguous().view(torch.uint8)
    par = _params_block(tuple(float(v) for v in taps.reshape(-1)))
    k = max_stars
    cap = _find_exact_cap(h, w, k)
    cand_val = torch.empty((n * cap,), dtype=torch.float32, device=dev)
    cand_pos = torch.empty((n * cap,), dtype=torch.int32, device=dev)
    cand_count = torch.empty((n,), dtype=torch.int32, device=dev)
    dens = (torch.empty((n, h, w), dtype=torch.float32, device=dev)
            if stats else None)
    vals = torch.empty((n, k), dtype=torch.float32, device=dev)
    py = torch.empty((n, k), dtype=torch.int64, device=dev)
    px = torch.empty((n, k), dtype=torch.int64, device=dev)
    lib = _load()["find_exact"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.find_exact_launch(
        _ptr(data), _ptr(mask), stride, _ptr(thr),
        ctypes.cast(par, ctypes.c_void_p), r, n, h, w, border, k,
        _ptr(dens), _ptr(cand_val), _ptr(cand_pos), _ptr(cand_count), cap,
        _ptr(vals), _ptr(py), _ptr(px), ctypes.c_void_p(stream))
    _raise_on(err, "find_exact")
    _launched("find_exact")
    return vals, py, px, dens


def _master(t: Optional[torch.Tensor], name: str, device,
            shape) -> Optional[torch.Tensor]:
    """A calibration master as the kernel takes it: None, or a float32
    tensor of ``shape`` on ``device`` (contiguous); raises on anything
    else, since the twin would broadcast or promote it."""
    if t is None:
        return None
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be float32 {tuple(shape)} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t.contiguous()


def calibrate_cuda(imgs, bias, dark, flat, exp_ratios,
                   dark_still_biased: bool) -> torch.Tensor:
    """Launch calibration (``csrc/calibrate.cu``) on an (N, H, W) uint16
    or float32 stack: ``bias``, ``dark``, ``flat`` None or float32 (H, W),
    ``exp_ratios`` None or (N,) (made float32, as the twin makes it).
    Returns the float32 (N, H, W) stack
    ``ops.calibrate.calibrate_batch_plain`` computes, bit for bit, in one
    launch; the output is the only allocation."""
    dev = imgs.device
    if imgs.dim() != 3 or imgs.dtype not in (torch.uint16, torch.float32):
        raise ValueError(f"calibrate kernel takes an (N, H, W) uint16 or "
                         f"float32 stack, got {tuple(imgs.shape)} "
                         f"{imgs.dtype}")
    n, h, w = imgs.shape
    bias, dark, flat = (_master(m, name, dev, (h, w)) for m, name in
                        ((bias, "bias"), (dark, "dark"), (flat, "flat")))
    er = _check(exp_ratios, "exp_ratios", dev, (n,))
    out = torch.empty((n, h, w), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    imgs = imgs.contiguous()
    lib = _load()["calibrate"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.calibrate_launch(
        _ptr(imgs), int(imgs.dtype == torch.uint16), _ptr(bias), _ptr(dark),
        _ptr(flat), _ptr(er), int(dark_still_biased), n, h * w, _ptr(out),
        ctypes.c_void_p(stream))
    _raise_on(err, "calibrate")
    _launched("calibrate")
    return out
