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
through the kernels.
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

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
#: kernel name -> its source under csrc/ (one library each)
_SOURCES = {"detect_tiles": "detect_tiles.cu",
            "warp_combine": "warp_combine.cu",
            "clip_combine": "clip_combine.cu"}
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
#: ``-Xptxas -v`` reports each kernel's registers, shared memory, stack
#: frame and spills on stderr, kept in ``build_info["ptxas"]``
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(_SRC))

#: launches of each kernel since the last :func:`reset_launch_counts`
launch_counts = {name: 0 for name in _SOURCES}

_lock = threading.Lock()
_libs: Optional[dict] = None
#: what the last build did: nvcc path, version line, seconds, libraries
build_info: dict = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


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
            fn = libs["warp_combine"].warp_combine_launch
            fn.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i, i, i, i, f,
                           f, i, p, i, p]
            fn.restype = i
            fn = libs["warp_combine"].warp_combine_global_blocks
            fn.argtypes = [i, i, i]
            fn.restype = i
            fn = libs["clip_combine"].clip_combine_launch
            fn.argtypes = [p, p, p, i, i, i, f, f, i, p, i, p]
            fn.restype = i
            fn = libs["clip_combine"].clip_combine_global_blocks
            fn.argtypes = []
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
    """K1's parameter block as a C float array in host memory: the
    launch passes it to the kernel by value."""
    return (ctypes.c_float * len(params))(*params)


#: K1's tile (binned rows x columns), the rolling kernel's columns per
#: thread, its largest block (tile columns) and strip (tiles), and the
#: blocks that fill the card twice over (132 SMs x 3 blocks x 2)
_DET_TTY, _DET_TTX, _DET_CPT = 32, 256, 4
_DET_MAX_TILE_COLS, _DET_MAX_STRIP_TILES, _DET_FILL_BLOCKS = 2, 8, 792
#: the largest filter radius K1 takes, the TPU kernel's reach (its lane
#: filter's 128 columns and its band of 128 binned rows each side), and
#: the largest of the staged-tile route (csrc/detect_tiles.cu)
_DET_MAX_RADIUS, _DET_STAGED_MAX_RADIUS = 128, 16
#: the most bytes the separable route's G and Box planes take at once
#: (frames go in chunks)
_DET_SCRATCH_MAX = 1 << 30


def _detect_route(r: int) -> str:
    """Which of K1's routes filter radius ``r`` takes (mirrors
    ``launch`` in csrc/detect_tiles.cu): 'rolling' for r = 2 and 3,
    'staged' for 1 and 4 to 16, 'separable' for 17 to 128."""
    if not 1 <= r <= _DET_MAX_RADIUS:
        raise ValueError(f"detect_tiles kernel takes filter radii 1 to "
                         f"{_DET_MAX_RADIUS}, got {r}")
    if r in (2, 3):
        return "rolling"
    return "staged" if r <= _DET_STAGED_MAX_RADIUS else "separable"


def _detect_chunk(n: int, h: int, w: int) -> int:
    """Frames per chunk of the separable route: as many as keep the G
    and Box planes (8 B per binned pixel) within 1 GiB, at least one."""
    return max(1, min(n, _DET_SCRATCH_MAX // (8 * (h // 2) * w)))


def _detect_layout(n: int, h: int, w: int) -> dict:
    """The rolling K1 kernel's launch shape for ``n`` frames of ``h`` x
    ``w`` (mirrors ``launch_rolling`` in csrc/detect_tiles.cu): a block
    owns ``tile_cols`` tile columns (the most, up to 2, that divide the
    frame's) with 64 threads each plus 2 halo threads, and walks
    ``strip_tiles`` tiles of 32 binned rows; the strip is halved from 8
    tiles while the grid has fewer blocks than fill the card.  Its shared
    memory is 8 rows of the strip with its halo: two buffers of the G
    and Box rows and a ring of 4 density rows."""
    tyn, txn = h // (2 * _DET_TTY), w // _DET_TTX
    tile_cols = next(k for k in range(_DET_MAX_TILE_COLS, 0, -1)
                     if txn % k == 0)
    strip_tiles = min(_DET_MAX_STRIP_TILES, tyn)

    def blocks(s):
        return n * (txn // tile_cols) * -(-tyn // s)

    while strip_tiles > 1 and blocks(strip_tiles) < _DET_FILL_BLOCKS:
        strip_tiles = (strip_tiles + 1) // 2
    core = _DET_TTX // _DET_CPT * tile_cols
    threads = -(-(core + 2) // 32) * 32
    return {"tile_cols": tile_cols, "strip_tiles": strip_tiles,
            "threads": threads, "segments": -(-tyn // strip_tiles),
            "smem_bytes": 4 * 8 * (_DET_CPT * (core + 2) + 8)}


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
    lay = _detect_layout(n, h, w)
    shape = (n, h // 64, w // 256)
    out_max = torch.empty(shape, dtype=torch.float32, device=dev)
    out_idx = torch.empty(shape, dtype=torch.int32, device=dev)
    out_yoff = torch.empty(shape, dtype=torch.float32, device=dev)
    out_xoff = torch.empty(shape, dtype=torch.float32, device=dev)
    scratch, chunk = None, 0
    if route == "separable":
        chunk = _detect_chunk(n, h, w)
        scratch = torch.empty((2 * chunk * (h // 2) * w,),
                              dtype=torch.float32, device=dev)
    lib = _load()["detect_tiles"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.detect_tiles_launch(
        _ptr(frames), is_u16, _ptr(a), _ptr(mf), _ptr(thr), _ptr(er),
        ctypes.cast(par, ctypes.c_void_p), _ptr(out_max), _ptr(out_idx),
        _ptr(out_yoff), _ptr(out_xoff), n, h, w, r, lay["tile_cols"],
        lay["strip_tiles"], _ptr(scratch), chunk, ctypes.c_void_p(stream))
    _raise_on(err, "detect_tiles")
    launch_counts["detect_tiles"] += 1
    return out_max, out_idx, out_yoff, out_xoff


#: the shared memory one block may use (227 KB)
_SMEM_MAX = 232448
#: the frame counts whose N-sample columns stay in shared memory, K2's
#: and K3's limit from their first designs (2 x 4 B x 32 threads, or
#: 4 B x 64 pixels, per sample); past it both take their 'global' route
_SMEM_FRAMES = _SMEM_MAX // (4 * 64)
#: K2's block: 32 output columns by up to 8 rows (csrc/warp_combine.cu)
_WARP_BX, _WARP_MAX_ROWS = 32, 8


#: (kernel, device index, *arguments) -> blocks of its global route the
#: card keeps resident at once
_resident: dict = {}


def _resident_blocks(kernel: str, dev, *args) -> int:
    """Blocks of a 'global' route the card keeps resident at once (the
    route's grid and scratch slots), from the occupancy API; cached per
    device and arguments."""
    key = (kernel, dev.index, *args)
    if key not in _resident:
        fn = getattr(_load()[kernel], f"{kernel}_global_blocks")
        with torch.cuda.device(dev):
            blocks = fn(*args)
        if blocks < 1:
            raise RuntimeError(f"{kernel}: occupancy query failed ({blocks})")
        _resident[key] = blocks
    return _resident[key]


def _warp_smem_bytes(n: int, rows: int, span: int) -> int:
    """Shared memory of one K2 block of ``rows`` x 32 pixels (mirrors
    ``layout`` in csrc/warp_combine.cu): the N-sample columns (none on the
    global route: pass ``n`` = 0), the calibrated source window, the
    horizontal pass, the tap weights, the ring of frame parameters."""
    bx = _WARP_BX
    wr, wc = rows + span, bx + span
    words = (n * bx * rows + wr * wc + 2 * wr * bx + wr * 8 + wr
             + 2 * 8 * bx + 4 * bx + 3 * 16 + 5 * 20)
    return 4 * words


def _warp_route(n: int, span: int) -> str:
    """Which of K2's routes ``n`` frames with a window of ``span`` take:
    'smem' up to 908 frames where a block of one row keeps its N-sample
    columns and its window in shared memory; 'global' otherwise, the
    columns in a scratch of device memory (the wrapper passes the
    scratch only there, and ``warp_combine_launch`` follows it)."""
    if n <= _SMEM_FRAMES and _warp_smem_bytes(n, 1, span) <= _SMEM_MAX:
        return "smem"
    return "global"


def _warp_block_rows(n: int, span: int) -> int:
    """The most rows (<= 8) a K2 block can have with ``n`` frames on
    their route (the columns count only on the shared route).  Raises
    only for a window that one row on the global route does not fit
    (span past 192)."""
    cols = n if _warp_route(n, span) == "smem" else 0
    for rows in range(_WARP_MAX_ROWS, 0, -1):
        if _warp_smem_bytes(cols, rows, span) <= _SMEM_MAX:
            return rows
    raise ValueError(f"warp_combine kernel: a window of span {span} needs "
                     f"more than {_SMEM_MAX} B of shared memory per block")


def _warp_scratch_bytes(n: int, rows: int, blocks: int) -> int:
    """The global route's scratch: an N-sample column for each of the
    32 x ``rows`` threads of each of ``blocks`` resident blocks."""
    return 4 * n * _WARP_BX * rows * blocks


def warp_combine_cuda(frames, masters, plan, combine: int, lowrank: bool,
                      sigma_lower: float, sigma_upper: float):
    """Launch K2 (``csrc/warp_combine.cu``) on a prepared
    ``ops.warp_combine.WarpPlan``; see ``ops.warp_combine.warp_combine``
    for the semantics."""
    dev = frames.device
    n, h0, w0 = frames.shape
    rows = _warp_block_rows(n, plan.span)
    frames, is_u16 = _frames_arg(frames)
    masters = _check(masters, "masters", dev, (3, h0, w0))
    table = _check(plan.table, "plan.table", dev, (n, 16))
    tiles = _check(plan.tiles, "plan.tiles", dev,
                   (n, plan.n_ti * plan.n_tj, 3), dtype=torch.int32)
    out = torch.empty((h0, w0), dtype=torch.float32, device=dev)
    scratch, grid = None, 0
    if _warp_route(n, plan.span) == "global":
        blocks = (plan.n_tj * -(-plan.tw // _WARP_BX)
                  * plan.n_ti * -(-plan.th // rows))
        grid = min(blocks, _resident_blocks("warp_combine", dev, is_u16,
                                             plan.span, rows))
        scratch = torch.empty((_warp_scratch_bytes(n, rows, grid) // 4,),
                              dtype=torch.float32, device=dev)
    lib = _load()["warp_combine"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.warp_combine_launch(
        _ptr(frames), is_u16, _ptr(masters), _ptr(table), _ptr(tiles),
        _ptr(out), n, h0, w0, plan.th, plan.tw, plan.n_ti, plan.n_tj,
        plan.span, int(lowrank), combine, sigma_lower, sigma_upper, rows,
        _ptr(scratch), grid, ctypes.c_void_p(stream))
    _raise_on(err, "warp_combine")
    launch_counts["warp_combine"] += 1
    return out


#: K3 sorts N <= 32 samples in registers (padded to 8, 16, 24 or 32);
#: up to 908 it keeps two columns of shared memory per thread (frame
#: order and sorted, 4 B per sample each) in blocks of 128, 64 or 32
#: threads; above, both columns in a scratch of device memory, blocks of
#: 128 (csrc/clip_combine.cu)
_CLIP_REG_FRAMES = (8, 16, 24, 32)
_CLIP_THREADS = (128, 64, 32)


def _clip_route(n: int) -> str:
    """Which of K3's routes ``n`` frames take: 'regs8', 'regs16',
    'regs24', 'regs32', 'smem' or 'global' (mirrors
    ``clip_combine_launch``)."""
    for p in _CLIP_REG_FRAMES:
        if n <= p:
            return f"regs{p}"
    return "smem" if n <= _SMEM_FRAMES else "global"


def _clip_smem_bytes(n: int, threads: int) -> int:
    """Dynamic shared memory of one K3 block: none on the register and
    global routes, two N-sample columns per thread on the shared one."""
    return 2 * 4 * n * threads if _clip_route(n) == "smem" else 0


def _clip_block_threads(n: int) -> int:
    """The widest K3 block whose columns fit a block's shared memory
    (128 on the register and global routes)."""
    if n < 1:
        raise ValueError(f"clip_combine kernel needs at least 1 frame, got {n}")
    return next(t for t in _CLIP_THREADS
                if _clip_smem_bytes(n, t) <= _SMEM_MAX)


def _clip_scratch_bytes(n: int, blocks: int) -> int:
    """The global route's scratch: two N-sample columns for each of the
    128 threads of each of ``blocks`` blocks."""
    return 2 * 4 * n * _CLIP_THREADS[0] * blocks


def clip_combine_cuda(stack, mask, sigma_lower: float, sigma_upper: float):
    """Launch K3 (``csrc/clip_combine.cu``); see
    ``ops.clip_combine.clip_combine`` for the semantics."""
    dev = stack.device
    if stack.dim() != 3:
        raise ValueError(f"stack must be (N, H, W), got {tuple(stack.shape)}")
    n, h, w = stack.shape
    threads = _clip_block_threads(n)        # raises without a frame
    if stack.dtype != torch.float32:
        raise ValueError(f"stack must be float32, got {stack.dtype}")
    stack = _check(stack, "stack", dev)
    if mask is not None:
        if mask.dtype != torch.bool:
            mask = mask > 0.5
        mask = _check(mask, "mask", dev, (n, h, w), dtype=torch.bool) \
            .view(torch.uint8)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    scratch, grid_rows = None, 0
    if _clip_route(n) == "global":
        # blocks of 128 columns by grid_rows rows walk the image's rows
        cols = -(-w // threads)
        grid_rows = max(1, min(h, 65535,
                               _resident_blocks("clip_combine", dev) // cols))
        scratch = torch.empty((_clip_scratch_bytes(n, cols * grid_rows) // 4,),
                              dtype=torch.float32, device=dev)
    lib = _load()["clip_combine"]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.clip_combine_launch(
        _ptr(stack), _ptr(mask), _ptr(out), n, h, w, sigma_lower,
        sigma_upper, threads, _ptr(scratch), grid_rows,
        ctypes.c_void_p(stream))
    _raise_on(err, "clip_combine")
    launch_counts["clip_combine"] += 1
    return out
