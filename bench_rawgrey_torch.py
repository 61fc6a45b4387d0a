#!/usr/bin/env python3
"""Benchmark of the port's RAW -> greyscale FITS conversion, frames/s:
the twin of ``bench_rawgrey.py``.

End-to-end file-to-file ``dksraw grey`` throughput over a directory of
DNGs (one synthetic sky mosaic, lossless-JPEG encoded once and written
to every file): the host decode in a thread (``io.raw.load_raw``), the
conversion on the card (``RawConv.grey``: black level, daylight white
balance, demosaic, luma; the uint16 result stays on the card) and the
FITS writes in ``parallel.AsyncWriter``'s thread.  One warm pass, then
the median of ``max(repeats, 3)`` passes with their spread.

Prints ONE JSON line: ``metric``, ``value`` (frames/s), ``unit``,
``vs_baseline`` (null: the reference publishes no figure), ``method``,
``spread``, ``decode_s_per_frame`` (the decode thread's own clock, the
median over the timed passes) and ``device`` (the card's name, power
limit and count).  Environment: ``BENCH_RAW_FRAMES`` (24),
``BENCH_RAW_SIZE`` (square mosaic edge, 3904), ``BENCH_REPEATS`` (3),
``BENCH_RAW_COMPRESSION`` (7 = camera-style lossless-JPEG strips,
1 = uncompressed).  Run from the repository root on a machine with a
CUDA card: ``python3 bench_rawgrey_torch.py``.  Without a card it
raises before printing any line.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import sys
import tempfile
import threading
import time

import numpy as np

from astrophotography_tpu_torch.device import device_info, resolve_device

#: the black level of every channel of the synthetic DNGs
BLACK = 128


def write_dngs(directory: str, n_frames: int, size: int,
               compression: int = 7):
    """``bench_rawgrey.py``'s DNG set: one size x size uint16 mosaic of
    sky statistics (``default_rng(0)``, normal(900, 35)), black levels
    128, its lossless-JPEG strip encoded once and written to ``n_frames``
    files ``f000.dng``... in ``directory``.  Returns (mosaic, paths)."""
    from astrophotography_tpu_torch.io.losslessjpeg import encode_lossless_jpeg
    from astrophotography_tpu_torch.io.raw import write_dng

    rng = np.random.default_rng(0)
    base = np.clip(rng.normal(900.0, 35.0, (size, size)),
                   0, 65535).astype(np.uint16)
    payload = encode_lossless_jpeg(base) if compression == 7 else None
    paths = []
    for i in range(n_frames):
        p = os.path.join(directory, f"f{i:03d}.dng")
        write_dng(p, base, black_levels=(BLACK,) * 4,
                  compression=compression, strip_payload=payload)
        paths.append(p)
    return base, paths


def _convert_all(paths, dev) -> dict:
    """One pass of the three-stage loop over ``paths``: decode thread ->
    ``RawConv.grey`` on ``dev`` -> writer thread.  A failure in any stage
    raises here.  Returns the pass's seconds and the decode thread's
    busy seconds."""
    from astrophotography_tpu_torch.core.raw_conv import RawConv
    from astrophotography_tpu_torch.io.fits import Header
    from astrophotography_tpu_torch.io.raw import load_raw
    from astrophotography_tpu_torch.parallel import AsyncWriter

    t_start = time.perf_counter()
    decoded: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()
    busy = {"decode_s": 0.0}

    def decode_ahead():
        try:
            for p in paths:
                if stop.is_set():
                    return
                t = time.perf_counter()
                raw = load_raw(p)
                busy["decode_s"] += time.perf_counter() - t
                decoded.put((p, raw))
        except BaseException as exc:    # handed to the loop, which raises it
            decoded.put(exc)
            return
        decoded.put(None)

    thread = threading.Thread(target=decode_ahead, daemon=True)
    writer = AsyncWriter()
    thread.start()
    try:
        while True:
            item = decoded.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            p, raw = item
            conv = RawConv(p, raw_image=raw, device=dev)
            img, _exif = conv.grey(wb_method="daylight", renorm=False,
                                   fetch=False)
            writer.submit(p[:-4] + ".fits", img, Header())
    finally:
        stop.set()
        while thread.is_alive():        # free a decoder blocked on put
            while not decoded.empty():
                decoded.get_nowait()
            thread.join(0.01)
        writer.close()                  # drains; raises the first write error
    return {"seconds": time.perf_counter() - t_start,
            "decode_s": busy["decode_s"]}


def run(n_frames: int, size: int, repeats: int, compression: int = 7,
        device=None) -> dict:
    """End-to-end RAW -> grey FITS conversion on ``device`` (the card when
    None); returns the result line.  The DNGs and FITS live in a temp
    directory that is removed on the way out."""
    from astrophotography_tpu_torch.core.raw_conv import RawConv
    from astrophotography_tpu_torch.io.fits import read_image

    dev = resolve_device(device)
    tmp = tempfile.mkdtemp(prefix="bench_rawgrey_")
    try:
        _base, paths = write_dngs(tmp, n_frames, size, compression)
        _convert_all(paths, dev)                       # warm
        k = max(repeats, 3)
        passes = [_convert_all(paths, dev) for _ in range(k)]
        # the last pass wrote every file: each holds its frame's
        # conversion (one mosaic, so one image)
        want, _exif = RawConv(paths[0], device=dev).grey(
            wb_method="daylight", renorm=False)
        for p in paths:
            got, _hdr = read_image(p[:-4] + ".fits", as_float32=False)
            if got.dtype != np.uint16 or not np.array_equal(got, want):
                raise RuntimeError(f"check failed: RAW->grey: {p[:-4]}.fits "
                                   "does not hold its mosaic's conversion")
    finally:
        shutil.rmtree(tmp)
    fps_runs = sorted(n_frames / r["seconds"] for r in passes)
    mpix = size * size / 1e6
    return {
        "metric": f"RAW->grey FITS frames/s ({n_frames}x{mpix:.1f}Mpix "
                  f"{'lossless-JPEG ' if compression == 7 else ''}DNG)",
        "value": float(np.median(fps_runs)),
        "unit": "frames/s",
        "vs_baseline": None,
        "method": f"median of {k} repeats",
        "spread": {"min": fps_runs[0], "max": fps_runs[-1]},
        "decode_s_per_frame": float(np.median(
            [r["decode_s"] for r in passes])) / n_frames,
        "device": device_info(dev),
    }


def main() -> int:
    resolve_device(None)                # raises without a usable card
    result = run(
        n_frames=int(os.environ.get("BENCH_RAW_FRAMES", "24")),
        size=int(os.environ.get("BENCH_RAW_SIZE", "3904")),
        repeats=int(os.environ.get("BENCH_REPEATS", "3")),
        compression=int(os.environ.get("BENCH_RAW_COMPRESSION", "7")))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
