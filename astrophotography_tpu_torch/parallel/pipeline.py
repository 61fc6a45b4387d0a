"""Host <-> device I/O pipeline: threaded prefetch + async staging.

The reference reads one FITS file at a time, synchronously, between
every compute stage (every stage boundary is a file on disk,
SURVEY.md §3.5).  At >1 GPix/s device throughput the pipeline is
disk-bound unless I/O overlaps compute (BASELINE.json north star:
"double-buffered host-to-device pipeline so calibration arithmetic
never stalls on disk").

Components:

* :class:`PrefetchLoader` — a bounded thread pool decodes FITS/RAW
  files ahead of consumption, preserving order; decode (gzip, byteswap,
  scaling) happens on host threads while the device computes;
* :func:`stream_stacks` — groups frames into device-resident (N, H, W)
  chunks, copying chunk k+1 from a pinned host buffer on a copy stream
  while chunk k is being consumed;
* :class:`AsyncWriter` — a writer thread so FITS encode/compression of
  outputs never blocks the compute loop.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import native_contiguous, resolve_device
from ..io.fits import Header, read_image, write_image
from ..utils.logger import get_logger

logger = get_logger("parallel.pipeline")


class PrefetchLoader:
    """Ordered, bounded prefetch of decoded frames.

    ``depth`` bounds how many frames are decoded ahead (memory bound =
    depth * frame size); ``workers`` host threads run the decode.
    """

    def __init__(
        self,
        paths: Sequence[str],
        reader: Callable[[str], Tuple[np.ndarray, Header]] = read_image,
        depth: int = 4,
        workers: int = 4,
    ) -> None:
        self._paths = list(paths)
        self._reader = reader
        self._depth = max(1, depth)
        self._workers = max(1, workers)

    def __len__(self) -> int:
        return len(self._paths)

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray, Header]]:
        if not self._paths:
            return
        with ThreadPoolExecutor(max_workers=self._workers) as pool:
            futures = {}
            next_submit = 0
            for _ in range(min(self._depth, len(self._paths))):
                futures[next_submit] = pool.submit(self._reader,
                                                   self._paths[next_submit])
                next_submit += 1
            for i in range(len(self._paths)):
                data, hdr = futures.pop(i).result()
                if next_submit < len(self._paths):
                    futures[next_submit] = pool.submit(
                        self._reader, self._paths[next_submit])
                    next_submit += 1
                yield self._paths[i], data, hdr


def stream_stacks(
    paths: Sequence[str],
    chunk: int = 8,
    depth: int = 4,
    workers: int = 4,
    device=None,
):
    """Yield device-resident (n<=chunk, H, W) stacks with overlap, as
    ``(names, tensor, headers)``, on ``device`` (CUDA when not given).

    The next chunk's host decode and device transfer proceed while the
    caller computes on the current chunk: the loader threads run
    concurrently, and on a CUDA device the chunk is assembled in one of
    two pinned host buffers and copied with ``non_blocking=True`` on a
    copy stream.  The consumer's stream waits on the copy's event before
    the chunk is handed over; a pinned buffer is filled again only after
    the event of the copy that last read it has completed.
    """
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        copy_stream = torch.cuda.Stream(dev)
        pinned: List[Optional[torch.Tensor]] = [None, None]
        copied: List[Optional[torch.cuda.Event]] = [None, None]
    n_chunks = 0

    def upload(frames: List[np.ndarray]):
        """(tensor on ``dev``, event of its copy or None)."""
        nonlocal n_chunks
        if not on_card:
            return torch.from_numpy(
                np.stack([native_contiguous(f) for f in frames])), None
        slot = n_chunks % 2
        n_chunks += 1
        if copied[slot] is not None:
            copied[slot].synchronize()
        first = frames[0]
        dtype = torch.from_numpy(
            np.empty(0, first.dtype.newbyteorder("="))).dtype
        full = (chunk,) + first.shape
        buf = pinned[slot]
        if buf is None or tuple(buf.shape) != full or buf.dtype != dtype:
            buf = pinned[slot] = torch.empty(full, dtype=dtype,
                                             pin_memory=True)
        part = buf[:len(frames)]            # the last chunk may be short
        host = part.numpy()
        for i, frame in enumerate(frames):
            host[i] = frame                 # converts the byte order too
        with torch.cuda.stream(copy_stream):
            t = part.to(dev, non_blocking=True)
            event = torch.cuda.Event()
            event.record(copy_stream)
        copied[slot] = event
        return t, event

    loader = iter(PrefetchLoader(paths, depth=depth, workers=workers))

    def next_chunk():
        frames: List[np.ndarray] = []
        headers: List[Header] = []
        names: List[str] = []
        for _ in range(chunk):
            try:
                path, data, hdr = next(loader)
            except StopIteration:
                break
            names.append(path)
            frames.append(data)
            headers.append(hdr)
        if not frames:
            return None
        stack, event = upload(frames)        # async transfer
        return names, stack, headers, event

    pending = next_chunk()
    while pending is not None:
        upcoming = next_chunk()   # overlaps with caller's compute
        names, stack, headers, event = pending
        if event is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(event)
            # the chunk was allocated on the copy stream: tell the
            # allocator the consumer's stream uses it too
            stack.record_stream(consumer)
        yield names, stack, headers
        pending = upcoming


class AsyncWriter:
    """Background FITS writer; call close() to drain."""

    def __init__(self, maxsize: int = 8) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self._errors: List[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            path, data, header = item
            try:
                if isinstance(data, torch.Tensor):
                    # the device->host pull happens here, in the worker
                    data = data.cpu().numpy()
                write_image(path, np.asarray(data), header)
            except BaseException as exc:  # surfaced on close()
                logger.error(f"async write of {path} failed: {exc}")
                self._errors.append(exc)

    def submit(self, path: str, data: np.ndarray,
               header: Optional[Header] = None) -> None:
        # data may be a tensor still on the device: the worker's
        # .cpu() performs the device->host pull, so the pull overlaps
        # the caller's next upload/dispatch instead of serializing with
        # it.  Hand a tensor over only after the work that fills it has
        # been enqueued on the current stream.
        self._q.put((path, data, header))

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        if self._errors:
            raise self._errors[0]

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
