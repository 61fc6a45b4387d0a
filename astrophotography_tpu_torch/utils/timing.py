"""Structured stage timing, spans and counters.

The reference scatters ad-hoc perf_counter pairs through every class
(SURVEY.md §5 tracing: wall time in api/grey.py:28, MB/s in
file_writer, ms/pixel in ApFixBadPixels, ms/star in ApMeasureStars).
This module centralizes them: a stage timer that logs wall time and
optional MPix/MB throughput, an accumulating report, a torch.profiler
trace hook, and the spans and counters of the program's layers.

Spans and counters record exactly while a ``torch.profiler`` records.
Otherwise :class:`span`, :func:`count` and :func:`host_read` cost one
check of the profiler's flag and record nothing.  While it records, each
span also opens a profiler range of its name, so the device operations
launched inside it lie inside it on the trace's host timeline, and keeps
a record (:func:`records`):

* ``id``, ``parent`` (the innermost span open on the thread when it
  opened, or None) and ``request`` (the id of its root span, shared by
  every span of one call);
* ``name`` (a small fixed set, ``apt.*``) and ``attrs`` (what varies:
  a file, a group; :func:`annotate` adds what the call decides inside
  the span, such as K2's route);
* ``t0`` / ``t1``: host nanoseconds on the clock the profiler stamps host
  events with (the wall clock, ``time.time_ns``), so a record lines up
  with its range on the trace;
* ``counters``: what :func:`count` added while the span was innermost.

A counter's value is a number, or a function of no arguments that gives
one when the records are read: a value that lives on the card is read
after the traced window, so recording adds no device operation and no
host read to it.

The range is the profiler's fast one, a host operation (``cpu_op``), not
``record_function``'s user annotation: the profiler mirrors each user
annotation on the card's timeline as an event as long as the work it
launched, which a trace's reduction would count as device work.  So a
trace holds the same device operations with the program's spans as
without them.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

from .logger import get_logger

logger = get_logger("timing")

#: the most span records kept (the oldest are dropped first): a traced
#: 30 s window of the lean entry closes ~3,300; a record may hold a few
#: small device tensors until it is read or dropped
MAX_RECORDS = 1 << 14


def _profiler_check() -> bool:
    global _profiling
    from torch._C._autograd import _profiler_enabled

    _profiling = _profiler_enabled
    return _profiling()


#: whether a torch profiler records (bound to the profiler's own check on
#: the first call)
_profiling = _profiler_check


class _Open:
    """A span that is open while the profiler records."""

    __slots__ = ("id", "parent", "request", "name", "attrs", "t0",
                 "counters", "range")

    def __init__(self, sid, parent, name, attrs):
        self.id = sid
        self.parent = None if parent is None else parent.id
        self.request = sid if parent is None else parent.request
        self.name, self.attrs = name, attrs
        self.counters: Dict[str, object] = {}
        self.t0 = time.time_ns()
        self.range = _range(name)
        self.range.__enter__()


def _range(name: str):
    """The profiler's range for a span (see the module docstring)."""
    from torch._C._profiler import _RecordFunctionFast

    return _RecordFunctionFast(name)


class Tracer:
    """The spans open on each thread and the records of closed ones."""

    def __init__(self):
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._records: collections.deque = collections.deque(
            maxlen=MAX_RECORDS)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, attrs: dict) -> _Open:
        stack = self._stack()
        sp = _Open(next(self._ids), stack[-1] if stack else None, name, attrs)
        stack.append(sp)
        return sp

    def close(self, sp: _Open) -> None:
        sp.range.__exit__(None, None, None)
        t1 = time.time_ns()
        stack = self._stack()
        if stack and stack[-1] is sp:
            stack.pop()
        elif sp in stack:
            stack.remove(sp)
        rec = {"id": sp.id, "parent": sp.parent, "request": sp.request,
               "name": sp.name, "t0": sp.t0, "t1": t1,
               "counters": sp.counters, "attrs": sp.attrs}
        with self._lock:
            self._records.append(rec)

    def count(self, name: str, value) -> None:
        stack = self._stack()
        if not stack:
            return
        counters = stack[-1].counters
        if callable(value):
            counters.setdefault(name, []).append(value)
        else:
            counters[name] = counters.get(name, 0) + value

    def annotate(self, attrs: dict) -> None:
        stack = self._stack()
        if stack:
            stack[-1].attrs = {**stack[-1].attrs, **attrs}

    def records(self) -> List[dict]:
        """The closed spans' records, oldest first, each counter a
        number (deferred values are read now, once)."""
        with self._lock:
            out = list(self._records)
        for rec in out:
            c = rec["counters"]
            for k, v in c.items():
                if isinstance(v, list):
                    c[k] = sum(f() for f in v)
        return out

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


_TRACER = Tracer()


class span:
    """A span named ``name`` around a block (``with span(...)``) or a
    function (``@span(...)``); ``attrs`` go into its record."""

    __slots__ = ("name", "attrs", "_open")

    def __init__(self, name: str, **attrs):
        self.name, self.attrs, self._open = name, attrs, None

    def __enter__(self):
        if _profiling():
            self._open = _TRACER.open(self.name, self.attrs)
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            _TRACER.close(self._open)
            self._open = None
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiling():
                return fn(*args, **kwargs)
            with span(name, **attrs):
                return fn(*args, **kwargs)
        return spanned


def count(name: str, value=1) -> None:
    """Add ``value`` to counter ``name`` of the innermost open span: a
    number, or a function of no arguments read with the records."""
    if _profiling():
        _TRACER.count(name, value)


def annotate(**attrs) -> None:
    """Add ``attrs`` to the record of the innermost open span: what a
    call decides inside it (a kernel's route).  Nothing while no
    profiler records."""
    if _profiling():
        _TRACER.annotate(attrs)


class _HostRead:
    __slots__ = ("reads", "t0")

    def __init__(self, reads: int):
        self.reads = reads

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _TRACER.count("host_reads", self.reads)
        _TRACER.count("host_read_wait_ns", time.perf_counter_ns() - self.t0)
        return False


_NOTHING = contextlib.nullcontext()


def host_read(where, reads: int = 1):
    """Context manager around a block in which the host waits ``reads``
    times for the device that ``where`` (a tensor or a device) is on: a
    device value read into host memory (``int()``, ``.item()``,
    ``torch.nonzero``), or a copy between pageable host memory and the
    device, which synchronizes the stream.  Counts ``host_reads`` and the
    block's nanoseconds as ``host_read_wait_ns``; nothing on the CPU."""
    if not _profiling() or _on_host(where):
        return _NOTHING
    return _HostRead(reads)


def _on_host(where) -> bool:
    """Whether ``where`` (a tensor or a device) is host memory, whose
    reads wait for nothing."""
    return getattr(where, "device", where).type == "cpu"


def records() -> List[dict]:
    """The records of the spans closed while a profiler recorded (the
    last :data:`MAX_RECORDS`); reading them does not clear them."""
    return _TRACER.records()


def clear_records() -> None:
    _TRACER.clear()


class StageTimer:
    """Accumulates named stage timings; log per stage and as a table.
    Each stage is also the span ``apt.stage.<kind>``."""

    def __init__(self) -> None:
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def stage(self, kind: str, of: str = "", pixels: Optional[int] = None,
              bytes_: Optional[int] = None):
        """Time a stage of ``kind`` ('calibrate', 'register', ...) of
        ``of`` (a file, a group), logged as ``"<kind> <of>"``."""
        t0 = time.perf_counter()
        try:
            with span(f"apt.stage.{kind}", of=of):
                yield
        finally:
            self.add(f"{kind} {of}" if of else kind,
                     time.perf_counter() - t0, pixels, bytes_)

    def add(self, name: str, dt: float, pixels: Optional[int] = None,
            bytes_: Optional[int] = None) -> None:
        """Record a stage timed elsewhere (``dt`` seconds), e.g. the sum
        of a loop's per-item times."""
        rec = {"stage": name, "seconds": dt}
        msg = f"{name}: {dt:.3f} s"
        if pixels:
            rec["gpix_per_s"] = pixels / dt / 1e9
            msg += f" ({rec['gpix_per_s']:.2f} GPix/s)"
        if bytes_:
            rec["mb_per_s"] = bytes_ / dt / 1e6
            msg += f" ({rec['mb_per_s']:.1f} MB/s)"
        self.records.append(rec)
        logger.info(msg)

    def report(self) -> str:
        lines = [f"{'stage':<32} {'seconds':>10} {'GPix/s':>8}"]
        total = 0.0
        for r in self.records:
            total += r["seconds"]
            gpx = f"{r.get('gpix_per_s', 0):.2f}" if "gpix_per_s" in r else ""
            lines.append(f"{r['stage']:<32} {r['seconds']:>10.3f} {gpx:>8}")
        lines.append(f"{'TOTAL':<32} {total:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str] = None):
    """Wrap a block in a torch.profiler trace when a directory is given:
    host and (where there is a card) CUDA activity, written as a Chrome
    trace ``trace.json`` into the directory, with the records of the
    program's spans the block closed in ``spans.json`` beside it (on the
    trace's host clock)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    t_start = time.time_ns()
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        spans = [r for r in records() if r["t0"] >= t_start]
        with open(os.path.join(trace_dir, "spans.json"), "w") as fh:
            json.dump(spans, fh, default=str)
        logger.info(f"Wrote device trace to {trace_dir}")
