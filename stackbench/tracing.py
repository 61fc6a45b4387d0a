"""Spans from the benchmark's own files, and the reduction of a
``torch.profiler`` trace to per-span device time, busy time and idle
gaps.

The program is not edited: :class:`Spans` swaps the functions the
configuration names in a module's namespace for wrappers that open a
``torch.profiler.record_function`` range of the function's name, and
puts them back afterwards.  A device operation (kernel, copy, set)
belongs to the span that was open on the host when the host operation
launched it: the profiler gives each device operation the id of the
runtime call that launched it (else of the operator it ran in), and
that call's start lies inside the span's interval on its thread.  So a layer's device time is
the time of whatever its calls launched, whichever kernels they are.
"""

from __future__ import annotations

import bisect
import functools
import importlib
from collections import defaultdict
from dataclasses import dataclass, field

import torch

REQUEST = "stackbench.request"
DOWNLOAD = "stackbench.download"
#: the profiler's kinds of host event that device operations link to
_HOST_OPS = ("cpu_op", "user_annotation")


def _kind(e, names) -> str:
    """'op' for an operator or a span, 'runtime' for a runtime or driver
    call, 'other' for the rest of the host's events; 'device' for an
    operation of the card, 'mirror' for the profiler's copy of a span on
    the card's timeline.  Where the profiler does not give an event's
    kind, it is told by its name: operators are ``aten::``, spans and
    their mirrors carry the spans' names, and runtime and driver calls
    start with ``cuda`` or ``cu``."""
    name = e.name()
    kind = getattr(e, "activity_type", None)
    kind = kind() if kind is not None else None
    if e.device_type() == torch.autograd.DeviceType.CPU:
        if kind in _HOST_OPS or name.startswith("aten::") or name in names:
            return "op"
        if kind in ("cuda_runtime", "cuda_driver") or name.startswith("cu"):
            return "runtime"
        return "other"
    if kind == "gpu_user_annotation" or name in names:
        return "mirror"
    return "device"


class Spans:
    """Context manager: ``names`` of ``module`` wrapped in spans."""

    def __init__(self, module: str, names):
        self.module = importlib.import_module(module)
        self.names = list(names)
        self.saved = {}

    def __enter__(self):
        for name in self.names:
            fn = getattr(self.module, name)
            self.saved[name] = fn
            setattr(self.module, name, _spanned(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)
        self.saved.clear()


def _spanned(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def profiler():
    """A profiler of host operations and, where there is a card, of the
    card's."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


@dataclass
class Trace:
    """What a traced window gives the per-layer metrics."""

    window_s: float = 0.0
    busy_s: float = 0.0
    requests: int = 0
    device_ops: int = 0
    unlinked_ops: int = 0
    span_device_s: dict = field(default_factory=dict)
    span_calls: dict = field(default_factory=dict)
    op_s: dict = field(default_factory=dict)
    idle_by_host: dict = field(default_factory=dict)

    def breakdown(self) -> dict:
        top = sorted(self.op_s.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in idle]}


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class _Intervals:
    """Closed host intervals of one name on one thread, for lookups."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _e in self.spans]

    def holding(self, t):
        """The start of the interval that holds ``t``, else None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][0] <= t <= self.spans[i][1]:
            return self.spans[i][0]
        return None


def reduce(prof, span_names) -> Trace:
    """The :class:`Trace` of a finished profiler run whose requests each
    lie inside a :data:`REQUEST` span."""
    names = set(span_names) | {REQUEST, DOWNLOAD}
    host = {}                         # operator's id -> (start, tid)
    launch = {}                       # runtime call's id -> (start, tid)
    spans = defaultdict(list)         # name -> [(start, end, tid)]
    device = []                       # (start, end, name, id, linked id)
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        kind = _kind(e, names)
        if kind == "op":
            host[e.correlation_id()] = (start, e.start_thread_id())
            if e.name() in names:
                spans[e.name()].append((start, start + dur,
                                        e.start_thread_id()))
        elif kind == "runtime":
            launch[e.correlation_id()] = (start, e.start_thread_id())
        elif kind == "device":
            device.append((start, start + dur, e.name(), e.correlation_id(),
                           e.linked_correlation_id()))
    tr = Trace()
    req = sorted(spans.get(REQUEST, []))
    if not req:
        return tr
    w0, w1 = req[0][0], max(e for _s, e, _t in req)
    tr.window_s = (w1 - w0) / 1e9
    tr.requests = len(req)
    lookup = {}
    for name in names:
        by_tid = defaultdict(list)
        for s, e, tid in spans.get(name, []):
            by_tid[tid].append((s, e))
        lookup[name] = {t: _Intervals(v) for t, v in by_tid.items()}
        tr.span_calls[name] = len(spans.get(name, []))
    dev_s = defaultdict(float)
    op_s = defaultdict(float)
    busy = []
    for s, e, name, corr, link in device:
        if e <= w0 or s >= w1:
            continue
        tr.device_ops += 1
        op_s[name] += (e - s) / 1e9
        busy.append((max(s, w0), min(e, w1)))
        origin = launch.get(corr) or host.get(link)
        if origin is None:
            tr.unlinked_ops += 1
            continue
        t, tid = origin
        for span, by_tid in lookup.items():
            iv = by_tid.get(tid)
            if iv is not None and iv.holding(t) is not None:
                dev_s[span] += (e - s) / 1e9
    merged = _union(busy)
    tr.busy_s = sum(e - s for s, e in merged) / 1e9
    tr.span_device_s = dict(dev_s)
    tr.op_s = dict(op_s)
    # idle gaps of the device, named by the innermost span open on the
    # host (the requests' thread) when each began
    tid0 = req[0][2]
    idle = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        label, latest = "outside spans", None
        for n in names:
            iv = lookup[n].get(tid0)
            start = None if iv is None else iv.holding(gs)
            if start is not None and (latest is None or start > latest):
                label, latest = n, start
        idle[label] += (ge - gs) / 1e9
    tr.idle_by_host = dict(idle)
    return tr
