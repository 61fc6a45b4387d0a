"""Structured stage timing and throughput counters.

The reference scatters ad-hoc perf_counter pairs through every class
(SURVEY.md §5 tracing: wall time in api/grey.py:28, MB/s in
file_writer, ms/pixel in ApFixBadPixels, ms/star in ApMeasureStars).
This module centralizes them: a stage timer that logs wall time and
optional MPix/MB throughput, an accumulating report, and an optional
torch.profiler trace hook.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

from .logger import get_logger

logger = get_logger("timing")


class StageTimer:
    """Accumulates named stage timings; log per stage and as a table."""

    def __init__(self) -> None:
        self.records: List[Dict] = []

    @contextlib.contextmanager
    def stage(self, name: str, pixels: Optional[int] = None,
              bytes_: Optional[int] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, pixels, bytes_)

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
    trace ``trace.json`` into the directory."""
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
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        logger.info(f"Wrote device trace to {trace_dir}")
