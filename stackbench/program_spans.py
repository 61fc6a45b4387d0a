"""The program's own span records of a traced window, for the per-layer
metrics that read them.

The program records its spans and counters (``utils.timing.records``)
exactly while a ``torch.profiler`` records, and a traced run profiles
only the window: the warm-up requests run before the profiler starts and
the check after it stops.  So the records the process holds once the
window has closed are the window's.  Each request's spans share the id
of its root, ``apt.stack``.  A program without these records (a version
older than them) gives None, and the metric is left out of the line.
"""

from __future__ import annotations

from collections import defaultdict

ROOT = "apt.stack"


def stacks(ctx):
    """{request id: its records, the root first} for every stack call of
    the traced window, or None where there are none to read."""
    if ctx.trace is None:
        return None
    try:
        from astrophotography_tpu_torch.utils.timing import records
    except ImportError:
        return None
    by_request = defaultdict(list)
    for rec in records():
        by_request[rec["request"]].append(rec)
    out = {}
    for rid, recs in by_request.items():
        root = [r for r in recs if r["id"] == rid]
        if root and root[0]["name"] == ROOT:
            out[rid] = root + [r for r in recs if r["id"] != rid]
    return out or None


def total(recs, counter: str) -> float:
    """Counter ``counter`` summed over records ``recs``."""
    return sum(r["counters"].get(counter, 0) for r in recs)
