"""A layer's share of its roofline: the count-once bound of the work its
span's calls did (``stackbench.counts``) over the device time of what
those calls launched."""

from __future__ import annotations

from stackbench import counts


def share(ctx, span: str, work_per_call: tuple):
    """100 * calls * bound(work) / the span's device time, or None where
    the traced window holds no call of ``span``."""
    tr = ctx.trace
    if tr is None:
        return None
    t = tr.span_device_s.get(span, 0.0)
    calls = tr.span_calls.get(span, 0)
    if t <= 0.0 or calls == 0:
        return None
    return 100.0 * calls * counts.bound_s(*work_per_call) / t
