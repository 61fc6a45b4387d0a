"""Summaries of a window's requests, over all of them."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of ``values``: the smallest
    value with at least q % of them at or below it."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(units_done: float, window_s: float) -> float:
    """Units completed over the whole window's wall time."""
    if window_s <= 0:
        raise ValueError("empty window")
    return units_done / window_s
