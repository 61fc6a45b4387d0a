"""ms: the host work one stack call costs: the median, over the traced
window's ``apt.stack`` spans, of the span's host time less the time the
host waited in it for the device (``host_read_wait_ns``), from the
program's own span records."""

import statistics

from stackbench.program_spans import stacks, total


def read(ctx):
    calls = stacks(ctx)
    if calls is None:
        return None
    return statistics.median(
        (recs[0]["t1"] - recs[0]["t0"] - total(recs, "host_read_wait_ns"))
        / 1e6 for recs in calls.values())
