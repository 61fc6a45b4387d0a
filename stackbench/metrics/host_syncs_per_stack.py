"""count: the times one stack call's host waits for the device (a device
value read into host memory, or a copy that synchronizes the stream):
the program's ``host_reads`` counters over the traced window's
``apt.stack`` spans."""

from stackbench.program_spans import stacks, total


def read(ctx):
    calls = stacks(ctx)
    if calls is None:
        return None
    return sum(total(recs, "host_reads") for recs in calls.values()) \
        / len(calls)
