"""ms: the 95th percentile (nearest rank) of the latency of every request
in the window, from the call to the image on the host; a failed request
counts as the whole window."""

from stackbench.stats import percentile


def read(ctx):
    return percentile(ctx.window.latencies_s, 95.0) * 1e3
