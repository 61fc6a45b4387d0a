"""GPix/s: N * H * W of every stack completed in the window over the
window's wall time (the host clock, from the first call to the last
image on the host)."""

from stackbench.stats import rate


def read(ctx):
    w = ctx.window
    return rate(w.completed * ctx.pixels, w.window_s) / 1e9
