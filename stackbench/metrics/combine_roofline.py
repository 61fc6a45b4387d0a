"""%: the plain clip combine's count-once bound (``counts.combine``, one
band of H / n_bands rows a call) over the device time of the
``combine_band`` span."""

from stackbench import counts
from stackbench.roofline import share


def read(ctx):
    rows = ctx.h // max(ctx.pipeline["n_bands"], 1)
    return share(ctx, "combine_band", counts.combine(ctx.n, rows, ctx.w))
