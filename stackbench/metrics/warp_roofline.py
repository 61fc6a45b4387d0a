"""%: the plain separable warp's count-once bound (``counts.warp``, one
band of H / n_bands rows a call) over the device time of the
``warp_band`` span."""

from stackbench import counts
from stackbench.roofline import share


def read(ctx):
    rows = ctx.h // max(ctx.pipeline["n_bands"], 1)
    return share(ctx, "warp_band", counts.warp(ctx.n, rows, ctx.w))
