"""%: the fused calibrate + warp + clip combine's count-once bound (K2's
work, ``counts.warp_combine``) over the device time of the
``warp_combine`` span."""

from stackbench import counts
from stackbench.roofline import share


def read(ctx):
    return share(ctx, "warp_combine", counts.warp_combine(ctx.n, ctx.h, ctx.w))
