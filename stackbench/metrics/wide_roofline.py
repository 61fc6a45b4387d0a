"""%: K2's count-once bound on its 'wide' route with the 'exact' body
(``counts_wide.wide_exact`` at the configuration's tile and the mix's
turns and dither) over the device time of the ``warp_combine`` span."""

from stackbench import counts_wide
from stackbench.roofline import share


def read(ctx):
    return share(ctx, "warp_combine", counts_wide.wide_exact(
        ctx.n, ctx.h, ctx.w, ctx.pipeline["fused_tile"][0],
        ctx.mix.get("rotation_deg"), ctx.mix.get("dither_px", 0.0)))
