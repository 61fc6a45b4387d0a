"""%: exact detection's count-once bound (``counts_find.find_exact`` at
the configuration's fwhm and max_stars, the whole stack a call) over the
device time of the ``detect_calibrated`` span, whose noise statistics it
holds too."""

from stackbench import counts_find
from stackbench.roofline import share


def read(ctx):
    p = ctx.pipeline
    return share(ctx, "detect_calibrated", counts_find.find_exact(
        ctx.n, ctx.h, ctx.w, p["fwhm"], p["max_stars"]))
