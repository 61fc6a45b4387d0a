"""%: detection's count-once bound (K1's work on the raw stack,
``counts.detect``) over the device time of the ``detect_lean`` span."""

from stackbench import counts
from stackbench.roofline import share


def read(ctx):
    return share(ctx, "detect_lean",
                 counts.detect(ctx.n, ctx.h, ctx.w, ctx.pipeline["fwhm"]))
