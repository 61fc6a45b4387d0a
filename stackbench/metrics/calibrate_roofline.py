"""%: calibration's count-once bound (``counts_calibrate.calibrate`` of
the uint16 stack, the whole stack a call) over the device time of the
``calibrate_batch`` span."""

from stackbench import counts_calibrate
from stackbench.roofline import share


def read(ctx):
    return share(ctx, "calibrate_batch",
                 counts_calibrate.calibrate(ctx.n, ctx.h, ctx.w, 2))
