"""count: device operations (kernels, copies, sets) of the traced
window per request, from the profiler's trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.requests == 0 or tr.device_ops == 0:
        return None
    return tr.device_ops / tr.requests
