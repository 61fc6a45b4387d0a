"""s: from the harness's start to the window: imports, the card's
context, the kernels loaded (built, in a checkout's first run), the
inputs made on the card and the warm-up requests."""


def read(ctx):
    return ctx.window.setup_s
