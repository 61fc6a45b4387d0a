"""GB: the card's allocator peak over the window (reset after the
warm-up), 1e9 bytes a GB; it bounds the night one card can stack."""


def read(ctx):
    return ctx.window.peak_bytes / 1e9
