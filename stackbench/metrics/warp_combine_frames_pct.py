"""%: the share of the (frame, tile) pairs K2 was given that it combined,
by the kernel's own rule (the tile's window holds the frame's taps and
the frame's tap body is allowed): 100 * the program's
``warp_combine.frame_tiles_used`` over ``warp_combine.frame_tiles``,
summed over the traced window's stack calls.  A change that skips
frame-tiles reads lower here, not as a faster K2."""

from stackbench.program_spans import stacks, total


def read(ctx):
    calls = stacks(ctx)
    if calls is None:
        return None
    given = sum(total(r, "warp_combine.frame_tiles") for r in calls.values())
    if given == 0:
        return None
    used = sum(total(r, "warp_combine.frame_tiles_used")
               for r in calls.values())
    return 100.0 * used / given
