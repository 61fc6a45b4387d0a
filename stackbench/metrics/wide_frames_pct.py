"""%: the share of the (frame, tile) pairs K2 was given that it combined
on its 'wide' route: ``warp_combine_frames_pct``'s reading (100 * the
program's ``warp_combine.frame_tiles_used`` over
``warp_combine.frame_tiles``, summed over the traced window's stack
calls), for the cells of turned frames.  A change that lets the gate
drop turned frames reads lower here, not as a faster K2."""

from stackbench.metrics.warp_combine_frames_pct import read  # noqa: F401
