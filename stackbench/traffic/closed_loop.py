"""One client in a closed loop: the next request goes out when the last
one has come back, as a user re-stacking a night interactively sends
them.  The inputs are made once, from the seed, and every request stacks
them whole.

A mix that uses this generator gives the star field and the frames'
motion (``dither_px``, ``rotation_deg``, ``stars``, ``star_fwhm_px``,
``star_flux_adu``, ``star_edge_px``), the cosmic-ray hits
(``hits_per_mpix``, ``hit_adu``) and how many finished images the check
compares (``sample_images``).
"""

from __future__ import annotations

import sys
import time

from stackbench.workload import make_observation


def inputs(config: dict, mix: dict, seed: int, device):
    """The observation every request stacks."""
    return make_observation(config["frames"], config["height"],
                            config["width"], config["sensor"], mix, seed,
                            device)


def drive(request, seconds: float):
    """Run ``request(i)`` back to back until ``seconds`` have passed.

    ``request`` returns True for an answer that came back sound; one
    that returns False or raises has failed.  Returns (latencies in
    seconds, ok flags, window seconds): the window runs from the first
    request's call to the last one's return, so the last request is
    whole."""
    lat, ok = [], []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            good = bool(request(len(lat)))
        except Exception as exc:            # a failed request counts; go on
            print(f"request {len(lat)} failed: {exc!r}", file=sys.stderr,
                  flush=True)
            good = False
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        ok.append(good)
        if t1 - t_start >= seconds:
            return lat, ok, t1 - t_start
