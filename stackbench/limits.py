"""The readings that a cell's limits are set from: the numbers the check
compares, for the program's stack, for the control's and for planted
faults, seed by seed, at the cell's own size.

    python3 -m stackbench.limits --workload <cell> --seeds 1 2 3 ... \\
        [--fault-seeds 1 2 3]

For each seed it makes the cell's observation on the card, stacks it
once through the cell's entry (as a request of the window does), reads
the registration against the true maps, frees the program's state,
computes the float64 reference and compares.  For a fault seed it also
reads, in the program's place: the control (the reference in bfloat16,
the nearest precision below the configuration's float32); the reference
with the clip left out (a plain mean); and one frame, drawn from the
seed, one pixel off (its registration, and the reference resampling it
there).  One JSON line per seed, with the seconds each part took.  The
benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np


def witness(obs, frames, cfg, h: int, w: int) -> list:
    """The frames' corner errors when the program's other path registers
    them: each calibrated with the reference frame (``calibrate_batch``)
    and solved from exact detection (``register_frames``, the unfused
    path's)."""
    import dataclasses

    import torch

    from astrophotography_tpu_torch.models import pipeline as pl
    from stackbench.reference.stack import corner_errors, maps_of

    other = dataclasses.replace(cfg, detect_mode="vmap", detect_fast=False,
                                detect_bin_rows=False, detect_topk="global",
                                centroid="com")
    out = []
    for f in frames:
        idx = [0, int(f)]
        raw = obs.frames.view(torch.int16)[idx].view(torch.uint16)
        cal = pl.calibrate_batch(raw, obs.bias, obs.dark, obs.flat,
                                 obs.exp_ratios[idx])
        stars, sims, _m, _r = pl.register_frames(cal, other)
        diag = {k: getattr(sims, k).double().cpu().numpy()
                for k in ("scale", "theta", "tx", "ty")}
        out.append(float(corner_errors(maps_of(diag), obs.matrices[idx],
                                       h, w)[1]))
    return out


def _fault_frame(seed: int, n: int) -> int:
    """The frame a fault reading moves: drawn from the seed, never the
    reference frame."""
    return random.Random(seed).randrange(1, n)


def reference_variants(obs, combine: dict, moved: int):
    """(reference, plain, misregistered, regions), float64 (H, W) each:
    the reference stack; the same samples with the clip left out (a plain
    mean); and the reference with frame ``moved`` resampled one pixel off
    in x."""
    import torch

    from stackbench.reference import stack as rs

    n, h, w = obs.frames.shape
    f64 = torch.float64
    cal = rs.calibrate(obs.frames, obs.bias, obs.dark, obs.flat,
                       obs.exp_ratios, f64)
    off = obs.matrices[moved:moved + 1].copy()
    off[0, 0, 2] += 1.0
    images = [torch.zeros((h, w), dtype=f64, device=cal.device)
              for _ in range(3)]
    inside = torch.zeros((h, w), dtype=torch.bool, device=cal.device)
    lo, hi = combine["sigma_lower"], combine["sigma_upper"]
    for y0, y1 in rs.row_blocks(n, h, w):
        samples, ins = rs.resample_rows(cal, obs.matrices, y0, y1, f64)
        images[0][y0:y1] = rs.clip_mean(samples, lo, hi)
        images[1][y0:y1] = samples.mean(dim=0)
        samples[moved] = rs.resample_rows(cal[moved:moved + 1], off, y0, y1,
                                          f64)[0][0]
        images[2][y0:y1] = rs.clip_mean(samples, lo, hi)
        inside[y0:y1] = ins
        del samples
    del cal
    return (*images, rs.regions(obs, inside))


def readings(reg, name: str, seeds, fault_seeds, device="cuda",
             reference=True):
    """Yield one dict of readings per seed."""
    import torch

    from astrophotography_tpu_torch.models import pipeline as pl
    from stackbench.reference.stack import (corner_errors, gaps,
                                            reference_stack)
    from stackbench.run import pack, pipeline_config, solved_maps, unpack

    cell = reg.cell(name)
    config = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    gen = reg.generator(mix["generator"])
    dev = torch.device(device)
    cfg = pipeline_config(config)
    entry = getattr(pl, config["entry"])
    combine = {"method": cfg.combine, "sigma_lower": cfg.sigma_lower,
               "sigma_upper": cfg.sigma_upper}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for seed in seeds:
        out = {"workload": name, "seed": seed}
        t = time.perf_counter()
        obs = gen.inputs(config, mix, seed, dev)
        n, h, w = obs.frames.shape
        image, diag = entry(obs.frames, bias=obs.bias, dark=obs.dark,
                            flat=obs.flat, exp_ratios=obs.exp_ratios,
                            config=cfg)
        keys, flat = pack(torch.isfinite(image).all(), diag)
        image = image.cpu()
        solved = unpack(keys, flat, n)
        maps = solved_maps(solved)
        errs = corner_errors(maps, obs.matrices, h, w)
        out["reg_corner_px"] = float(errs.max())
        worst = np.argsort(errs)[::-1][:3]
        out["worst_frames"] = {int(f): float(errs[f]) for f in worst}
        out["min_inliers"] = int(solved["n_inliers"].min())
        bad = np.nonzero(errs > 1.0)[0]
        if bad.size:
            out["misregistered"] = {
                "frames": bad.tolist(), "corner_px": errs[bad].tolist(),
                "inliers": solved["n_inliers"][bad].tolist(),
                "other_path_corner_px": witness(obs, bad, cfg, h, w)}
        del diag
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        sync()
        out["program_s"] = time.perf_counter() - t
        if not reference:
            del obs, image
            yield out
            continue
        t = time.perf_counter()
        fault = seed in fault_seeds
        if fault:
            moved = _fault_frame(seed, n)
            ref, plain, mis, compared = reference_variants(obs, combine,
                                                           moved)
        else:
            ref, compared = reference_stack(obs, combine)
        sync()
        out["reference_s"] = time.perf_counter() - t
        out["compared_px"] = {k: int(v.sum()) for k, v in compared.items()}
        out["program"] = gaps(image, ref, compared)
        if fault:
            off = maps.copy()
            off[moved, 0, 2] += 1.0
            out["fault_frame"] = moved
            out["plain_mean"] = gaps(plain, ref, compared)
            out["frame_px_off"] = dict(
                gaps(mis, ref, compared), reg_corner_px=float(
                    corner_errors(off, obs.matrices, h, w).max()))
            del plain, mis
            t = time.perf_counter()
            low, _ = reference_stack(obs, combine, dtype=torch.bfloat16)
            out["control"] = gaps(low, ref, compared)
            sync()
            out["control_s"] = time.perf_counter() - t
            del low
        del ref, compared, obs, image
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                    help="seeds that also read the control and the faults")
    ap.add_argument("--registration-only", action="store_true",
                    help="solve and witness only; no reference")
    args = ap.parse_args(argv)
    from stackbench.run import fixed_caches

    fixed_caches()
    from stackbench.registry import Registry

    for out in readings(Registry.load(), args.workload, args.seeds,
                        set(args.fault_seeds),
                        reference=not args.registration_only):
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
