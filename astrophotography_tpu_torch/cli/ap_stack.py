"""ap_stack: register and sigma-clip stack calibrated FITS frames.

The standalone form of the reference's swarp resample + combine step
(scripts/resample_all.sh:62-79 COMBINE_TYPE / FSCALE handling) over the
device pipeline: star detection, similarity registration, Lanczos3
warp, and sigma-clipped combine on the device — no astrometric solve
required.  Mixed exposures are scaled into the reference frame's flux
units via EXPTIME (swarp FSCALE-from-EXPOSURE, resample_all.sh:300-314).
``--device`` (default cuda) is where the frames are stacked: they land on
it one by one as host threads read them (``core.reduce.load_stack``).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .common import add_device, add_loglevel, cli_main
from ..device import resolve_device, synchronize
from ..io.fits import Header, write_image
from ..ops.register import REJECTED_TRANSLATION
from ..utils.logger import get_logger
from ..utils.timing import StageTimer, span

logger = get_logger("cli.ap_stack")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_stack",
        description="Register + sigma-clip stack calibrated FITS frames")
    p.add_argument("inputs", nargs="+", help="input calibrated FITS frames")
    p.add_argument("-o", "--output", required=True,
                   help="output stacked FITS image")
    p.add_argument("--combine", default="average",
                   choices=("average", "median", "sum"),
                   help="combine method (swarp COMBINE_TYPE; default average)")
    p.add_argument("--sigma", type=float, default=5.0,
                   help="sigma clip bound (default 5)")
    p.add_argument("--engine", default="xla",
                   choices=("xla", "pallas", "fused"),
                   help="combine engine: 'xla' and 'pallas' (one path) = "
                        "the separable warp, then the sigma-clip combine "
                        "kernel for 'average', 'fused' = the memory-lean "
                        "warp+combine kernel")
    p.add_argument("--ref_frame", default="auto",
                   help="registration reference: frame index or 'auto' "
                        "(frame with the most detected stars)")
    p.add_argument("--search_fwhm", type=float, default=3.0)
    p.add_argument("--search_nsigma", type=float, default=7.0)
    p.add_argument("--no-fscale", action="store_true",
                   help="do not scale mixed exposures by EXPTIME")
    p.add_argument("--canvas", default="first", choices=("first", "union"),
                   help="output grid: 'first' = the reference frame's "
                        "pixel grid; 'union' = a canvas covering every "
                        "registered frame (the swarp mosaic behavior)")
    p.add_argument("--weight_out", default=None, metavar="PATH",
                   help="also write the swarp-style coadd weight map "
                        "(sum over contributing frames of their "
                        "resample-footprint coverage, scaled by "
                        "1/fscale^2 when FSCALE applies — the WEIGHTOUT "
                        "image of reference resample_all.sh:342)")
    add_device(p)
    add_loglevel(p)
    return p.parse_args(argv)


def _stack_union_canvas(stack, scales, cfg, timer: StageTimer, name: str):
    """Mosaic-style stacking: output grid = union of every registered
    frame (reference swarp's common output grid, resample_all.sh).

    The data-dependent canvas geometry is resolved on the HOST between
    the two device passes: (1) detection + registration, (2) host
    corner math on the (N, 2, 3) matrices, (3) the separable warp of
    every frame onto the canvas and the sigma-clip combine."""
    from ..models.pipeline import combine_band, register_frames
    from ..ops.warp import warp_affine_separable

    n, h, w = stack.shape
    dev = stack.device
    with timer.stage("register", name):
        if scales is not None:
            stack.mul_(torch.from_numpy(scales).to(dev)[:, None, None])
        stars, sims, matrices, ref_idx = register_frames(stack, config=cfg)
        mats = matrices.cpu().numpy()    # (n, 2, 3): ref -> frame coords
        inl = sims.n_inliers.cpu().numpy()

    # host canvas math: map each registered frame's corners INTO the
    # reference grid (inverse transform) and take the union box
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float64)
    lo = np.array([0.0, 0.0])
    hi = np.array([float(w - 1), float(h - 1)])
    for i in range(n):
        if inl[i] < 4 and i != int(ref_idx):
            continue   # unregistered frames are excluded anyway
        if i != int(ref_idx) and (np.abs(mats[i, :, 2]).max()
                                  > REJECTED_TRANSLATION / 2):
            # registration degeneracy gate (ops/register.py) replaces a
            # rejected solve's translation with the REJECTED_TRANSLATION
            # sentinel even when n_inliers >= 4; folding that into the
            # union box would demand a ~2e9-px canvas.
            logger.warning(f"frame {i}: rejected registration (sentinel "
                           "translation); excluded from the union canvas")
            continue
        A = mats[i, :, :2]
        t = mats[i, :, 2]
        inv = np.linalg.inv(A)
        pts = (corners - t[None, :]) @ inv.T
        lo = np.minimum(lo, pts.min(axis=0))
        hi = np.maximum(hi, pts.max(axis=0))
    x0 = int(np.floor(lo[0])) - 4
    y0 = int(np.floor(lo[1])) - 4
    wc = int(np.ceil(hi[0])) + 5 - x0
    hc = int(np.ceil(hi[1])) + 5 - y0
    wc = -(-wc // 16) * 16   # the canvas quantum
    hc = -(-hc // 16) * 16
    # canvas pixel (xc, yc) = reference pixel (xc + x0, yc + y0):
    # fold the origin shift into each matrix
    shift = np.stack([mats[:, 0, 0] * x0 + mats[:, 0, 1] * y0,
                      mats[:, 1, 0] * x0 + mats[:, 1, 1] * y0], axis=1)
    mats_c = mats.copy()
    mats_c[:, :, 2] += shift

    with timer.stage("combine", f"union {name}", pixels=stack.numel()):
        warped, covers = warp_affine_separable(
            stack, torch.from_numpy(mats_c).to(dev), (hc, wc),
            span=cfg.warp_span, analytic_coverage=True)
        stacked = combine_band(warped, covers, cfg)
        del warped, covers
        synchronize(dev)
    with timer.stage("download", name):
        stacked = stacked.cpu().numpy()
        diag = {"n_inliers": inl, "rms": sims.rms.cpu().numpy(),
                "ref_frame": ref_idx, "canvas_origin": (y0, x0),
                "matrices": mats_c}
    logger.info(f"Union canvas {hc}x{wc} px, origin ({y0}, {x0}) in the "
                f"reference frame's grid")
    return stacked, diag


def _coverage_weight_map(mats, in_shape, out_shape, scales, device,
                         usable=None):
    """swarp WEIGHTOUT map via ops.warp.coverage_weight_map with
    per-frame weights 1 (no FSCALE) or 1/fscale^2; ``usable`` zeroes
    frames that failed registration so the map reflects usable depth."""
    from ..ops.warp import coverage_weight_map

    n = mats.shape[0]
    if scales is None:
        fw = np.ones((n,), np.float32)
    else:
        fw = 1.0 / np.square(np.asarray(scales, np.float32))
    if usable is not None:
        fw = fw * np.asarray(usable, np.float32)
    return coverage_weight_map(
        torch.from_numpy(np.asarray(mats, np.float32)).to(device),
        tuple(int(v) for v in in_shape), tuple(int(v) for v in out_shape),
        torch.from_numpy(fw).to(device)).cpu().numpy()


@span("apt.ap_stack")
def run(ns: argparse.Namespace) -> None:
    from ..core.reduce import load_stack, register_and_stack
    from ..models.pipeline import PipelineConfig

    if len(ns.inputs) < 2:
        raise ValueError("ap_stack needs at least 2 input frames")
    dev = resolve_device(ns.device)
    timer = StageTimer()
    name = os.path.basename(ns.output)
    stack, hdrs = load_stack(ns.inputs, dev, timer, name)
    exps = [float(hdr.get("EXPTIME", 0.0) or 0.0) for hdr in hdrs]
    in_shape = tuple(stack.shape[1:])
    n_frames = stack.shape[0]
    if ns.no_fscale or not exps[0]:
        scales = None
    else:
        scales = np.asarray([exps[0] / e if e else 1.0 for e in exps],
                            np.float32)

    ref_frame = (int(ns.ref_frame)
                 if str(ns.ref_frame).lstrip("-").isdigit()
                 else ns.ref_frame)
    cfg = PipelineConfig(
        fwhm=ns.search_fwhm, detect_nsigma=ns.search_nsigma,
        sigma_lower=ns.sigma, sigma_upper=ns.sigma,
        combine=ns.combine, combine_impl=ns.engine, ref_frame=ref_frame)
    t0 = time.perf_counter()
    if ns.canvas == "union":
        if ns.engine != "xla":
            logger.warning(
                f"--canvas union always uses the plain warp+combine; "
                f"--engine {ns.engine} is ignored (the union path "
                "materializes the warped stack)")
        stacked, diag = _stack_union_canvas(stack, scales, cfg, timer, name)
    else:
        stacked, diag = register_and_stack(stack, scales, cfg, timer, name)
    del stack
    dt = time.perf_counter() - t0

    inl = diag["n_inliers"]
    ref_idx = int(diag["ref_frame"])
    bad = [os.path.basename(ns.inputs[i]) for i in range(len(inl))
           if inl[i] < 4 and i != ref_idx]
    if bad:
        logger.warning(f"{len(bad)} frame(s) registered with < 4 inliers "
                       f"and contribute little or nothing: {bad}")

    # the output grid is the REFERENCE frame's pixel grid (shifted by
    # the canvas origin in union mode), so inherit ITS header — an
    # inherited WCS then describes the output correctly
    out_hdr = hdrs[ref_idx].copy() if hdrs else Header()
    out_hdr["IMAGETYP"] = ("STACK", "Registered stacked image")
    out_hdr["NSTACK"] = (n_frames, "Number of frames in stack")
    if "canvas_origin" in diag:
        cy0, cx0 = diag["canvas_origin"]
        out_hdr["CANVASY0"] = (int(cy0), "Canvas row 0 in reference"
                                        " frame coords")
        out_hdr["CANVASX0"] = (int(cx0), "Canvas col 0 in reference"
                                        " frame coords")
        # keep an inherited WCS valid on the shifted grid:
        # x_canvas = x_ref - x0  =>  CRPIX += -origin
        if "CRPIX1" in out_hdr and "CRPIX2" in out_hdr:
            out_hdr["CRPIX1"] = float(out_hdr["CRPIX1"]) - float(cx0)
            out_hdr["CRPIX2"] = float(out_hdr["CRPIX2"]) - float(cy0)
            out_hdr.add_history(
                f"CRPIX shifted by ({-cx0}, {-cy0}) for the union canvas")
    if exps[0]:
        out_hdr["EXPTOTAL"] = (float(np.sum(exps)),
                               "[s] Total stacked exposure")
    for i, path in enumerate(ns.inputs):
        out_hdr[f"ISTK{i:04d}"] = os.path.basename(path)
    out_hdr.add_history(
        f"ap_stack: {n_frames} frames, combine={ns.combine}, "
        f"sigma={ns.sigma}, engine={ns.engine}, ref={ref_idx}")
    with timer.stage("write", name):
        write_image(ns.output, stacked, out_hdr)
    if ns.weight_out:
        # frames with < 4 inliers (except the reference) registered
        # unreliably and contribute little or nothing to the combine —
        # zero their weight so the map reflects usable depth, matching
        # the union-canvas path's rejection behavior
        usable = inl >= 4
        usable[ref_idx] = True
        with timer.stage("weight map", name):
            wmap = _coverage_weight_map(diag["matrices"], in_shape,
                                        stacked.shape, scales, dev,
                                        usable=usable)
            whdr = out_hdr.copy()
            whdr["IMAGETYP"] = ("STACK WEIGHT", "Coadd weight map")
            whdr.add_history(
                f"ap_stack weight map for {os.path.basename(ns.output)} "
                "(sum of frame coverage x 1/fscale^2)")
            write_image(ns.weight_out, wmap, whdr)
        logger.info(f"Wrote weight map {ns.weight_out} "
                    f"(max {wmap.max():.3f})")
    rms = diag["rms"]
    others = np.delete(rms, ref_idx) if len(rms) > 1 else rms
    logger.info(f"Stacked {n_frames} frames -> {ns.output} "
                f"(ref frame {ref_idx}, reg rms median "
                f"{np.median(others):.3f} px, {dt:.2f} s)")
    logger.info("Stage timings:\n" + timer.report())


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
