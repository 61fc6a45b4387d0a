"""Batch reduction driver: the Python replacement for the bash L5 layer.

The reference drives multi-file reduction with bash scripts —
calibrate_all.sh (per-target/filter calibrate + metadata + optional
sky-background subtraction), navigate_all.sh (find stars + astrometry +
quality summary), resample_all.sh / composite_all.sh (swarp stacking,
stiff composites) — explicitly flagged as temporary non-Python
implementations (reference doc/iTelescope_processing.md:24-34).  This
module is the first-class replacement:

* scan a directory of light frames, group by target:telescope:filter
  (headers first, iTelescope filename parsing as fallback);
* per group: calibrate (device kernel), optional sky-background
  subtraction, star finding + quality reports, an optional per-image
  astrometric WCS stage (navigate_all.sh:5-20 parity — nav-*.fits
  WCS-stamped images + ra/dec source columns, via per-image
  nova solves or network-free registration against a WCS-bearing
  anchor frame), then one fused register+stack on device with
  per-frame exposure weights (the FSCALE-from-EXPOSURE behavior of
  resample_all.sh:300-314); the stack inherits the reference frame's
  solved WCS;
* ``noclean`` idempotency: outputs that already exist are skipped
  (reference calibrate_all.sh clean/noclean handling), giving
  file-level checkpoint/resume exactly like the reference
  (SURVEY.md §5 checkpoint/resume).

The JAX package's ``core/reduce.py``.  ``device`` (CUDA when not given)
is where calibration, star finding, registration and the stack run.  A
group's calibrated frames land on the device one by one, as the loader
threads read them, in one preallocated (N, H, W) tensor.  Every stage the
:class:`StageTimer` times ends in a download or a synchronize, so its
host-clock seconds include its device work: calibrate / quality per
light, navigate per group, read / upload / register / combine /
download / weight map / write per stack.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import native_contiguous, resolve_device, synchronize
from ..io.fits import Header, read_image, write_image
from ..utils.logger import get_logger
from ..utils.timing import StageTimer, count, host_read, span
from .calibrator import Calibrator, find_exptime
from .metadata import parse_itelescope_filename

logger = get_logger("core.reduce")


@dataclasses.dataclass
class LightFrame:
    path: str
    target: str
    telescope: str
    filter: str
    exptime: float


def classify_light(path: str) -> LightFrame:
    """Target/telescope/filter/exptime from headers, filename fallback."""
    _, hdr = read_image(path)
    target = hdr.get("OBJECT")
    telescope = hdr.get("TELESCOP")
    filt = hdr.get("FILTER")
    exptime = find_exptime(hdr) or 1.0
    if target is None or telescope is None:
        try:
            t, _obs, tgt = parse_itelescope_filename(os.path.basename(path))
            telescope = telescope or t
            target = target or tgt
        except RuntimeError:
            pass
    return LightFrame(path=path,
                      target=str(target or "unknown"),
                      telescope=str(telescope or "unknown"),
                      filter=str(filt or "unknown"),
                      exptime=float(exptime))


def scan_lights(datadir: str, pattern: str = "*.fit*") -> List[LightFrame]:
    """Classify all light frames; unreadable files are skipped with a
    warning (per-frame error isolation, SURVEY.md §5)."""
    paths = sorted(p for p in glob.glob(os.path.join(datadir, pattern))
                   if os.path.isfile(p))
    lights: List[LightFrame] = []
    for p in paths:
        try:
            lights.append(classify_light(p))
        except Exception as exc:
            logger.error(f"Skipping unreadable frame {p}: "
                         f"{type(exc).__name__}: {exc}")
    return lights


def group_lights(lights: List[LightFrame]) -> Dict[Tuple[str, str, str],
                                                   List[LightFrame]]:
    groups: Dict[Tuple[str, str, str], List[LightFrame]] = {}
    for lf in lights:
        groups.setdefault((lf.target, lf.telescope, lf.filter), []).append(lf)
    return groups


def find_masters(caldir: str, filt: Optional[str] = None) -> Dict[str, Optional[str]]:
    """Locate master calibration files in a library directory.

    Conventions: master_bias*.fits, master_dark*.fits,
    master_flat_<FILTER>*.fits (or master_flat*.fits), master_badpix*.fits
    (the directory-layout role of reference
    doc/iTelescope_processing.md:95-151).
    """
    def first(*patterns):
        for pat in patterns:
            hits = sorted(glob.glob(os.path.join(caldir, pat)))
            if hits:
                return hits[0]
        return None

    flat = None
    if filt:
        flat = first(f"master_flat_{filt}*.fits", f"master_flat-{filt}*.fits")
        if flat is None:
            # Only the exact unfiltered name is a safe fallback; a glob
            # would silently match another filter's flat (e.g.
            # master_flat_R.fits applied to a V-band group).
            flat = first("master_flat.fits")
            others = glob.glob(os.path.join(caldir, "master_flat*.fits"))
            if flat is None and others:
                logger.warning(
                    f"No master flat for filter {filt!r} in {caldir} "
                    f"(found only {sorted(os.path.basename(p) for p in others)}); "
                    "skipping flat correction")
    else:
        flat = first("master_flat.fits", "master_flat*.fits")
    return {
        "bias": first("master_bias*.fits"),
        "dark": first("master_dark*.fits"),
        "flat": flat,
        "badpix": first("master_badpix*.fits"),
    }


@dataclasses.dataclass
class ReduceConfig:
    fixcosmic: bool = False
    skybg: bool = False
    deltapix: int = 2
    search_fwhm: float = 3.0
    search_nsigma: float = 7.0
    stack_sigma: float = 5.0
    stack_combine: str = "average"
    #: registration reference frame: an index or 'auto' (most stars)
    ref_frame: "int | str" = "auto"
    #: stack engine: 'xla' or 'pallas' (one path: the separable warp and
    #: the K3 combine for 'average'), or 'fused' (memory-lean mega-kernel)
    combine_impl: str = "xla"
    noclean: bool = True          # skip outputs that already exist
    quality: bool = True
    stack: bool = True
    #: write a swarp-style coadd weight map next to each stack (the
    #: WEIGHTOUT image swarp always produces, resample_all.sh:342):
    #: per-pixel sum of frame coverage x 1/fscale^2
    stack_weights: bool = True
    #: per-image astrometric WCS stage (the navigate_all.sh stage the
    #: reference runs between calibration and stacking,
    #: navigate_all.sh:5-20): writes a WCS-stamped nav-*.fits per
    #: calibrated image and adds ra/dec columns to its source list,
    #: and the group's stacked product inherits the reference frame's
    #: solved WCS.  With astrometry_transport set (nova_transport or a
    #: mock), every image is plate-solved through it (reference
    #: core/ApAstrometry.py:66-141); without a transport the stage is
    #: network-free: the first WCS-bearing frame of the group anchors
    #: registration-based solves for the rest
    #: (wcs.astrometry.solve_from_reference)
    astrometry: bool = False
    astrometry_transport: "Optional[object]" = None
    astrometry_timeout: float = 180.0


def _read_srclist_stars(srclist_path: str, cap: int = 64):
    """(x, y, flux, valid) fixed-capacity 0-based arrays from an
    ap_find_stars source list (AP_XYPOS is brightest-first)."""
    from ..io.fits import open_fits

    hdus = open_fits(srclist_path)
    xy = hdus["AP_XYPOS"]
    x = np.asarray(xy["X"], np.float32) - 1.0
    y = np.asarray(xy["Y"], np.float32) - 1.0
    try:
        flux = np.asarray(hdus["AP_L1MAG"]["adu_per_sec"], np.float32)
    except Exception:
        flux = np.linspace(1.0, 0.5, len(x)).astype(np.float32)
    n = min(len(x), cap)
    xs = np.zeros(cap, np.float32)
    ys = np.zeros(cap, np.float32)
    fl = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)
    xs[:n], ys[:n], fl[:n], valid[:n] = x[:n], y[:n], flux[:n], True
    return xs, ys, fl, valid


def _stars_on(tables, device):
    """A source list's (x, y, flux, valid) arrays as tensors on
    ``device``."""
    return [torch.from_numpy(t).to(device) for t in tables]


def _write_nav(cal_path: str, nav_path: str, srclist: str, wcs,
               origin: str) -> None:
    """WCS-stamped nav-*.fits copy of a calibrated image + ra/dec
    columns in its source list (the outputs the reference's
    navigate_all.sh stage produces via ap_astrometry,
    core/ApAstrometry.py:496-520 and :455-494)."""
    from ..io.fits import HDUList, ImageHDU, open_fits
    from ..wcs.astrometry import Astrometry

    hdus = open_fits(cal_path)
    hdu = hdus[0]
    hdr = hdu.header.copy()
    wcs.to_header(hdr)
    hdr["ASTRSOLV"] = (True, "Astrometric solution succeeded")
    hdr.add_history(f"WCS via local registration solve: {origin}")
    HDUList([ImageHDU(hdu.data, hdr)]).writeto(nav_path)
    if os.path.exists(srclist):
        src_hdus = open_fits(srclist)
        Astrometry._update_sourcelist(src_hdus, srclist, wcs, "AP_XYPOS")


def _navigate_group(cal_entries, outdir: str, config: ReduceConfig,
                    produced: Dict[str, List[str]], device):
    """Per-image astrometric WCS stage for one target:telescope:filter
    group — the navigate_all.sh stage (reference navigate_all.sh:5-20:
    ap_find_stars -> ap_astrometry per image).  Returns
    {cal_path: TanWCS} so the stack inherits the reference frame's
    solved WCS.

    With a transport every image is plate-solved through it; without
    one the first WCS-bearing frame anchors registration-based solves
    (wcs.astrometry.solve_from_reference) for the rest — no network.
    ``noclean``: existing nav outputs are reused, not re-solved.
    Source lists are made and registered on ``device``.
    """
    from ..io.fits import open_fits
    from ..ops.register import REJECTED_TRANSLATION, estimate_similarity
    from ..wcs.astrometry import Astrometry, solve_from_reference
    from ..wcs.wcs import TanWCS
    from .star_finder import StarFinder

    entries = []
    for cal_path, lf in cal_entries:
        base = os.path.splitext(os.path.basename(lf.path))[0]
        entries.append((cal_path,
                        os.path.join(outdir, f"nav-{base}.fits"),
                        os.path.join(outdir, f"src-{base}.fits")))
    wcs_by_cal: Dict[str, object] = {}

    def ensure_srclist(cal_path: str, srclist: str) -> bool:
        if os.path.exists(srclist):
            return True
        try:
            finder = StarFinder(cal_path, search_fwhm=config.search_fwhm,
                                search_nsigma=config.search_nsigma,
                                device=device)
            finder.write_source_list(srclist)
            return True
        except Exception as exc:
            logger.warning(f"Source list for {cal_path} failed: {exc}")
            return False

    pending = []
    for cal_path, nav_path, srclist in entries:
        if config.noclean and os.path.exists(nav_path):
            try:
                wcs_by_cal[cal_path] = TanWCS.from_header(
                    open_fits(nav_path)[0].header)
                produced["navigated"].append(nav_path)
                logger.info(f"Skipping existing {nav_path}")
                continue
            except Exception:
                pass  # unreadable/bad WCS: re-solve it below
        pending.append((cal_path, nav_path, srclist))

    if config.astrometry_transport is not None:
        # reference behavior: one (network) solve per image
        ast = Astrometry(transport=config.astrometry_transport)
        for cal_path, nav_path, srclist in pending:
            if not ensure_srclist(cal_path, srclist):
                continue
            try:
                wcs = ast.solve(cal_path, srclist, nav_path,
                                timeout=config.astrometry_timeout)
            except Exception as exc:
                logger.error(f"Astrometry failed for {cal_path}: "
                             f"{type(exc).__name__}: {exc}")
                continue
            if wcs is not None:
                wcs_by_cal[cal_path] = wcs
                produced["navigated"].append(nav_path)
        return wcs_by_cal

    # network-free mode: anchor on a WCS-bearing frame of the group
    anchor = None
    for cal_path, nav_path, srclist in entries:
        if cal_path in wcs_by_cal:     # an already-navigated output
            anchor = (cal_path, nav_path, srclist, wcs_by_cal[cal_path])
            break
    if anchor is None:
        for cal_path, nav_path, srclist in entries:
            try:
                wcs = TanWCS.from_header(open_fits(cal_path)[0].header)
            except Exception:
                continue
            anchor = (cal_path, nav_path, srclist, wcs)
            break
    if anchor is None:
        logger.warning(
            "astrometry: no transport configured and no frame in the "
            "group carries a WCS; skipping the navigate stage (give "
            "--key for network solves, or solve one frame first)")
        return wcs_by_cal
    ref_cal, ref_nav, ref_src, ref_wcs = anchor
    if not ensure_srclist(ref_cal, ref_src):
        return wcs_by_cal
    if any(p[0] == ref_cal for p in pending):
        _write_nav(ref_cal, ref_nav, ref_src, ref_wcs,
                   origin="anchor frame's own header WCS")
        wcs_by_cal[ref_cal] = ref_wcs
        produced["navigated"].append(ref_nav)
    ref_stars = _stars_on(_read_srclist_stars(ref_src), device)
    for cal_path, nav_path, srclist in pending:
        if cal_path == ref_cal:
            continue
        if not ensure_srclist(cal_path, srclist):
            continue
        sim = estimate_similarity(
            *ref_stars, *_stars_on(_read_srclist_stars(srclist), device))
        n_inl = int(sim.n_inliers)
        if n_inl < 4 or abs(float(sim.tx)) >= REJECTED_TRANSLATION / 2:
            logger.warning(f"astrometry: registration of {cal_path} "
                           f"against the anchor rejected ({n_inl} "
                           "inliers); no WCS for this frame")
            continue
        wcs = solve_from_reference(ref_wcs, sim, sip_order=2)
        _write_nav(cal_path, nav_path, srclist, wcs,
                   origin=f"registered to "
                          f"{os.path.basename(ref_cal)} "
                          f"({n_inl} inliers, rms "
                          f"{float(sim.rms):.2f} px)")
        wcs_by_cal[cal_path] = wcs
        produced["navigated"].append(nav_path)
    return wcs_by_cal


@span("apt.reduce")
def reduce_all(
    datadir: str,
    caldir: str,
    outdir: str,
    config: ReduceConfig = ReduceConfig(),
    device=None,
) -> Dict[str, List[str]]:
    """Run calibrate -> (skybg) -> find_stars/quality -> stack per group
    on ``device`` (CUDA when not given).

    Returns a dict of produced outputs per stage.
    """
    from .star_finder import StarFinder

    dev = resolve_device(device)
    timer = StageTimer()
    os.makedirs(outdir, exist_ok=True)
    produced: Dict[str, List[str]] = {"calibrated": [], "quality": [],
                                      "navigated": [], "stacks": [],
                                      "weights": []}
    lights = scan_lights(datadir)
    if not lights:
        raise RuntimeError(f"no light frames found under {datadir}")
    groups = group_lights(lights)
    logger.info(f"{len(lights)} lights in {len(groups)} "
                "target:telescope:filter groups")

    status: List[Tuple[str, str]] = []
    for (target, telescope, filt), members in sorted(groups.items()):
        masters = find_masters(caldir, filt)
        cal = Calibrator(master_bias=masters["bias"],
                         master_dark=masters["dark"],
                         master_flat=masters["flat"],
                         master_badpix=masters["badpix"],
                         deltapix=config.deltapix, device=dev)
        cal_paths = []
        for lf in members:
            base = os.path.splitext(os.path.basename(lf.path))[0]
            out_path = os.path.join(outdir, f"cal-{base}.fits")
            if config.noclean and os.path.exists(out_path):
                logger.info(f"Skipping existing {out_path}")
                status.append((lf.path, "skipped"))
            else:
                try:
                    # calibrate() ends in the download it writes
                    with timer.stage("calibrate", base):
                        cal.calibrate(lf.path, out_path,
                                      fix_cosmic=config.fixcosmic)
                        if config.skybg:
                            _subtract_skybg(out_path, dev)
                    status.append((lf.path, "calibrated"))
                except Exception as exc:
                    logger.error(f"Calibration failed for {lf.path}: {exc}")
                    status.append((lf.path, f"error: {exc}"))
                    continue
            cal_paths.append((out_path, lf))
            produced["calibrated"].append(out_path)

            if config.quality:
                qual_path = os.path.join(outdir, f"qual_{base}.yml")
                if not (config.noclean and os.path.exists(qual_path)):
                    try:
                        # the finder's tables come down before it writes
                        with timer.stage("quality", base):
                            finder = StarFinder(
                                out_path, search_fwhm=config.search_fwhm,
                                search_nsigma=config.search_nsigma,
                                device=dev)
                            finder.measure_fwhm()
                            finder.write_quality_report(qual_path)
                            srclist = os.path.join(outdir,
                                                   f"src-{base}.fits")
                            finder.write_source_list(srclist)
                    except Exception as exc:
                        logger.warning(f"Quality failed for {out_path}: {exc}")
                produced["quality"].append(qual_path)

        # per-image astrometric WCS (the navigate_all.sh stage)
        nav_wcs: Dict[str, object] = {}
        if config.astrometry and cal_paths:
            with timer.stage("navigate", f"{target}:{telescope}:{filt}"):
                nav_wcs = _navigate_group(cal_paths, outdir, config,
                                          produced, dev)

        # register + stack the group
        if config.stack and len(cal_paths) >= 2:
            stack_name = (f"stack-{target}-{telescope}-{filt}.fits"
                          .replace(" ", "_"))
            stack_path = os.path.join(outdir, stack_name)
            weight_name = "weight-" + stack_name[len("stack-"):]
            weight_path = os.path.join(outdir, weight_name)
            if config.noclean and os.path.exists(stack_path):
                logger.info(f"Skipping existing {stack_path}")
                if config.stack_weights:
                    # keep the run summary honest about pre-existing
                    # weight maps; a stack produced before weight maps
                    # existed (or with --no-weights) cannot be
                    # backfilled without re-registering, so say so
                    if os.path.exists(weight_path):
                        produced["weights"].append(weight_path)
                    else:
                        logger.warning(
                            f"{stack_path} has no weight map "
                            f"({weight_name} missing); rerun with "
                            "--clean to regenerate the stack with one")
            else:
                exps = [lf.exptime for _p, lf in cal_paths]
                try:
                    stack, hdrs = load_stack([p for p, _lf in cal_paths],
                                             dev, timer, stack_name)
                except ValueError as exc:
                    logger.error(f"Mixed frame shapes in group {stack_name}"
                                 f": {exc}; skipping stack")
                    continue
                _stack_group(stack, hdrs, exps, cal_paths, nav_wcs,
                             stack_path, weight_path, config, timer)
                del stack
                if config.stack_weights:
                    produced["weights"].append(weight_path)
            produced["stacks"].append(stack_path)

    # run-summary table (the bash driver prints one; reference
    # calibrate_all.sh run summary)
    n_ok = sum(1 for _, s in status if s in ("calibrated", "skipped"))
    logger.info(f"Reduction complete: {n_ok}/{len(status)} frames OK, "
                f"{len(produced['stacks'])} stacks")
    if timer.records:
        logger.info("Stage timings:\n" + timer.report())
    return produced


def load_stack(paths: List[str], device, timer: StageTimer, name: str):
    """(stack, headers): the frames of ``paths`` (FITS, read as float32)
    as one (N, H, W) float32 tensor on ``device``.  Host threads read
    ahead (``PrefetchLoader``); each frame is uploaded into its slice of
    the preallocated tensor as it arrives.  The waits for the readers
    and the uploads are timed as ``read`` and ``upload``.  Raises
    ValueError when a frame's shape differs from the first's."""
    from ..parallel.pipeline import PrefetchLoader

    stack = None
    hdrs: List[Header] = []
    read_s = upload_s = 0.0
    loader = iter(PrefetchLoader(paths, depth=4, workers=4))
    for i in range(len(paths)):
        t0 = time.perf_counter()
        path, data, hdr = next(loader)
        t1 = time.perf_counter()
        if stack is None:
            stack = torch.empty((len(paths),) + data.shape,
                                dtype=torch.float32, device=device)
        elif data.shape != tuple(stack.shape[1:]):
            loader.close()
            raise ValueError(
                f"{path!r} shape {data.shape} differs from first frame "
                f"{tuple(stack.shape[1:])}")
        stack[i].copy_(torch.from_numpy(native_contiguous(data)))
        if stack.device.type != "cpu":
            count("h2d_bytes", stack[i].numel() * stack[i].element_size())
        synchronize(device)
        read_s += t1 - t0
        upload_s += time.perf_counter() - t1
        hdrs.append(hdr)
    timer.add(f"read {name}", read_s)
    timer.add(f"upload {name}", upload_s, bytes_=stack.numel() * 4)
    return stack, hdrs


def register_and_stack(stack: torch.Tensor, scales, config, timer: StageTimer,
                       name: str):
    """``calibrate_register_stack``'s two halves on an (N, H, W) float32
    stack that is already calibrated: FSCALE (``scales`` (N,), or None)
    in place, registration, then warp + combine by
    ``config.combine_impl``.  Returns (stack (H, W) numpy, diagnostics
    as numpy, the reference index an int); each half is a stage of
    ``timer`` ending in a synchronize or the download."""
    from ..models.pipeline import (diagnostics, register_frames,
                                   stack_registered)

    dev = stack.device
    with timer.stage("register", name):
        if scales is not None:
            stack.mul_(torch.from_numpy(np.asarray(scales, np.float32))
                       .to(dev)[:, None, None])
        stars, sims, matrices, ref_idx = register_frames(stack, config)
        diag = diagnostics(stars, sims, matrices, ref_idx)
        synchronize(dev)
    with timer.stage("combine", f"{config.combine_impl} {name}",
                     pixels=stack.numel()):
        stacked = stack_registered(stack, matrices, config)
        synchronize(dev)
    with timer.stage("download", name):
        arrays = [stacked] + [v for v in diag.values()
                              if not isinstance(v, int)]
        if dev.type != "cpu":
            count("d2h_bytes",
                  sum(a.numel() * a.element_size() for a in arrays))
        with host_read(stacked, reads=len(arrays)):
            stacked = stacked.cpu().numpy()
            diag = {k: v if isinstance(v, int) else v.cpu().numpy()
                    for k, v in diag.items()}
    return stacked, diag


def _stack_group(stack, hdrs, exps, cal_paths, nav_wcs, stack_path: str,
                 weight_path: str, config: ReduceConfig,
                 timer: StageTimer) -> None:
    """Register, stack and write one group's (N, H, W) device stack and
    its weight map."""
    from ..models.pipeline import PipelineConfig
    from ..ops.warp import coverage_weight_map

    dev = stack.device
    stack_name = os.path.basename(stack_path)
    pcfg = PipelineConfig(
        fwhm=config.search_fwhm,
        detect_nsigma=config.search_nsigma,
        sigma_lower=config.stack_sigma,
        sigma_upper=config.stack_sigma,
        combine=config.stack_combine,
        ref_frame=config.ref_frame,
        combine_impl=config.combine_impl)
    # swarp-style FSCALE: stack mixed exposures in the
    # reference frame's flux units
    scales = np.asarray([exps[0] / e if e else 1.0
                         for e in exps], np.float32)
    n_frames = stack.shape[0]
    t0 = time.perf_counter()
    stacked, diag = register_and_stack(stack, scales, pcfg, timer,
                                       stack_name)
    rms, inl = diag["rms"], diag["n_inliers"]
    dt = time.perf_counter() - t0
    # the output grid is the REFERENCE frame's pixel grid
    # (ref_frame='auto' may pick any frame), so inherit ITS
    # header — frame 0's WCS/pointing keywords would
    # misdescribe the stack by the inter-frame offset
    ref_i = int(diag.get("ref_frame", 0))
    out_hdr = hdrs[ref_i].copy() if hdrs else Header()
    # the stack lives on the reference frame's pixel grid,
    # so that frame's solved WCS describes the stack
    # exactly (the navigate stage's product surviving into
    # the stacked output, as the reference's swarp chain
    # propagates nav_* WCS into its coadds)
    ref_cal_path = cal_paths[ref_i][0]
    if ref_cal_path in nav_wcs:
        nav_wcs[ref_cal_path].to_header(out_hdr)
        out_hdr["ASTRSOLV"] = (True,
                               "WCS from navigate stage")
    out_hdr["IMAGETYP"] = ("STACK", "Registered stacked image")
    out_hdr["NSTACK"] = (n_frames,
                         "Number of frames in stack")
    out_hdr["EXPTOTAL"] = (float(np.sum(exps)),
                           "[s] Total stacked exposure")
    for i, (_p, lf) in enumerate(cal_paths):
        out_hdr[f"ISTK{i:04d}"] = os.path.basename(lf.path)
    out_hdr.add_history(
        f"Registered+stacked {n_frames} frames "
        f"({config.stack_combine}, sigma {config.stack_sigma}) "
        f"in {dt:.2f} s on device")
    wmap = None
    if config.stack_weights:
        # swarp WEIGHTOUT parity (resample_all.sh:342):
        # coadd weight = sum of frame coverage x 1/fscale^2.
        # Named weight-<group>.fits so stack-*.fits globs
        # never ingest weight maps as stacks.
        with timer.stage("weight map", stack_name):
            fw = 1.0 / np.square(scales)
            # frames that failed registration (< 4 inliers)
            # contribute ~nothing to the combine; zero their
            # weight so the map reflects usable depth
            usable = (inl >= 4)
            usable[ref_i] = True
            fw = fw * usable.astype(np.float32)
            wmap = coverage_weight_map(
                torch.from_numpy(diag["matrices"]).to(dev),
                tuple(stack.shape[1:]), stacked.shape,
                torch.from_numpy(fw).to(dev)).cpu().numpy()
    with timer.stage("write", stack_name):
        write_image(stack_path, stacked, out_hdr)
        if wmap is not None:
            whdr = out_hdr.copy()
            whdr["IMAGETYP"] = ("STACK WEIGHT", "Coadd weight map")
            whdr.add_history(
                f"Weight map for {os.path.basename(stack_path)} "
                "(sum of frame coverage x 1/fscale^2)")
            write_image(weight_path, wmap, whdr)
    rms_others = np.delete(rms, ref_i) if len(rms) > 1 else rms
    bad = [os.path.basename(cal_paths[i][1].path)
           for i in range(len(inl))
           if inl[i] < 4 and i != ref_i]
    if bad:
        logger.warning(
            f"{len(bad)} frame(s) registered with < 4 "
            f"inliers and contribute little or nothing to "
            f"{os.path.basename(stack_path)}: {bad} — check "
            "their quality reports")
    logger.info(
        f"Stacked {n_frames} frames -> {stack_path} "
        f"(reg rms median {np.median(rms_others):.3f} px, "
        f"{dt:.2f} s)")


def _subtract_skybg(path: str, device) -> None:
    """In-place sky background subtraction (the calibrate_all.sh skybg
    step: ap_measure_background + ap_imarith SUB), modelled on
    ``device``."""
    from ..ops.background import background2d, source_mask

    data, hdr = read_image(path)
    h, w = data.shape
    ph = (-h) % 16
    pw = (-w) % 16
    padded = torch.from_numpy(native_contiguous(
        np.pad(data, ((0, ph), (0, pw)), mode="edge"))).to(device)
    smask = source_mask(padded, nsigma=3.0, dilate=13)
    bg = background2d(padded, smask).cpu().numpy()[:h, :w]
    hdr.add_history(f"Subtracted sky background (median {np.median(bg):.2f})")
    write_image(path, data - bg + float(np.median(bg)), hdr)
