"""Master calibration building: combine bias/dark/flat directories.

Equivalent of the self-contained ApMasterCal in the reference's
ap_combine_darks.py script (reference scripts/ap_combine_darks.py:112-420):
scan a directory of FITS files, enforce consistency (IMAGETYP, EXPTIME,
dimensions, SET-TEMP identical; CCD-TEMP within a tolerance of SET-TEMP),
then sigma-clipped average combine (low/high = 5, center = median,
deviation = mad_std — ccdproc.combine parameters at :388-420), writing
MASTER + IFILEnnn provenance keywords (:318-354).

The combine itself is the device function ops/stack.sigma_clip_combine
over a device-resident (N, H, W) stack — no mem_limit chunking needed at
these sizes.  ``device`` is where it runs: CUDA when not given.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import on_device, resolve_device
from ..io.fits import Header, read_image, write_image
from ..ops.stack import sigma_clip_combine
from ..utils.logger import get_logger

logger = get_logger("core.masters")


class MasterCalError(RuntimeError):
    pass


def collect_frames(
    rootdir: str,
    pattern: str = "*.fits",
    exclude_pattern: str = "master*",
) -> List[str]:
    """FITS files under rootdir, excluding existing masters
    (reference glob_exclude at scripts/ap_combine_darks.py:289-316)."""
    paths = sorted(glob.glob(os.path.join(rootdir, pattern)))
    excluded = set(glob.glob(os.path.join(rootdir, exclude_pattern)))
    return [p for p in paths if p not in excluded]


def check_consistency(
    headers: Sequence[Header],
    paths: Sequence[str],
    temptol: float = 0.5,
) -> Tuple[List[int], Dict[str, object]]:
    """Validate header consistency; returns (accepted indices, common meta).

    Fatal on mixed IMAGETYP/EXPTIME/size/SET-TEMP (reference
    :150-287, fatal on mixed types at :207-212); frames whose CCD-TEMP
    deviates from SET-TEMP by more than ``temptol`` are excluded with a
    warning (:269-287).
    """
    def values(kw):
        return [h.get(kw) for h in headers]

    common: Dict[str, object] = {}
    for kw in ("IMAGETYP", "EXPTIME", "NAXIS1", "NAXIS2", "SET-TEMP"):
        vals = values(kw)
        present = [v for v in vals if v is not None]
        if not present:
            continue
        if len(set(present)) > 1:
            raise MasterCalError(
                f"Inconsistent {kw} across input files: {sorted(set(present))}")
        common[kw] = present[0]

    accepted = []
    set_temp = common.get("SET-TEMP")
    for i, hdr in enumerate(headers):
        if set_temp is not None and "CCD-TEMP" in hdr:
            dev = abs(float(hdr["CCD-TEMP"]) - float(set_temp))
            if dev > temptol:
                logger.warning(
                    f"Excluding {os.path.basename(paths[i])}: CCD-TEMP "
                    f"deviates {dev:.2f} C > {temptol} C from SET-TEMP")
                continue
        accepted.append(i)
    if not accepted:
        raise MasterCalError("No input frames pass the temperature filter")
    return accepted, common


def make_master(
    rootdir_or_files,
    output: str,
    temptol: float = 0.5,
    sigma: float = 5.0,
    pattern: str = "*.fits",
    device=None,
) -> Header:
    """Build and write a master calibration file from a directory or list."""
    dev = resolve_device(device)
    if isinstance(rootdir_or_files, str):
        files = collect_frames(rootdir_or_files, pattern=pattern)
    else:
        files = list(rootdir_or_files)
    if len(files) < 2:
        raise MasterCalError(
            f"Need at least 2 input frames, found {len(files)}")
    datas = []
    headers = []
    for p in files:
        d, h = read_image(p)
        datas.append(d)
        headers.append(h)
    accepted, common = check_consistency(headers, files, temptol=temptol)
    stack = on_device(np.stack([datas[i] for i in accepted]), dev)
    logger.info(f"Combining {len(accepted)} frames "
                f"(sigma clip {sigma}/{sigma}, average)")
    master = sigma_clip_combine(
        stack, sigma_lower=sigma, sigma_upper=sigma,
        method="average").cpu().numpy()

    out_hdr = headers[accepted[0]].copy()
    imagetyp = str(common.get("IMAGETYP", "UNKNOWN")).upper()
    kind = ("BIAS" if "BIAS" in imagetyp else
            "DARK" if "DARK" in imagetyp else
            "FLAT" if "FLAT" in imagetyp else imagetyp)
    out_hdr["IMAGETYP"] = (f"MASTER {kind}", "Master calibration type")
    out_hdr["NCOMBINE"] = (len(accepted), "Number of frames combined")
    out_hdr["MEANFULL"] = (float(np.nanmean(master)),
                           "Mean of full master frame")
    for n, i in enumerate(accepted):
        out_hdr[f"IFILE{n:03d}"] = (os.path.basename(files[i]),
                                    "Input file combined")
    out_hdr.add_history(
        f"Master {kind} from {len(accepted)} frames, sigma_clip "
        f"{sigma}/{sigma}, average combine")
    write_image(output, master, out_hdr)
    logger.info(f"Wrote master to {output}")
    return out_hdr


def calc_read_noise(
    bias1_path: str,
    bias2_path: str,
    gain: Optional[float] = None,
    gain_keyword: str = "GAIN",
    sigma: float = 3.0,
    plot_path: Optional[str] = None,
    diffim_path: Optional[str] = None,
    device=None,
) -> Dict[str, float]:
    """Read noise from two bias frames: RN = gain * sigma(B1-B2) / sqrt(2)
    (reference scripts/ap_calc_read_noise.py:371-383,552-554, Howell's
    CCD handbook method).  The difference image is sigma-clipped to
    reject outliers (:247-286).
    """
    from ..ops.stats import sigma_clipped_stats

    dev = resolve_device(device)
    b1, h1 = read_image(bias1_path)
    b2, h2 = read_image(bias2_path)
    if b1.shape != b2.shape:
        raise RuntimeError(
            f"Bias frames differ in shape: {b1.shape} vs {b2.shape}")
    if gain is None:
        g1 = h1.get(gain_keyword)
        g2 = h2.get(gain_keyword)
        if g1 is None or g2 is None:
            gain = 1.0
            logger.warning("No gain found in headers; assuming 1.0 e-/ADU")
        else:
            if abs(float(g1) - float(g2)) > 0.001:
                raise RuntimeError(
                    f"Gain differs between files: {g1} vs {g2}")
            gain = float(g1)
    diff = on_device(b1, dev) - on_device(b2, dev)
    _mean, _med, std = sigma_clipped_stats(diff, sigma=sigma)
    rn = float(gain) * float(std) / np.sqrt(2.0)
    logger.info(f"Read noise: {rn:.3f} e- (gain {gain} e-/ADU, "
                f"sigma(diff) {float(std):.3f} ADU)")
    if plot_path:
        _plot_diff_histogram(diff.cpu().numpy(), float(std), rn, plot_path)
    if diffim_path:
        dhdr = Header()
        dhdr["IMAGETYP"] = ("BIASDIFF", "Bias difference image")
        dhdr["RDNOISE"] = (rn, "[e-] Estimated read noise")
        write_image(diffim_path, diff.cpu().numpy(), dhdr)
        logger.info(f"Wrote difference image to {diffim_path}")
    return {"read_noise_e": rn, "gain": float(gain),
            "diff_sigma_adu": float(std)}


def _plot_diff_histogram(diff: np.ndarray, std_adu: float, rn_e: float,
                         path: str) -> None:
    """Bias-difference histogram with a Gaussian overlay (reference
    ap_calc_read_noise difference plot, scripts/ap_calc_read_noise.py:571-632)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    flat = diff.ravel()
    lim = 6 * std_adu
    sel = flat[(flat > -lim) & (flat < lim)]
    fig, ax = plt.subplots(figsize=(7, 5))
    n, bins, _ = ax.hist(sel, bins=100, density=True, alpha=0.6,
                         label="bias1 - bias2")
    centers = 0.5 * (bins[:-1] + bins[1:])
    mu = float(np.mean(sel))
    gauss = (np.exp(-0.5 * ((centers - mu) / std_adu) ** 2)
             / (std_adu * np.sqrt(2 * np.pi)))
    ax.plot(centers, gauss, "r-",
            label=f"Gaussian sigma={std_adu:.2f} ADU")
    ax.set_xlabel("difference [ADU]")
    ax.set_ylabel("density")
    ax.set_title(f"Read noise {rn_e:.2f} e-")
    ax.legend()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    logger.info(f"Wrote difference histogram to {path}")
