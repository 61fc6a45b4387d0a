"""Device operations of the port: statistics, calibration and bad-pixel
repair, detection, photometry, PSF fits, background, cosmic-ray
cleaning, registration, warps, the sigma-clip combines and the colour
stretch, each kernel beside its plain PyTorch twin."""

from .stats import (
    masked_median,
    masked_mean_std,
    mad_std,
    sigma_clip_mask,
    sigma_clipped_stats,
)
from .calibrate import calibrate_frame, calibrate_batch
from .badpix import fix_bad_pixels, sigmaclip_badpix_mask, auto_badcols
from .stack import sigma_clip_combine
from .imarith import imarith
from .detect import Stars, find_stars, find_saturated, mask_boxes
from .photometry import Photometry, aperture_photometry, aperture_radii
from .background import background2d, source_mask
from .psf import (
    PSFFits,
    extract_cutouts,
    fit_gaussian2d,
    isolated_mask,
    measure_fwhm,
    median_fwhm,
    nearest_neighbor_dist,
)

__all__ = [
    "masked_median",
    "masked_mean_std",
    "mad_std",
    "sigma_clip_mask",
    "sigma_clipped_stats",
    "calibrate_frame",
    "calibrate_batch",
    "fix_bad_pixels",
    "sigmaclip_badpix_mask",
    "auto_badcols",
    "sigma_clip_combine",
    "imarith",
    "Stars",
    "find_stars",
    "find_saturated",
    "mask_boxes",
    "Photometry",
    "aperture_photometry",
    "aperture_radii",
    "background2d",
    "source_mask",
    "PSFFits",
    "extract_cutouts",
    "fit_gaussian2d",
    "isolated_mask",
    "measure_fwhm",
    "median_fwhm",
    "nearest_neighbor_dist",
]
