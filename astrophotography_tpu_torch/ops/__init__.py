"""Device operations of the port: statistics, calibration and bad-pixel
repair, RAW conversion (demosaic), detection, photometry, PSF fits, background, cosmic-ray
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
from .demosaic import (
    demosaic_ahd,
    demosaic_bilinear,
    demosaic_mhc,
    raw_to_rgb,
    raw_to_grey_linear,
    raw_to_grey_direct,
    split_channels,
    wb_from_region,
    percentile_renorm,
    safe_subtract_black,
)
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
    "demosaic_ahd",
    "demosaic_bilinear",
    "demosaic_mhc",
    "raw_to_rgb",
    "raw_to_grey_linear",
    "raw_to_grey_direct",
    "split_channels",
    "wb_from_region",
    "percentile_renorm",
    "safe_subtract_black",
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
