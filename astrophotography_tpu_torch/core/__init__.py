"""High-level engine classes mirroring the reference core surface
(reference core/__init__.py:6-34) on top of the device ops layer: RAW
conversion, master calibration frames, file-level calibration, the
bad-pixel workflows, star finding and quality reports, header metadata
and the batch reduction driver."""

from .raw_conv import RawConv
from .masters import (MasterCalError, calc_read_noise, check_consistency,
                      collect_frames, make_master)
from .calibrator import Calibrator, find_exptime, find_gain
from .badpix_engine import (auto_badcol_file, find_badpix, fix_badpix_files,
                            read_user_badpix)
from .metadata import add_metadata
from .quality import summarize_quality
from .star_finder import StarFinder
from .reduce import ReduceConfig, reduce_all

__all__ = [
    "RawConv",
    "MasterCalError",
    "calc_read_noise",
    "check_consistency",
    "collect_frames",
    "make_master",
    "Calibrator",
    "find_exptime",
    "find_gain",
    "auto_badcol_file",
    "find_badpix",
    "fix_badpix_files",
    "read_user_badpix",
    "add_metadata",
    "summarize_quality",
    "StarFinder",
    "ReduceConfig",
    "reduce_all",
]
