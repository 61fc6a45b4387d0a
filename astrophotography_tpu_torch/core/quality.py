"""Quality summarization: aggregate per-image quality YAML files to CSV.

Equivalent of ApQualitySummarizer (reference
core/ApQualitySummarizer.py:36-315): glob quality files by
prefix/suffix (optionally walking the tree), group rows by
target:telescope:filter, flatten nested fwhm sections, emit one CSV row
per image.

The JAX package's ``core/quality.py``, host code only (``yaml`` is
imported when the files are read).
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List

from ..utils.logger import get_logger

logger = get_logger("core.quality")


def find_quality_files(
    rootdir: str,
    prefix: str = "qual",
    suffix: str = ".yml",
    walk_tree: bool = False,
) -> List[str]:
    """Quality files matching prefix*suffix (reference _find_files,
    core/ApQualitySummarizer.py:200-230)."""
    pattern = f"{prefix}*{suffix}"
    if walk_tree:
        return sorted(glob.glob(os.path.join(rootdir, "**", pattern),
                                recursive=True))
    return sorted(glob.glob(os.path.join(rootdir, pattern)))


def _flatten(report: Dict) -> Dict[str, object]:
    """One flat row from a nested quality report; fwhm_* sections expand
    to fwhm_<name>_<field> columns (reference flattening of fwhm_xandy,
    core/ApQualitySummarizer.py:77-161)."""
    row: Dict[str, object] = {}
    for section in ("image_info", "background_info", "source_info",
                    "saturation_info", "psf_info"):
        sub = report.get(section, {}) or {}
        for key, val in sub.items():
            if isinstance(val, dict):
                for k2, v2 in val.items():
                    row[f"{key}_{k2}"] = v2
            else:
                row[key] = val
    return row


def group_key(row: Dict[str, object]) -> str:
    """target:telescope:filter grouping (reference _read_files,
    core/ApQualitySummarizer.py:259-302)."""
    return ":".join(str(row.get(k, "unknown"))
                    for k in ("object", "telescope", "filter"))


def summarize_quality(
    rootdir: str,
    output_csv: str,
    prefix: str = "qual",
    suffix: str = ".yml",
    walk_tree: bool = False,
) -> List[Dict[str, object]]:
    """Read all quality YAMLs and write one summary CSV."""
    import yaml

    files = find_quality_files(rootdir, prefix, suffix, walk_tree)
    if not files:
        raise RuntimeError(
            f"No quality files matching {prefix}*{suffix} under {rootdir}")
    rows = []
    for path in files:
        with open(path) as fh:
            report = yaml.safe_load(fh) or {}
        row = _flatten(report)
        row["quality_file"] = os.path.basename(path)
        row["group"] = group_key(row)
        rows.append(row)
    # column set = union over rows, ordered by first appearance
    columns: List[str] = []
    for row in rows:
        for key in row:
            if key not in columns:
                columns.append(key)
    rows.sort(key=lambda r: (r["group"], str(r.get("date-obs", ""))))
    with open(output_csv, "w", newline="") as fh:
        writer = csv.DictWriter(fh, fieldnames=columns, restval="")
        writer.writeheader()
        writer.writerows(rows)
    logger.info(f"Wrote quality summary of {len(rows)} images to "
                f"{output_csv}")
    return rows
