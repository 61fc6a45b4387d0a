"""python -m astrophotography_tpu_torch — point users at the CLI tools
(reference __main__.py:13-18 prints the same kind of hint)."""

import sys

_TOOLS = (
    "dksraw", "ap_reduce", "ap_calibrate", "ap_combine_darks",
    "ap_find_stars", "ap_astrometry", "ap_measure_background",
    "ap_find_badpix", "ap_fix_badpix", "ap_auto_badcol",
    "ap_fix_cosmic_rays", "ap_calc_read_noise", "ap_imarith",
    "ap_add_metadata", "ap_quality_summary", "ap_composite",
    "ap_tidy_files",
)


def main() -> int:
    print("astrophotography_tpu_torch is a collection of command-line "
          "tools; run one of:")
    for tool in _TOOLS:
        print(f"  python -m astrophotography_tpu_torch.cli.{tool} --help")
    return 1


if __name__ == "__main__":
    sys.exit(main())
