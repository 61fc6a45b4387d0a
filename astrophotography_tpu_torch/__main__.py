"""python -m astrophotography_tpu_torch — point users at the CLI tools
(reference __main__.py:13-18 prints the same kind of hint)."""

import sys

_TOOLS = (
    "dksraw", "ap_calibrate", "ap_combine_darks", "ap_find_badpix",
    "ap_fix_badpix", "ap_auto_badcol", "ap_calc_read_noise",
)


def main() -> int:
    print("astrophotography_tpu_torch is a collection of command-line "
          "tools; run one of:")
    for tool in _TOOLS:
        print(f"  python -m astrophotography_tpu_torch.cli.{tool} --help")
    return 1


if __name__ == "__main__":
    sys.exit(main())
