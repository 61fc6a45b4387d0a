"""ap_quality_summary: aggregate quality YAML files into one CSV.

Reference surface (scripts/ap_quality_summary.py:61-71): positional
rootdir + output CSV; --prefix 'qual' --suffix '.yml' --walk_tree.
Host work only, so the tool takes no ``--device``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_loglevel, cli_main
from ..core.quality import summarize_quality


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_quality_summary",
        description="Summarize image quality YAML reports into a CSV table")
    p.add_argument("rootdir", help="directory containing quality files")
    p.add_argument("output", help="output CSV file")
    p.add_argument("--prefix", default="qual",
                   help="quality filename prefix (default 'qual')")
    p.add_argument("--suffix", default=".yml",
                   help="quality filename suffix (default '.yml')")
    p.add_argument("--walk_tree", action="store_true",
                   help="search subdirectories recursively")
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    summarize_quality(ns.rootdir, ns.output, prefix=ns.prefix,
                      suffix=ns.suffix, walk_tree=ns.walk_tree)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
