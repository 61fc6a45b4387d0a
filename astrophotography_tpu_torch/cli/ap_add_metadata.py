"""ap_add_metadata: enrich FITS headers with site/target/airmass keywords.

Reference surface (scripts/ap_add_metadata.py:65-90): positional
fitsfile; --mode iTelescope|yamlkeyval, --target, --yamlfile.
Host work only, so the tool takes no ``--device``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .common import add_loglevel, cli_main
from ..core.metadata import add_metadata


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_add_metadata",
        description="Add observatory/target/airmass metadata to a FITS file")
    p.add_argument("fitsfile", help="FITS file to update in place")
    p.add_argument("--mode", default="iTelescope",
                   choices=["iTelescope", "yamlkeyval"],
                   help="metadata source mode")
    p.add_argument("--target", default=None,
                   help="override the target name parsed from the filename")
    p.add_argument("--yamlfile", default=None,
                   help="YAML of key: value pairs (yamlkeyval mode)")
    p.add_argument("--simbad", action="store_true",
                   help="resolve targets missing from the built-in catalog "
                        "via the SIMBAD TAP service (network)")
    add_loglevel(p)
    return p.parse_args(argv)


def run(ns: argparse.Namespace) -> None:
    resolver = None
    if ns.simbad:
        from ..core.metadata import simbad_resolver
        resolver = simbad_resolver()
    add_metadata(ns.fitsfile, mode=ns.mode, target=ns.target,
                 yamlfile=ns.yamlfile, resolver=resolver)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
