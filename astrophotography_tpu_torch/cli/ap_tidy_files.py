"""ap_tidy_files: filename/permission hygiene for observatory downloads.

Covers the reference's ap_rename_files_with_spaces.sh and
ap_fix_itelescope_dirs.sh (reference scripts/, flagged in
doc/iTelescope_processing.md:77-93): replaces spaces in file names with
underscores and normalizes directory permissions so batch tools can
glob the tree safely.
Host work only, so the tool takes no ``--device``.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from .common import add_loglevel, cli_main
from ..utils.logger import get_logger

logger = get_logger("cli.ap_tidy_files")


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ap_tidy_files",
        description="Rename files containing spaces and fix directory "
                    "permissions under a data tree")
    p.add_argument("rootdir", help="directory tree to tidy")
    p.add_argument("--dry_run", action="store_true",
                   help="report actions without performing them")
    p.add_argument("--fix_permissions", action="store_true",
                   help="chmod directories u+rwx and files u+rw")
    add_loglevel(p)
    return p.parse_args(argv)


def tidy(rootdir: str, dry_run: bool = False,
         fix_permissions: bool = False) -> List[str]:
    renamed: List[str] = []
    for dirpath, dirnames, filenames in os.walk(rootdir, topdown=False):
        for name in filenames + dirnames:
            if " " in name:
                src = os.path.join(dirpath, name)
                dst = os.path.join(dirpath, name.replace(" ", "_"))
                if os.path.exists(dst):
                    logger.warning(f"Cannot rename {src!r}: {dst!r} exists")
                    continue
                logger.info(f"rename {src!r} -> {dst!r}")
                if not dry_run:
                    os.rename(src, dst)
                renamed.append(dst)
        if fix_permissions and not dry_run:
            os.chmod(dirpath, os.stat(dirpath).st_mode | 0o700)
            for name in os.listdir(dirpath):
                fp = os.path.join(dirpath, name)
                if os.path.isfile(fp):
                    os.chmod(fp, os.stat(fp).st_mode | 0o600)
    logger.info(f"Renamed {len(renamed)} entries under {rootdir}")
    return renamed


def run(ns: argparse.Namespace) -> None:
    tidy(ns.rootdir, dry_run=ns.dry_run, fix_permissions=ns.fix_permissions)


main = cli_main(run, parse)

if __name__ == "__main__":
    import sys
    sys.exit(main())
