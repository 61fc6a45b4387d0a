"""Shared pieces of the benchmark's CPU tests: a registry whose search
roots put a temporary folder of tiny configurations before the
benchmark's own files."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

torch.set_num_threads(2)

#: a night small enough for the CPU (the port's plain twins run the
#: kernels' arithmetic there), with room for the lean path's fused
#: detection (24 tiles of 64 x 256 for 24 stars): 8 frames of 256 x 1536
TINY = {"frames": 8, "height": 256, "width": 1536}
TINY_STARS = 24
#: the limits at that size, between their readings on the CPU: the lean
#: program read rms 0.067-0.267 ADU (seeds 21-22), its bfloat16 control
#: 2.88-3.49, the clip left out 2.89-2.93, a frame a pixel off 1.34-1.41;
#: its registration 0.005-0.099 px at the worst corner (12 seeds), a frame
#: a pixel off 1.01-1.03.  The widest gaps (7.8-9.1 against 14.8-17.0)
#: are too close to hold a limit, and the star boxes' gaps (7.5-44 against
#: 42-55) overlap, so at this size those are not compared.
TINY_LIMITS = {"sky_rms_adu": 0.8, "reg_corner_px": 0.4}


def tiny_config(name: str, **changes) -> dict:
    from stackbench.registry import HERE

    cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
    cfg.update(TINY)
    cfg["pipeline"] = dict(cfg["pipeline"], max_stars=TINY_STARS)
    cfg["limits"] = dict(TINY_LIMITS)
    cfg.update(changes)
    return cfg


#: the cell the CPU tests drive: the lean path on the dither mix
TINY_CELL = "tiny-lean.dither"


@pytest.fixture
def tiny_registry(tmp_path):
    return make_tiny_registry(tmp_path)


def make_tiny_registry(tmp_path):
    """(registry, root): the benchmark's cells and :data:`TINY_CELL`, with
    every configuration cut to :data:`TINY` in a temporary folder
    searched first."""
    from stackbench.registry import BENCHMARK, HERE, Registry

    tmp_path = Path(tmp_path)
    (tmp_path / "configs").mkdir()
    for path in (HERE / "configs").glob("*.json"):
        (tmp_path / "configs" / path.name).write_text(
            json.dumps(tiny_config(path.stem)))
    (tmp_path / "configs" / "tiny-lean.json").write_text(
        json.dumps(tiny_config("lean-16mpix-n100")))
    bench = json.loads(BENCHMARK.read_text())
    bench["workloads"].append({"name": TINY_CELL, "config": "tiny-lean",
                               "traffic": "dither", "chips": 1,
                               "why": "the CPU tests' cell"})
    return Registry(bench, roots=[tmp_path, HERE]), tmp_path
