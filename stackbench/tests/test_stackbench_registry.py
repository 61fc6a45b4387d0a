"""A configuration, a traffic mix and a per-layer metric are taken up
from new files and BENCHMARK.json entries alone."""

import hashlib
import json

import pytest

from stackbench import run
from stackbench.registry import HERE, Registry

from conftest import TINY_LIMITS, tiny_config


def _tree_digest():
    h = hashlib.sha256()
    for path in sorted(HERE.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            h.update(str(path.relative_to(HERE)).encode())
            h.update(path.read_bytes())
    h.update((HERE.parent / "BENCHMARK.json").read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_from_new_files(tmp_path, trace):
    before = _tree_digest()
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = tiny_config("lean-16mpix-n100")
    (tmp_path / "configs" / "night-new.json").write_text(json.dumps(cfg))
    mix = json.loads((HERE / "traffic" / "dither.json").read_text())
    mix.update(dither_px=2.0, sample_images=2)
    (tmp_path / "traffic" / "halfdither.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "frames_per_request.py").write_text(
        "def read(ctx):\n"
        "    if ctx.trace is None or ctx.trace.requests == 0:\n"
        "        return None\n"
        "    return float(ctx.n)\n")
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "night-new", "source": "x",
                             "file": "configs/night-new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "night-new.halfdither",
                               "config": "night-new",
                               "traffic": "halfdither", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "frames_per_request", "unit": "count",
                               "better": "higher", "source": "device_trace",
                               "layer": "x", "moves": "stack_gpix_s",
                               "workloads": ["night-new.halfdither"]})
    reg = Registry(bench, roots=[tmp_path, HERE])
    res = run.run_cell(reg, "night-new.halfdither", 2**31 + 11, 0.5,
                       bool(trace), "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    if trace:
        assert res["metrics"]["frames_per_request"]["value"] == 8.0
        assert "detect_roofline" not in res["metrics"]
        assert {"busy_s", "window_s"} <= set(res["device"])
    else:
        assert set(res["metrics"]) == {"stack_gpix_s", "peak_mem_gb",
                                       "setup_s"}
    assert set(res["checks"]) == {"failed_requests", *TINY_LIMITS}
    assert list(res)[-1] == "checks"
    assert _tree_digest() == before


def test_every_named_piece_has_its_file():
    reg = Registry.load()
    for cell in reg.benchmark["workloads"]:
        cfg = reg.config(cell["config"])
        mix = reg.traffic(cell["traffic"])
        assert hasattr(reg.generator(mix["generator"]), "drive")
        assert set(cfg["limits"]) and cfg["entry"]
    for kind in ("end_to_end", "per_layer"):
        for m in reg.benchmark[kind]:
            assert callable(reg.reader(m["name"]).read)
    for c in reg.benchmark["configs"]:
        assert (HERE.parent / c["file"]).is_file()


def test_metrics_of_a_cell():
    reg = Registry.load()
    names = [m["name"] for m in reg.metrics("end_to_end",
                                             "unfused-16mpix-n24.dither")]
    assert "stack_ms.p95" not in names and "setup_s" in names
    names = [m["name"] for m in reg.metrics("per_layer",
                                             "lean-rot-16mpix-n100.rotate")]
    assert "warp_combine_roofline" in names and "warp_roofline" not in names
