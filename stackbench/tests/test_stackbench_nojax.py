"""A run loads neither JAX nor the JAX package, and refuses to run
without the cards its cell asks for."""

import subprocess
import sys

from conftest import ROOT

DRY_RUN = r"""
import json, sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(2)
from stackbench import run
sys.path.insert(0, {tests!r})
from conftest import TINY_CELL, make_tiny_registry
reg, _root = make_tiny_registry({tmp!r})
res = run.run_cell(reg, TINY_CELL, 3, 0.2, True, "cpu")
print(json.dumps({{"loaded": sorted({{m.split(".")[0] for m in sys.modules}}),
                  "forbidden": run.forbidden_modules(),
                  "correct": res["correct"]}}))
"""


def test_a_dry_run_loads_no_jax(tmp_path):
    import json

    code = DRY_RUN.format(root=str(ROOT), tests=str(ROOT / "stackbench" /
                                                     "tests"),
                          tmp=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "astrophotography_tpu_torch" in res["loaded"]
    for name in ("jax", "jaxlib", "flax", "astrophotography_tpu"):
        assert name not in res["loaded"]
    assert res["forbidden"] == [] and res["correct"]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from stackbench import run

    monkeypatch.setitem(sys.modules, "astrophotography_tpu_torch_extra",
                        sys.modules[__name__])
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules[__name__])
    assert run.forbidden_modules() == ["jax"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "stackbench.run", "--workload",
         "unfused-16mpix-n24.dither", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr
