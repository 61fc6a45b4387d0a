"""The check that decides ``correct``: the port against the plain
reference at a tiny size on the CPU, the bfloat16 control failing it,
and a run whose timed path is broken underneath coming out not
correct."""

import json

import numpy as np
import pytest
import torch

from stackbench import run
from stackbench.reference import stack as ref
from stackbench.registry import HERE

from conftest import TINY, TINY_CELL, TINY_LIMITS, tiny_config

COMBINE = {"method": "average", "sigma_lower": 5.0, "sigma_upper": 5.0}


def _observation(seed, mix="dither"):
    from stackbench.workload import make_observation

    cfg = json.loads((HERE / "configs" / "lean-16mpix-n100.json").read_text())
    m = json.loads((HERE / "traffic" / f"{mix}.json").read_text())
    return make_observation(TINY["frames"], TINY["height"], TINY["width"],
                            cfg["sensor"], m, seed, "cpu")


def test_lanczos3_kernel():
    t = torch.tensor([0.0, 1.0, 2.0, 3.0, -3.5, 0.5], dtype=torch.float64)
    k = ref.lanczos3(t)
    assert k[0] == 1.0 and abs(k[1]) < 1e-15 and abs(k[2]) < 1e-15
    assert k[3] == 0.0 and k[4] == 0.0
    x = 0.5 * np.pi
    assert abs(float(k[5]) - 3 * np.sin(x) * np.sin(x / 3) / x ** 2) < 1e-15


def test_lanczos3_taps_are_the_kernel():
    frac = 2.0 + torch.rand(10000, dtype=torch.float64)
    frac[0] = 2.0
    for s, w in enumerate(ref.lanczos3_taps(frac)):
        assert torch.allclose(w, ref.lanczos3(frac - s), atol=1e-9, rtol=0)


def test_resample_identity_and_shift():
    g = torch.Generator().manual_seed(0)
    cal = torch.randn((1, 64, 96), generator=g, dtype=torch.float64)
    eye = np.array([[[1.0, 0, 0], [0, 1.0, 0]]])
    out, inside = ref.resample_rows(cal, eye, 0, 64, torch.float64)
    assert torch.allclose(out[0][inside], cal[0][inside], atol=1e-12)
    shift = np.array([[[1.0, 0, 3.0], [0, 1.0, -2.0]]])
    out, inside = ref.resample_rows(cal, shift, 0, 64, torch.float64)
    want = torch.roll(cal[0], shifts=(2, -3), dims=(0, 1))
    assert torch.allclose(out[0][inside], want[inside], atol=1e-12)


def test_clip_mean_drops_an_outlier():
    s = torch.full((9, 1), 100.0, dtype=torch.float64)
    s[:, 0] += torch.tensor([-1, 1, -2, 2, 0, 1, -1, 0, 0.0])
    s[4, 0] = 1e4
    got = ref.clip_mean(s, 5.0, 5.0)
    assert abs(float(got) - float(torch.cat([s[:4], s[5:]]).mean())) < 1e-12


@pytest.mark.parametrize("seed", [21, 2**31 + 3])
def test_port_within_and_control_beyond_the_limits(seed):
    from astrophotography_tpu_torch.models import pipeline as pl

    obs = _observation(seed)
    cfg = tiny_config("lean-16mpix-n100")
    image, diag = pl.calibrate_register_stack_lean(
        obs.frames, bias=obs.bias, dark=obs.dark, flat=obs.flat,
        exp_ratios=obs.exp_ratios, config=run.pipeline_config(cfg))
    assert int(diag["n_inliers"].min()) >= run.MIN_INLIERS
    r, compared = ref.reference_stack(obs, COMBINE)
    assert int(compared["sky"].sum()) > 0.5 * TINY["height"] * TINY["width"]
    assert int(compared["star"].sum()) > 0
    assert not bool((compared["sky"] & compared["star"]).any())
    port = ref.gaps(image, r, compared)
    solved = {k: diag[k].double().numpy()
              for k in ("scale", "theta", "tx", "ty")}
    port["reg_corner_px"] = float(ref.corner_errors(
        ref.maps_of(solved), obs.matrices, TINY["height"],
        TINY["width"]).max())
    low, _ = ref.reference_stack(obs, COMBINE, dtype=torch.bfloat16)
    control = ref.gaps(low, r, compared)
    for key, limit in TINY_LIMITS.items():
        assert port[key] <= limit, (key, port)
    assert any(control[k] > TINY_LIMITS[k] for k in TINY_LIMITS
               if k in control), control


def test_corner_errors_of_a_pixel_and_a_turn():
    truth = np.array([[[1.0, 0, 5.0], [0, 1.0, -3.0]]] * 3)
    solved = {"scale": np.ones(3), "theta": np.array([0.0, 0.0, 1e-3]),
              "tx": np.array([5.0, 6.0, 5.0]),
              "ty": np.array([-3.0, -3.0, -3.0])}
    maps = ref.maps_of(solved)
    assert np.allclose(maps[0], truth[0])
    err = ref.corner_errors(maps, truth, 100, 200)
    assert err[0] == 0.0 and abs(err[1] - 1.0) < 1e-12
    # a turn about the origin moves the far corner (199, 99) the most
    far = np.hypot(199.0, 99.0) * 2 * np.sin(0.5e-3)
    assert abs(err[2] - far) < 1e-9


def test_the_mix_has_hits_the_clip_rejects():
    obs = _observation(21)
    r, compared = ref.reference_stack(obs, COMBINE)
    n, h, w = obs.frames.shape
    cal = ref.calibrate(obs.frames, obs.bias, obs.dark, obs.flat,
                        obs.exp_ratios, torch.float64)
    plain = torch.zeros_like(r)
    for y0, y1 in ref.row_blocks(n, h, w):
        plain[y0:y1] = ref.resample_rows(cal, obs.matrices, y0, y1,
                                         torch.float64)[0].mean(dim=0)
    gap = ref.gaps(plain, r, compared)
    assert gap["sky_max_adu"] > 100.0 and gap["sky_rms_adu"] > 1.0


def _broken(monkeypatch, fault):
    """Break the lean path's timed call underneath the harness."""
    from astrophotography_tpu_torch.models import pipeline as pl

    solve, wc = pl._solve_frame_similarities, pl.warp_combine
    if fault == "registration returns its state unchanged":
        def broken(stars, n, config):
            sims, mats, ref_idx = solve(stars, n, config)
            eye = torch.zeros_like(mats)
            eye[:, 0, 0] = eye[:, 1, 1] = 1.0
            return sims, eye, ref_idx
        monkeypatch.setattr(pl, "_solve_frame_similarities", broken)
    elif fault == "half of the frames left out":
        def broken(frames, matrices, exp_ratios=None, **kw):
            h = frames.shape[0] // 2
            return wc(frames[:h], matrices[:h], exp_ratios=exp_ratios[:h],
                      **kw)
        monkeypatch.setattr(pl, "warp_combine", broken)
    elif fault == "an answer altered where it is made":
        def broken(*args, **kw):
            out = wc(*args, **kw)
            out[out.shape[0] // 2] += 30.0
            return out
        monkeypatch.setattr(pl, "warp_combine", broken)
    elif fault == "the clip left out (a plain mean)":
        def broken(*args, **kw):
            return wc(*args, **dict(kw, sigma_lower=1e30, sigma_upper=1e30))
        monkeypatch.setattr(pl, "warp_combine", broken)
    elif fault == "a frame's solve a pixel off":
        def broken(stars, n, config):
            sims, mats, ref_idx = solve(stars, n, config)
            mats = mats.clone()
            mats[n - 1, 0, 2] += 1.0
            tx = sims.tx.clone()
            tx[n - 1] += 1.0
            return sims._replace(tx=tx), mats, ref_idx
        monkeypatch.setattr(pl, "_solve_frame_similarities", broken)
    elif fault == "a frame misregistered by a pixel":
        def broken(stars, n, config):
            sims, mats, ref_idx = solve(stars, n, config)
            mats = mats.clone()
            mats[n - 1, 0, 2] += 1.0
            return sims, mats, ref_idx
        monkeypatch.setattr(pl, "_solve_frame_similarities", broken)


@pytest.mark.parametrize("fault", [
    "registration returns its state unchanged",
    "half of the frames left out",
    "an answer altered where it is made",
    "a frame misregistered by a pixel",
    "the clip left out (a plain mean)",
    "a frame's solve a pixel off",
])
def test_a_broken_timed_path_is_not_correct(tiny_registry, monkeypatch,
                                            fault):
    reg, _root = tiny_registry
    _broken(monkeypatch, fault)
    res = run.run_cell(reg, TINY_CELL, 2**31 + 5, 0.2,
                       False, "cpu")
    assert res["failed"] == 0
    assert not res["correct"], res["checks"]


def test_the_same_run_unbroken_is_correct(tiny_registry):
    reg, _root = tiny_registry
    res = run.run_cell(reg, TINY_CELL, 2**31 + 5, 0.2,
                       False, "cpu")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("field,value", [("n_inliers", 1), ("tx", 1e9)])
def test_an_unregistered_frame_fails_its_request(tiny_registry, monkeypatch,
                                                 field, value):
    from astrophotography_tpu_torch.models import pipeline as pl

    solve = pl._solve_frame_similarities

    def rejected(stars, n, config):
        sims, mats, ref_idx = solve(stars, n, config)
        col = getattr(sims, field).clone()
        col[-1] = value
        return sims._replace(**{field: col}), mats, ref_idx
    monkeypatch.setattr(pl, "_solve_frame_similarities", rejected)
    reg, _root = tiny_registry
    with pytest.raises(RuntimeError, match="warm-up"):
        run.run_cell(reg, TINY_CELL, 9, 0.2, False, "cpu")


@pytest.mark.gpu
def test_control_fails_on_the_card():
    """The control at the cell's own size on the card (run there with
    ``python -m pytest -m gpu stackbench/tests``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from stackbench import limits
    from stackbench.registry import Registry

    reg = Registry.load()
    cfg = reg.config("lean-rot-16mpix-n100")
    for out in limits.readings(reg, "lean-rot-16mpix-n100.rotate", [101],
                               {101}):
        program = dict(out["program"], reg_corner_px=out["reg_corner_px"])
        for key, limit in cfg["limits"].items():
            assert program[key] <= limit
        for fault in ("control", "plain_mean", "frame_px_off"):
            assert any(out[fault][k] > cfg["limits"][k]
                       for k in cfg["limits"] if k in out[fault]), fault
