"""Port parity: the unfused calibrate -> detect -> register -> warp ->
stack path (``calibrate_register_stack``) end to end against the JAX
package on the same raw frames and masters (its K3 and K2 Pallas kernels
in interpret mode on the CPU backend), the calibration it starts from,
and the lean path's chunked detection branch."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu.models import PipelineConfig as JaxConfig
from astrophotography_tpu.models.pipeline import (
    calibrate_register_stack as jax_unfused,
    calibrate_register_stack_lean as jax_lean)
from astrophotography_tpu.ops import calibrate as jcal
from astrophotography_tpu_torch.models import (PipelineConfig,
                                               calibrate_register_stack,
                                               calibrate_register_stack_lean,
                                               from_jax_config)
from astrophotography_tpu_torch.models.pipeline import combine_band
from astrophotography_tpu_torch.ops import calibrate as tcal
from astrophotography_tpu_torch.ops.clip_combine import clip_combine
from astrophotography_tpu_torch.ops.stack import sigma_clip_combine
from tests.test_register_stack import _make_dithered_stack

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

N, H, W = 4, 192, 192
BASE = dict(max_stars=32, match_k=10, detect_nsigma=7.0)
#: registration agreement (px); the stacks use tests/test_pipeline_banding
#: bounds: median |diff| < 1e-3 and > 1 ADU on < 0.5% of the pixels
T_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def _inputs():
    """4 dithered, rotated frames as raw uint16 with bias, dark (exp
    ratio 2) and a flat, plus per-frame flux scales."""
    frames, _truths, _ = _make_dithered_stack(n_frames=N, shape=(H, W),
                                              seed=5)
    rng = np.random.default_rng(5)
    bias = (250.0 + rng.normal(0, 2.0, (H, W))).astype(np.float32)
    dark = np.abs(rng.normal(3.0, 1.0, (H, W))).astype(np.float32)
    dark[50, 60] = 900.0                                   # a hot pixel
    flat = (1.0 + 0.1 * np.cos(np.arange(W) * 0.013)[None, :]
            * np.ones((H, 1))).astype(np.float32)
    flat[10, 10] = 0.0                                     # a dead flat pixel
    raw = np.clip(frames * flat + bias + 2.0 * (dark + bias), 0, 65535) \
        .astype(np.uint16)
    kw = dict(bias=bias, dark=dark + bias, flat=flat,
              exp_ratios=np.full((N,), 2.0, np.float32))
    fs = np.array([1.0, 0.9, 1.1, 1.05], np.float32)
    return raw, kw, fs


@functools.lru_cache(maxsize=None)
def _jax_run(fn_name, cfg_items, flux):
    """The JAX pipeline's (stack, diagnostics) as numpy, once per config."""
    raw, kw, fs = _inputs()
    fn = {"unfused": jax_unfused, "lean": jax_lean}[fn_name]
    extra = {"flux_scales": jnp.asarray(fs)} if flux else {}
    out, diag = fn(jnp.asarray(raw), config=JaxConfig(**dict(cfg_items)),
                   **{k: jnp.asarray(v) for k, v in kw.items()}, **extra)
    return np.asarray(out), {k: np.asarray(v) for k, v in diag.items()}


def _check(fn_name, port_fn, cfg, flux=False):
    raw, kw, fs = _inputs()
    want, dj = _jax_run(fn_name, tuple(sorted(cfg.items())), flux)
    extra = {"flux_scales": torch.from_numpy(fs)} if flux else {}
    got, dt = port_fn(torch.from_numpy(raw),
                      config=from_jax_config(JaxConfig(**cfg)),
                      **{k: torch.from_numpy(v) for k, v in kw.items()},
                      **extra)
    got = got.numpy()
    assert got.shape == (H, W) and np.isfinite(got).all()
    assert int(dt["ref_frame"]) == int(dj["ref_frame"])
    np.testing.assert_array_equal(dt["n_stars"].numpy(), dj["n_stars"])
    np.testing.assert_array_equal(dt["n_inliers"].numpy(), dj["n_inliers"])
    assert (dt["n_inliers"].numpy() >= 5).all()
    for k in ("tx", "ty"):
        np.testing.assert_allclose(dt[k].numpy(), dj[k], rtol=0, atol=T_TOL)
    if "matrices" in dj:
        np.testing.assert_allclose(dt["matrices"].numpy(), dj["matrices"],
                                   rtol=0, atol=T_TOL)
    used = np.ones_like(got, bool)
    if fn_name == "lean":
        # the reference's K2 in interpret mode reads never-written window
        # rows as NaN and drops pixels whose taps rotate into them (here
        # 2.4%, along the top rows; ROADMAP.md section 3): compare where
        # it covers, and require the port to cover at least that
        assert (got[want != 0] != 0).all()
        used = want != 0
        assert used.mean() > 0.95
    diff = np.abs(got - want)[used]
    assert np.median(diff) < 1e-3
    assert (diff > 1.0).mean() < 0.005
    assert (got != 0).mean() > 0.8
    return got, want


@pytest.mark.parametrize("combine_impl,n_bands,extra", [
    ("xla", 1, {}),
    ("xla", 4, {}),
    ("pallas", 1, {}),
    ("pallas", 4, {"flux": True}),
    ("fused", 1, {}),
    ("pallas", 4, {"detect_mode": "chunked", "detect_chunk": 2}),
    ("xla", 2, {"interp": "lanczos3"}),
    ("xla", 1, {"interp": "bilinear", "combine": "median"}),
])
def test_unfused_pipeline_matches_jax(combine_impl, n_bands, extra):
    extra = dict(extra)
    flux = extra.pop("flux", False)
    cfg = dict(BASE, combine_impl=combine_impl, n_bands=n_bands, **extra)
    _check("unfused", calibrate_register_stack, cfg, flux=flux)


@pytest.mark.parametrize("combine", ["average", "median", "sum"])
@pytest.mark.parametrize("combine_impl", ["xla", "pallas"])
def test_combine_band_rule(combine_impl, combine):
    """``combine_band``'s one rule: 'average' is ``clip_combine``'s image
    (K3's twin on the CPU) under 'xla' and 'pallas' alike, 'median' and
    'sum' ``sigma_clip_combine``'s, on the numeric coverage a warp hands
    it; a pixel no frame covers is 0."""
    rng = np.random.default_rng(23)
    warped = rng.normal(800.0, 8.0, (9, 12, 16)).astype(np.float32)
    warped[rng.uniform(size=warped.shape) < 0.03] = 40000.0
    weights = rng.uniform(0.0, 1.0, warped.shape).astype(np.float32)
    weights[:, 0, 0] = 0.25
    warped, weights = torch.from_numpy(warped), torch.from_numpy(weights)
    cfg = PipelineConfig(combine_impl=combine_impl, combine=combine,
                         sigma_lower=3.0, sigma_upper=4.0)
    got = combine_band(warped, weights, cfg)
    mask = weights > 0.5
    if combine == "average":
        want = clip_combine(warped, mask, sigma_lower=3.0, sigma_upper=4.0)
    else:
        want = sigma_clip_combine(warped, mask=mask, sigma_lower=3.0,
                                  sigma_upper=4.0, method=combine)
    want = torch.where(torch.isnan(want), 0.0, want)
    assert torch.equal(got, want)
    assert got[0, 0] == 0.0 and bool((got[1:, 1:] > 700.0).all())


def test_lean_chunked_detection_matches_jax():
    """The lean path's chunked branch (calibrate_batch + noise stats +
    find_stars per chunk), which 'auto' takes on frames the fused
    detector cannot use (192 % 256 != 0 here), with the 'median' noise
    centre (the 'mean' one is held by the unfused cases above)."""
    cfg = dict(BASE, detect_impl="chunked", detect_mode="chunked",
               detect_chunk=2, noise_center="median")
    _check("lean", calibrate_register_stack_lean, cfg)
    # 'auto' on this geometry takes the same branch
    raw, kw, _fs = _inputs()
    auto = dict(cfg, detect_impl="auto")
    a, _ = calibrate_register_stack_lean(
        torch.from_numpy(raw), config=from_jax_config(JaxConfig(**auto)),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    c, _ = calibrate_register_stack_lean(
        torch.from_numpy(raw), config=from_jax_config(JaxConfig(**cfg)),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert torch.equal(a, c)


def test_unfused_config_errors_match_jax():
    raw, kw, _fs = _inputs()
    frames = torch.from_numpy(raw)
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    with pytest.raises(ValueError, match="subsumes banding"):
        calibrate_register_stack(frames, config=from_jax_config(JaxConfig(
            **BASE, combine_impl="fused", n_bands=4)), **tkw)
    with pytest.raises(ValueError, match="not divisible by n_bands"):
        calibrate_register_stack(frames, config=from_jax_config(JaxConfig(
            **BASE, n_bands=5)), **tkw)
    with pytest.raises(ValueError, match="not divisible by detect_chunk"):
        calibrate_register_stack(frames, config=from_jax_config(JaxConfig(
            **BASE, detect_mode="chunked", detect_chunk=3)), **tkw)
    with pytest.raises(ValueError, match="interp"):
        calibrate_register_stack(frames, config=from_jax_config(JaxConfig(
            **BASE, interp="cubic")), **tkw)


@pytest.mark.parametrize("dark_still_biased", [True, False])
def test_calibrate_matches_jax(dark_still_biased):
    """calibrate_batch and calibrate_frame: the flat division (not a
    multiply by 1/flat), the dead flat pixel left undivided, the
    dark_still_biased rule."""
    raw, kw, _fs = _inputs()
    er = np.array([2.0, 1.5, 0.5, 1.0], np.float32)
    args = [kw["bias"], kw["dark"], kw["flat"]]
    want = np.asarray(jcal.calibrate_batch(
        jnp.asarray(raw), *map(jnp.asarray, args), jnp.asarray(er),
        dark_still_biased=dark_still_biased))
    got = tcal.calibrate_batch(torch.from_numpy(raw),
                               *map(torch.from_numpy, args),
                               torch.from_numpy(er),
                               dark_still_biased=dark_still_biased).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert got[0, 10, 10] == pytest.approx(
        float(raw[0, 10, 10]) - kw["bias"][10, 10]
        - 2.0 * (kw["dark"][10, 10] - (kw["bias"][10, 10]
                                       if dark_still_biased else 0.0)),
        rel=1e-6)
    one = np.asarray(jcal.calibrate_frame(
        jnp.asarray(raw[1]), *map(jnp.asarray, args), exp_ratio=1.5,
        dark_still_biased=dark_still_biased))
    got1 = tcal.calibrate_frame(torch.from_numpy(raw[1]),
                                *map(torch.from_numpy, args), exp_ratio=1.5,
                                dark_still_biased=dark_still_biased).numpy()
    np.testing.assert_allclose(got1, one, rtol=1e-6, atol=1e-4)
    # a mask with nothing flagged repairs nothing
    same = tcal.calibrate_batch(torch.from_numpy(raw),
                                *map(torch.from_numpy, args),
                                torch.from_numpy(er),
                                dark_still_biased=dark_still_biased,
                                badpix_mask=torch.zeros((H, W), dtype=bool))
    np.testing.assert_array_equal(same.numpy(), got)
