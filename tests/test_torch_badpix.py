"""Port parity: bad-pixel detection and repair (``ops/badpix``), the
calibration that ends in the repair, and the unfused pipeline with a
bad-pixel mask, against the JAX package on the same numpy inputs."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu.models import PipelineConfig as JaxConfig
from astrophotography_tpu.models.pipeline import (
    calibrate_register_stack as jax_unfused)
from astrophotography_tpu.ops import badpix as jbad
from astrophotography_tpu.ops import calibrate as jcal
from astrophotography_tpu_torch.models import (calibrate_register_stack,
                                               from_jax_config)
from astrophotography_tpu_torch.ops import badpix as tbad
from astrophotography_tpu_torch.ops import calibrate as tcal
from tests.test_register_stack import _make_dithered_stack

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

H, W = 48, 64
#: repaired values: medians of identical float32 values, so 1e-6 relative
RTOL = 1e-6


def _image(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(500.0, 12.0, (H, W)).astype(np.float32)
    bad = rng.random((H, W)) < 0.03
    bad[0, 0] = bad[0, 5] = bad[H - 1, W - 1] = bad[20, 0] = True   # edges
    bad[10:13, 10:13] = True            # a 3x3 block: its centre has no
    bad[30:35, 40:45] = True            # good neighbour at deltapix 1; 5x5
    img[bad] += 4000.0
    return img, bad


@pytest.mark.parametrize("deltapix,min_valid", [(1, 4), (2, 4), (1, 8),
                                                (2, 30)])
def test_fix_bad_pixels_matches_jax(deltapix, min_valid):
    """Edges, the original data as the source, and ``min_valid`` not met
    (the centres of the bad blocks stay bad)."""
    img, bad = _image()
    want, want_still = jbad.fix_bad_pixels(jnp.asarray(img), jnp.asarray(bad),
                                           deltapix=deltapix,
                                           min_valid=min_valid)
    got, still = tbad.fix_bad_pixels(torch.from_numpy(img),
                                     torch.from_numpy(bad), deltapix=deltapix,
                                     min_valid=min_valid)
    np.testing.assert_array_equal(still.numpy(), np.asarray(want_still))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    if deltapix == 1:
        assert still.numpy()[11, 11]        # no good neighbour at all
    assert (got.numpy()[~bad] == img[~bad]).all()
    # a uint8 mask (MASK_* values) means the same as the boolean one
    got8, _ = tbad.fix_bad_pixels(
        torch.from_numpy(img),
        torch.from_numpy(bad.astype(np.uint8) * tbad.MASK_USER_BAD),
        deltapix=deltapix, min_valid=min_valid)
    assert torch.equal(got8, got)


def test_neighbor_stack_matches_jax():
    img, _ = _image(1)
    for d in (1, 2):
        np.testing.assert_array_equal(
            tbad._neighbor_stack(torch.from_numpy(img), d).numpy(),
            np.asarray(jbad._neighbor_stack(jnp.asarray(img), d)))


@pytest.mark.parametrize("sigma", [4.0, 3.0])
def test_sigmaclip_badpix_mask_matches_jax(sigma):
    rng = np.random.default_rng(2)
    dark = rng.normal(100.0, 3.0, (H, W)).astype(np.float32)
    hot = rng.random((H, W)) < 0.01
    dark[hot] += rng.uniform(30, 3000, hot.sum()).astype(np.float32)
    dark[5, 5] = 0.0                                    # a dead pixel
    want = np.asarray(jbad.sigmaclip_badpix_mask(jnp.asarray(dark),
                                                 sigma=sigma))
    got = tbad.sigmaclip_badpix_mask(torch.from_numpy(dark), sigma=sigma)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[hot].mean() > 0.9 and got.numpy()[5, 5] == 1
    assert (tbad.MASK_GOOD, tbad.MASK_AUTO_BAD, tbad.MASK_USER_BAD) == \
        (jbad.MASK_GOOD, jbad.MASK_AUTO_BAD, jbad.MASK_USER_BAD)


def test_sliding_windows_match_jax():
    vec = np.arange(17, dtype=np.float32) ** 1.5
    for window in (5, 11):
        want, want_ok = jbad._sliding_windows_1d(jnp.asarray(vec), window)
        got, ok = tbad._sliding_windows_1d(torch.from_numpy(vec), window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))


@pytest.mark.parametrize("axis", [0, 1])
def test_auto_badcols_matches_jax(axis):
    rng = np.random.default_rng(3)
    img = rng.normal(200.0, 4.0, (H, W)).astype(np.float32)
    if axis == 0:
        img[:, 17] += 60.0
        img[:, 40] -= 45.0
    else:
        img[9, :] += 60.0
        img[30, :] -= 45.0
    want = np.asarray(jbad.auto_badcols(jnp.asarray(img), axis=axis))
    got = tbad.auto_badcols(torch.from_numpy(img), axis=axis).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() >= 2 and got.shape == ((W,) if axis == 0 else (H,))


def test_combine_user_badpix_matches_jax():
    kw = dict(bad_columns=(3, 64), bad_rows=(1, 20),
              bad_rectangles=((5, 9, 30, 33),))
    want = np.asarray(jbad.combine_user_badpix((H, W), **kw))
    got = tbad.combine_user_badpix((H, W), device="cpu", **kw)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tbad.combine_user_badpix((H, W), **kw)


def _masters(rng, h, w):
    bias = (250.0 + rng.normal(0, 2.0, (h, w))).astype(np.float32)
    dark = (np.abs(rng.normal(3.0, 1.0, (h, w))) + bias).astype(np.float32)
    flat = (1.0 + 0.1 * np.cos(np.arange(w) * 0.013)[None, :]
            * np.ones((h, 1))).astype(np.float32)
    return bias, dark, flat


@pytest.mark.parametrize("deltapix", [1, 2])
def test_calibrate_with_badpix_matches_jax(deltapix):
    """calibrate_frame / calibrate_batch repair after the arithmetic,
    every frame on its own; the input stack is left as it was."""
    rng = np.random.default_rng(4)
    _img, bad = _image(4)
    raw = rng.integers(300, 4000, (3, H, W)).astype(np.uint16)
    raw[:, bad] = 65000
    masters = _masters(rng, H, W)
    er = np.array([2.0, 1.0, 0.5], np.float32)
    want = np.asarray(jcal.calibrate_batch(
        jnp.asarray(raw), *map(jnp.asarray, masters), jnp.asarray(er),
        badpix_mask=jnp.asarray(bad), deltapix=deltapix))
    got = tcal.calibrate_batch(
        torch.from_numpy(raw), *map(torch.from_numpy, masters),
        torch.from_numpy(er), badpix_mask=torch.from_numpy(bad),
        deltapix=deltapix).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert (got[:, bad] < 10000).mean() > 0.8       # most were repaired
    one = np.asarray(jcal.calibrate_frame(
        jnp.asarray(raw[1]), *map(jnp.asarray, masters), exp_ratio=1.5,
        badpix_mask=jnp.asarray(bad), deltapix=deltapix))
    got1 = tcal.calibrate_frame(
        torch.from_numpy(raw[1]), *map(torch.from_numpy, masters),
        exp_ratio=1.5, badpix_mask=torch.from_numpy(bad),
        deltapix=deltapix).numpy()
    np.testing.assert_allclose(got1, one, rtol=1e-6, atol=1e-4)
    # float32 frames without masters: the caller's stack is not written to
    cal = torch.from_numpy(raw.astype(np.float32))
    keep = cal.clone()
    fixed = tcal.calibrate_batch(cal, badpix_mask=torch.from_numpy(bad),
                                 deltapix=deltapix)
    assert torch.equal(cal, keep) and not torch.equal(fixed, cal)


@functools.lru_cache(maxsize=None)
def _pipeline_inputs():
    n, h, w = 4, 192, 192
    frames, _truths, _ = _make_dithered_stack(n_frames=n, shape=(h, w),
                                              seed=5)
    rng = np.random.default_rng(5)
    bias, dark, flat = _masters(rng, h, w)
    raw = frames * flat + bias + 2.0 * dark
    hot = rng.random((h, w)) < 0.002
    raw[:, hot] += 30000.0
    raw = np.clip(raw, 0, 65535).astype(np.uint16)
    kw = dict(bias=bias, dark=dark, flat=flat,
              exp_ratios=np.full((n,), 2.0, np.float32))
    return raw, kw, hot


@pytest.mark.parametrize("combine_impl,n_bands", [("xla", 1), ("pallas", 2)])
def test_unfused_pipeline_with_badpix_matches_jax(combine_impl, n_bands):
    """``calibrate_register_stack`` with ``badpix_mask`` against the JAX
    pipeline at tests/test_torch_unfused_pipeline.py's tolerances:
    translations to 1e-3 px, median |diff| < 1e-3 and > 1 ADU on < 0.5 %
    of the pixels."""
    raw, kw, hot = _pipeline_inputs()
    cfg = dict(max_stars=32, match_k=10, detect_nsigma=7.0,
               combine_impl=combine_impl, n_bands=n_bands)
    want, dj = jax_unfused(jnp.asarray(raw), badpix_mask=jnp.asarray(hot),
                           config=JaxConfig(**cfg),
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    got, dt = calibrate_register_stack(
        torch.from_numpy(raw), badpix_mask=torch.from_numpy(hot),
        config=from_jax_config(JaxConfig(**cfg)),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(dt["n_stars"].numpy(),
                                  np.asarray(dj["n_stars"]))
    np.testing.assert_array_equal(dt["n_inliers"].numpy(),
                                  np.asarray(dj["n_inliers"]))
    assert (dt["n_inliers"].numpy() >= 5).all()
    for k in ("tx", "ty"):
        np.testing.assert_allclose(dt[k].numpy(), np.asarray(dj[k]), rtol=0,
                                   atol=1e-3)
    diff = np.abs(got - want)
    assert np.median(diff) < 1e-3
    assert (diff > 1.0).mean() < 0.005
    # the hot pixels were repaired in every frame, so none survives
    assert got[hot].max() < 10000.0
