"""Port parity: DAOFIND star detection (ops/detect.find_stars), its
static-stencil correlation (ops/stencil) and the lax.top_k tie order,
against the JAX package on the same numpy inputs."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from astrophotography_tpu import synth
from astrophotography_tpu.ops import detect as jdetect
from astrophotography_tpu.ops import stencil as jstencil
from astrophotography_tpu_torch.models.config import stars_to_numpy
from astrophotography_tpu_torch.ops import detect as tdetect
from astrophotography_tpu_torch.ops import stencil as tstencil

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

H, W = 256, 1024
MAX_STARS = 12


@functools.lru_cache(maxsize=None)
def _frames():
    """Two background-subtracted star fields (~24 stars each, more than
    MAX_STARS), their per-frame thresholds and floors."""
    frames = []
    for seed in (1, 2):
        img, _ = synth.make_starfield((H, W), n_stars=24, background=300.0,
                                      read_noise=4.0, seed=seed, margin=20,
                                      min_sep=24.0)
        frames.append(img)
    frames = np.stack(frames).astype(np.float32)
    floors = np.array([300.0, 302.5], np.float32)
    thr = np.array([40.0, 55.0], np.float32)
    return frames, thr, floors


def _jax_stars(frames, thr, floors, **kw):
    tables = [stars_to_numpy(jdetect.find_stars(
        jnp.asarray(f), threshold=jnp.float32(t), floor=jnp.float32(c),
        **kw)) for f, t, c in zip(frames, thr, floors)]
    return {k: np.stack([t[k] for t in tables]) for k in tables[0]}


def _assert_stars_close(got, want):
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    np.testing.assert_allclose(got["x"][v], want["x"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["y"][v], want["y"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["flux"][v], want["flux"][v], rtol=1e-5)
    for k in ("peak", "sharpness", "roundness"):
        np.testing.assert_allclose(got[k][v], want[k][v], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("bin_rows,stats", [(False, False), (False, True),
                                            (True, False)])
@pytest.mark.parametrize("topk_mode", ["global", "tile"])
@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_find_stars_matches_jax(mode, topk_mode, bin_rows, stats):
    """A batch of two frames with per-frame thresholds and floors against
    the JAX function frame by frame."""
    frames, thr, floors = _frames()
    kw = dict(fwhm=3.0, max_stars=MAX_STARS, topk_mode=topk_mode, mode=mode,
              stats=stats, bin_rows=bin_rows)
    want = _jax_stars(frames, thr, floors, **kw)
    got = stars_to_numpy(tdetect.find_stars(
        torch.from_numpy(frames), threshold=torch.from_numpy(thr),
        floor=torch.from_numpy(floors), **kw))
    assert want["valid"].sum(axis=1).min() >= 8
    _assert_stars_close(got, want)


def test_find_stars_single_frame_and_mask():
    """One (H, W) frame with scalar threshold and an exclusion mask."""
    frames, _thr, _floors = _frames()
    mask = np.zeros((H, W), bool)
    mask[:, :300] = True
    kw = dict(threshold=45.0, max_stars=MAX_STARS, floor=300.0)
    want = stars_to_numpy(jdetect.find_stars(
        jnp.asarray(frames[0]), mask=jnp.asarray(mask), **kw))
    got = stars_to_numpy(tdetect.find_stars(
        torch.from_numpy(frames[0]), mask=torch.from_numpy(mask), **kw))
    assert got["x"].shape == (MAX_STARS,)
    _assert_stars_close(got, want)
    assert (got["x"][got["valid"]] >= 300).all()
    with pytest.raises(ValueError, match="bin_rows"):
        tdetect.find_stars(torch.from_numpy(frames[0]), mode="fast",
                           bin_rows=True, stats=True)


@pytest.mark.parametrize("topk_mode", ["global", "tile"])
def test_find_stars_plateau_ties_keep_jax_order(topk_mode):
    """Identical stars at integer positions tie exactly in the bf16 fast
    density; more stars than slots, so both the tie order inside the
    table and which tied stars make the cut must follow lax.top_k."""
    img = np.full((H, W), 10.0, np.float32)
    stamp = synth.gaussian_star((15, 15), 7.0, 7.0, 50000.0, 3.0)
    for k in range(16):
        y0 = 20 + 64 * (k % 4) if k % 2 else 40 + 60 * (k % 3)
        x0 = 30 + 60 * k
        img[y0 - 7:y0 + 8, x0 - 7:x0 + 8] += stamp.astype(np.float32)
    kw = dict(threshold=20.0, max_stars=MAX_STARS, mode="fast", stats=False,
              topk_mode=topk_mode, floor=10.0)
    want = stars_to_numpy(jdetect.find_stars(jnp.asarray(img), **kw))
    got = stars_to_numpy(tdetect.find_stars(torch.from_numpy(img), **kw))
    assert want["valid"].all()
    assert len(np.unique(want["flux"])) < MAX_STARS     # real ties
    np.testing.assert_array_equal(got["flux"], want["flux"])
    np.testing.assert_allclose(got["x"], want["x"], atol=1e-4)
    np.testing.assert_allclose(got["y"], want["y"], atol=1e-4)


def test_top_k_tie_order_matches_lax():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 6, (3, 500)).astype(np.float32)
    x[1, :] = -np.inf
    x[1, 17] = 2.0
    for k in (1, 7, 40):
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        gv, gi = tdetect._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_daofind_kernel_matches_jax():
    for fwhm in (2.5, 3.0, 4.7):
        k_j, foot_j, r_j = jdetect.daofind_kernel(fwhm)
        k_t, foot_t, r_t = tdetect.daofind_kernel(fwhm)
        assert r_t == r_j
        np.testing.assert_array_equal(k_t, k_j)
        np.testing.assert_array_equal(foot_t.numpy(), np.asarray(foot_j))


@pytest.mark.parametrize("pad_mode", ["zero", "edge", "reflect"])
def test_conv2d_static_matches_jax(pad_mode):
    rng = np.random.default_rng(7)
    img = rng.normal(0, 10, (37, 53)).astype(np.float32)
    kernel = np.array([[0.0, 1.0, 0.0, -0.5, 0.0],
                       [2.0, 0.25, 0.0, 0.0, 1.5],
                       [0.0, -1.0, 4.0, 0.0, 0.0]], np.float32)
    want = np.asarray(jstencil.conv2d_static(jnp.asarray(img), kernel,
                                             pad_mode=pad_mode))
    got = tstencil.conv2d_static(torch.from_numpy(img), kernel,
                                 pad_mode=pad_mode).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="pad_mode"):
        tstencil.conv2d_static(torch.from_numpy(img), kernel, pad_mode="wrap")
