"""Port parity: the affine warps (ops/warp) against the JAX package on
the same numpy images and matrices: the separable Lanczos3 (analytic and
warped-ones coverage, translation budget), the direct Lanczos3, bilinear,
and the coverage weight map; batched calls against the JAX function
vmapped over frames."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from astrophotography_tpu.ops import warp as jwarp
from astrophotography_tpu_torch.ops import warp as twarp
from astrophotography_tpu_torch.ops.register import REJECTED_TRANSLATION

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-3


#: XLA's CPU backend contracts a*b + c into a fused multiply-add, so the
#: reference's source coordinates differ from the port's op-by-op ones by
#: about an ulp (1.5e-5 px at 160 px).  On a smooth image that is far
#: inside RTOL / ATOL; on a steep star it is a few 1e-5 of the peak
#: (measured 2.8e-5 of a 5000 ADU, FWHM 3.3 px star), which STAR_RTOL bounds.
STAR_PEAK = 5000.0
STAR_RTOL = 6e-5


def _image(h, w, seed, star=False):
    """Smooth gradient + ripples + noise, and optionally a steep star."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = (100.0 + 0.7 * xx + 0.4 * yy + 20.0 * np.sin(xx * 0.21)
           * np.cos(yy * 0.13))
    if star:
        img += STAR_PEAK * np.exp(-0.5 * ((xx - w * 0.4) ** 2
                                          + (yy - h * 0.6) ** 2) / 2.0)
    return (img + rng.normal(0, 1, (h, w))).astype(np.float32)


def _mats(specs):
    out = []
    for theta, tx, ty in specs:
        c, s = np.cos(theta), np.sin(theta)
        out.append([[c, -s, tx], [s, c, ty]])
    return np.asarray(out, np.float32)


#: identity, sub-pixel and larger shifts, small rotations, a rejected frame
SPECS = [(0.0, 0.0, 0.0), (0.0, 3.37, -2.61), (0.002, -4.2, 1.9),
         (-0.003, 11.5, -7.25), (0.0, REJECTED_TRANSLATION,
                                 REJECTED_TRANSLATION)]


@functools.lru_cache(maxsize=None)
def _stack(star=False):
    imgs = np.stack([_image(96, 160, s, star) for s in range(len(SPECS))])
    return imgs, _mats(SPECS)


def _jax_batched(fn, imgs, mats, **kw):
    f = jax.jit(jax.vmap(lambda im, m: fn(im, m, **kw)))
    out, cov = f(jnp.asarray(imgs), jnp.asarray(mats))
    return np.asarray(out), np.asarray(cov)


def _compare(got, want, atol=ATOL):
    """Coverage everywhere; values where the coverage exceeds 0.5, the
    threshold every combine applies.  Below it a warped-ones coverage is
    a partial weight sum (an ulp of source coordinate moves it by ~1e-5)
    and the value divided by it amplifies that."""
    (go, gc), (wo, wc) = [(np.asarray(a), np.asarray(b)) for a, b in
                          ((got[0], got[1]), want)]
    assert np.isfinite(go).all() and np.isfinite(gc).all()
    np.testing.assert_allclose(gc, wc, rtol=RTOL, atol=ATOL)
    used = (gc > 0.5) | (wc > 0.5)
    np.testing.assert_allclose(go[used], wo[used], rtol=RTOL, atol=atol)


@pytest.mark.parametrize("analytic", [True, False])
@pytest.mark.parametrize("out_shape", [(96, 160), (48, 160)])
def test_separable_matches_jax(analytic, out_shape):
    imgs, mats = _stack()
    kw = dict(out_shape=out_shape, band=16, span=12,
              analytic_coverage=analytic)
    want = _jax_batched(jwarp.warp_affine_separable, imgs, mats, **kw)
    got = twarp.warp_affine_separable(torch.from_numpy(imgs),
                                      torch.from_numpy(mats), **kw)
    _compare(got, want)
    # the rejected frame is excluded with finite values
    assert (got[1][-1] == 0).all() and (got[0][-1] == 0).all()
    assert (got[1][0] > 0.5).float().mean() > 0.8


def test_separable_star_within_coordinate_ulp():
    """With a steep star the only difference is the reference's fused
    multiply-add in the source coordinates (see STAR_RTOL)."""
    imgs, mats = _stack(star=True)
    kw = dict(out_shape=(96, 160), band=16, span=12, analytic_coverage=True)
    want = _jax_batched(jwarp.warp_affine_separable, imgs, mats, **kw)
    got = twarp.warp_affine_separable(torch.from_numpy(imgs),
                                      torch.from_numpy(mats), **kw)
    _compare(got, want, atol=STAR_RTOL * STAR_PEAK)


def test_separable_translation_budget_matches_jax():
    imgs, mats = _stack()
    kw = dict(out_shape=(96, 160), band=32, span=12, analytic_coverage=True,
              translation_budget=20)
    want = _jax_batched(jwarp.warp_affine_separable, imgs, mats, **kw)
    got = twarp.warp_affine_separable(torch.from_numpy(imgs),
                                      torch.from_numpy(mats), **kw)
    _compare(got, want)
    with pytest.raises(ValueError, match="translation_budget"):
        twarp.warp_affine_separable(torch.from_numpy(imgs[0]),
                                    torch.from_numpy(mats[0]), (96, 160),
                                    span=12, translation_budget=16)


@pytest.mark.parametrize("tx,ty", [(-28.0, -27.0), (-40.0, 10.0),
                                   (15.0, -35.0)])
def test_separable_large_negative_translation_matches_jax(tx, ty):
    """Shifts left / up beyond the span (the case a span-sized pad once
    clipped in the reference), one (H, W) frame at a time."""
    rng = np.random.default_rng(3)
    img = (np.add.outer(np.linspace(100, 400, 96), np.linspace(0, 100, 96))
           + rng.normal(0, 1, (96, 96))).astype(np.float32)
    m = np.array([[1.0, 0.0, tx], [0.0, 1.0, ty]], np.float32)
    for analytic in (True, False):
        want = jwarp.warp_affine_separable(jnp.asarray(img), jnp.asarray(m),
                                           (96, 96),
                                           analytic_coverage=analytic)
        got = twarp.warp_affine_separable(torch.from_numpy(img),
                                          torch.from_numpy(m), (96, 96),
                                          analytic_coverage=analytic)
        assert got[0].shape == (96, 96)
        _compare(got, want)
        assert (got[1] > 0.5).sum() > 2000


@pytest.mark.parametrize("name", ["warp_affine_lanczos3",
                                  "warp_affine_bilinear"])
def test_gather_warps_match_jax(name):
    imgs, mats = _stack()
    want = _jax_batched(getattr(jwarp, name), imgs, mats, out_shape=(80, 150))
    got = getattr(twarp, name)(torch.from_numpy(imgs), torch.from_numpy(mats),
                               (80, 150))
    _compare(got, want)
    single = getattr(twarp, name)(torch.from_numpy(imgs[2]),
                                  torch.from_numpy(mats[2]), (80, 150))
    np.testing.assert_array_equal(single[0].numpy(), got[0][2].numpy())


def test_lanczos_weights_match_jax():
    frac = np.linspace(0.0, 0.999, 257, dtype=np.float32)
    want = np.asarray(jwarp._lanczos_weights(jnp.asarray(frac)))
    got = twarp._lanczos_weights(torch.from_numpy(frac)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_coverage_weight_map_matches_jax():
    _imgs, mats = _stack()
    wts = np.linspace(0.5, 2.0, len(mats)).astype(np.float32)
    want = np.asarray(jwarp.coverage_weight_map(
        jnp.asarray(mats), (96, 160), (100, 170), jnp.asarray(wts)))
    got = twarp.coverage_weight_map(torch.from_numpy(mats), (96, 160),
                                    (100, 170), torch.from_numpy(wts)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.max() == pytest.approx(wts[:-1].sum())  # rejected frame: 0
