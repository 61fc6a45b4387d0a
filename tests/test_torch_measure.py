"""Port parity: the star-measurement and image-repair ops (saturated
peaks and box masks, the similarity's apply / inverse, image arithmetic,
aperture photometry, PSF fits, background, L.A.Cosmic, the colour
stretch) against the JAX package on the same numpy inputs."""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu.ops import background as jbg
from astrophotography_tpu.ops import composite as jcomp
from astrophotography_tpu.ops import cosmic as jcos
from astrophotography_tpu.ops import detect as jdet
from astrophotography_tpu.ops import photometry as jphot
from astrophotography_tpu.ops import psf as jpsf
from astrophotography_tpu.ops import register as jreg
from astrophotography_tpu_torch import ops as tops
from astrophotography_tpu_torch.ops import background as tbg
from astrophotography_tpu_torch.ops import composite as tcomp
from astrophotography_tpu_torch.ops import cosmic as tcos
from astrophotography_tpu_torch.ops import detect as tdet
from astrophotography_tpu_torch.ops import photometry as tphot
from astrophotography_tpu_torch.ops import psf as tpsf
from astrophotography_tpu_torch.ops import register as treg

# ``ops.imarith`` is the function in both packages (it shadows its module)
jari = importlib.import_module("astrophotography_tpu.ops.imarith")
tari = importlib.import_module("astrophotography_tpu_torch.ops.imarith")

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

H, W = 96, 128
FWHM = 3.2


def _t(x):
    return torch.from_numpy(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _starfield(seed=0, sky=120.0, noise=True):
    """(image, x, y, amplitude) of 14 Gaussian stars on a flat sky with
    Poisson-like noise: two at the border, twelve on a jittered grid, at
    least 16 px apart (the fit box) so that no fit sees a neighbour."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    gx, gy = np.meshgrid([20.0, 48.0, 76.0, 104.0], [18.0, 48.0, 78.0])
    xs = np.concatenate([[2.3, W - 3.4],          # left border, corner
                         gx.ravel() + rng.uniform(-4, 4, 12)])
    ys = np.concatenate([[33.1, H - 2.2], gy.ravel() + rng.uniform(-4, 4, 12)])
    amps = rng.uniform(800, 9000, xs.size)
    sig = FWHM / 2.35482
    img = np.full((H, W), sky)
    for x0, y0, a in zip(xs, ys, amps):
        img += a * np.exp(-0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2) / sig ** 2)
    if noise:
        img += rng.normal(0, 1, img.shape) * np.sqrt(img) * 0.5
    return (img.astype(np.float32), xs.astype(np.float32),
            ys.astype(np.float32), amps.astype(np.float32))


# ---- detect.find_saturated / mask_boxes -------------------------------

def test_find_saturated_matches_jax_with_plateau():
    """A saturated plateau is many equal values: the order among them is
    ``lax.top_k``'s (lowest index first), so the capacity cut keeps the
    same pixels."""
    img, xs, ys, _ = _starfield(1)
    img = img.copy()
    img[30:34, 50:55] = 65535.0                   # a 4x5 plateau
    img[70, 20] = 65000.0
    img[10:12, 100:102] = 64000.0
    for max_peaks in (8, 64):
        want = jdet.find_saturated(jnp.asarray(img), 60000.0,
                                   max_peaks=max_peaks)
        got = tdet.find_saturated(_t(img), 60000.0, max_peaks=max_peaks)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].sum() == 20 + 1 + 4
    want = jdet.find_saturated(jnp.asarray(img), 60000.0, max_peaks=16, box=5)
    got = tdet.find_saturated(_t(img), 60000.0, max_peaks=16, box=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("half_width", [0, 3, 9])
def test_mask_boxes_matches_jax(half_width):
    xs = np.array([5.0, 0.0, 127.0, 60.5, 300.0, 64.0, -2.0], np.float32)
    ys = np.array([5.0, 0.0, 95.0, 40.25, 10.0, 48.0, 50.0], np.float32)
    valid = np.array([1, 1, 1, 1, 1, 0, 1], bool)
    want = np.asarray(jdet.mask_boxes((H, W), jnp.asarray(xs),
                                      jnp.asarray(ys), jnp.asarray(valid),
                                      half_width))
    got = tdet.mask_boxes((H, W), _t(xs), _t(ys), _t(valid), half_width)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any()


# ---- register.Similarity ----------------------------------------------

def test_similarity_apply_inverse_match_jax():
    rng = np.random.default_rng(2)
    f = [rng.uniform(0.9, 1.1, 5), rng.uniform(-0.2, 0.2, 5),
         rng.uniform(-30, 30, 5), rng.uniform(-30, 30, 5),
         rng.integers(5, 20, 5).astype(np.float64), rng.uniform(0, 1, 5)]
    f = [v.astype(np.float32) for v in f]
    x = rng.uniform(0, 500, 5).astype(np.float32)
    y = rng.uniform(0, 500, 5).astype(np.float32)
    js = jreg.Similarity(*map(jnp.asarray, f))
    ts = treg.Similarity(*map(_t, f))
    for g, w in zip(ts.apply(_t(x), _t(y)), js.apply(jnp.asarray(x),
                                                     jnp.asarray(y))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-4)
    for g, w in zip(ts.inverse(), js.inverse()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-5)
    # the inverse undoes the map (float32: 1e-3 px at 500 px)
    bx, by = ts.inverse().apply(*ts.apply(_t(x), _t(y)))
    np.testing.assert_allclose(bx.numpy(), x, atol=2e-3)
    np.testing.assert_allclose(by.numpy(), y, atol=2e-3)


# ---- imarith ------------------------------------------------------------

@pytest.mark.parametrize("op", ["ADD", "sub", "MUL", "div"])
def test_imarith_matches_jax(op):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 65535, (16, 24)).astype(np.uint16)
    other = rng.uniform(0.5, 3.0, (16, 24)).astype(np.float32)
    for value_j, value_t in ((2.5, 2.5), (jnp.asarray(other), _t(other))):
        want = np.asarray(jari.imarith(jnp.asarray(img), op, value_j))
        got = tari.imarith(_t(img), op, value_t)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)
    assert tari.ALLOWED_OPS == jari.ALLOWED_OPS


def test_imarith_rejects_unknown_op():
    with pytest.raises(ValueError, match="operation must be one of"):
        tari.imarith(torch.zeros((2, 2)), "POW", 2.0)


# ---- photometry ---------------------------------------------------------

def test_aperture_radii_match_jax():
    for fwhm, mult in ((3.2, 2.0), (2.0, 2.0), (4.1, 1.5)):
        assert tphot.aperture_radii(fwhm, mult) == \
            jphot.aperture_radii(fwhm, mult)


def test_exact_cover_matches_jax():
    """The closed-form disk / pixel overlap; its sum over a grid that
    holds the whole disk is pi r^2."""
    d = np.arange(-9, 10, dtype=np.float32)
    dx = (d[None, :] + 0.3) * np.ones((19, 1), np.float32)
    dy = (d[:, None] - 0.2) * np.ones((1, 19), np.float32)
    for r in (3, 7):
        want = np.asarray(jphot._exact_cover(jnp.asarray(dx),
                                             jnp.asarray(dy), r))
        got = tphot._exact_cover(_t(dx), _t(dy), r).numpy()
        # differences of float32 terms as large as r^2 asin(1) = 77:
        # a few units of 77 * 2^-24 = 5e-6
        np.testing.assert_allclose(got, want, atol=5e-5)
        assert got.sum() == pytest.approx(np.pi * r * r, rel=1e-4)


@pytest.mark.parametrize("edge_method", ["exact", "ramp"])
def test_aperture_photometry_matches_jax(edge_method):
    """All stars at once, stars at the border (clamped cutouts) and an
    invalid slot; sums of ~300 float32 products: 1e-5 relative."""
    img, xs, ys, amps = _starfield(0)
    valid = np.ones(xs.shape, bool)
    valid[5] = False
    r_ap, r_out = tphot.aperture_radii(FWHM)
    want = jphot.aperture_photometry(
        jnp.asarray(img), jnp.asarray(xs), jnp.asarray(ys),
        jnp.asarray(valid), r_ap, r_out, exposure=30.0,
        edge_method=edge_method)
    got = tphot.aperture_photometry(_t(img), _t(xs), _t(ys), _t(valid), r_ap,
                                    r_out, exposure=30.0,
                                    edge_method=edge_method)
    assert isinstance(got, tphot.Photometry)
    assert got._fields == want._fields
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.bgmed_per_pix.numpy(),
                                  np.asarray(want.bgmed_per_pix))
    for name in ("aperture_sum", "adu_per_sec"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=0.05)
    np.testing.assert_allclose(got.magnitude.numpy(),
                               np.asarray(want.magnitude), atol=1e-5)
    # the truth: flux = 2 pi sigma^2 amp for the stars inside the frame
    sig = FWHM / 2.35482
    inner = valid.copy()
    inner[:2] = False
    np.testing.assert_allclose(got.aperture_sum.numpy()[inner],
                               2 * np.pi * sig ** 2 * amps[inner], rtol=0.03)


# ---- psf ----------------------------------------------------------------

def test_extract_cutouts_matches_jax():
    img, xs, ys, _ = _starfield(0)
    want = jpsf.extract_cutouts(jnp.asarray(img), jnp.asarray(xs),
                                jnp.asarray(ys), 16)
    got = tpsf.extract_cutouts(_t(img), _t(xs), _t(ys), 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (xs.size, 16, 16)
    assert int(got[1][0]) == 0 and int(got[2][1]) == H - 16      # clamped


def test_gauss2d_jacobian_is_the_derivative():
    """The hand-written Jacobian against forward-mode autodiff of the
    model, also below the sigma clamp (derivative zero there)."""
    rng = np.random.default_rng(4)
    p = np.array([[900.0, 7.3, 8.1, 1.4, 2.0, 0.3, 100.0],
                  [50.0, 6.0, 9.5, 0.2, 1.1, -0.7, 10.0],
                  [300.0, 8.0, 8.0, 2.5, 0.25, 1.2, 0.0]], np.float32)
    cut = rng.uniform(50, 900, (3, 16, 16)).astype(np.float32)
    w = 1.0 / np.sqrt(np.maximum(cut, 1.0))
    ax = torch.arange(16, dtype=torch.float32)
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    r, jac = tpsf._residuals_jacobian(_t(p), _t(cut), _t(w), xx, yy)

    def res(params, c, wt):
        return ((c - tpsf._gauss2d(params[None], xx, yy)[0]) * wt).reshape(-1)

    for k in range(3):
        auto = torch.func.jacfwd(res)(_t(p[k]), _t(cut[k]), _t(w[k]))
        np.testing.assert_allclose(jac[k].numpy(), auto.numpy(), rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(
            r[k].numpy(), res(_t(p[k]), _t(cut[k]), _t(w[k])).numpy(),
            rtol=1e-6, atol=1e-6)
    assert (jac[1, :, 3] == 0).all() and (jac[2, :, 4] == 0).all()
    # the model itself against the JAX one
    want = np.stack([np.asarray(jpsf._gauss2d(jnp.asarray(p[k]),
                                              jnp.asarray(xx.numpy()),
                                              jnp.asarray(yy.numpy())))
                     for k in range(3)])
    np.testing.assert_allclose(tpsf._gauss2d(_t(p), xx, yy).numpy(), want,
                               rtol=2e-5, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _fits():
    img, xs, ys, _ = _starfield(0)
    valid = np.ones(xs.shape, bool)
    valid[7] = False
    want = jpsf.measure_fwhm(jnp.asarray(img), jnp.asarray(xs),
                             jnp.asarray(ys), jnp.asarray(valid),
                             init_fwhm=3.0, box=16)
    got = tpsf.measure_fwhm(_t(img), _t(xs), _t(ys), _t(valid),
                            init_fwhm=3.0, box=16)
    return got, want


def test_fit_gaussian2d_matches_jax():
    """40 accept / reject LM steps in float32 with another summation
    order than XLA's: on the stars inside the frame the fitted values
    agree to 1e-3 relative (positions 1e-3 px), ``valid`` and
    ``circular`` exactly, the errors and chi^2 to 1 %.  The planted FWHM
    is recovered to 0.1 px, as tests/test_psf.py asks of the JAX fit."""
    got, want = _fits()
    assert isinstance(got, tpsf.PSFFits) and got._fields == want._fields
    assert tpsf.FWHM_PER_SIGMA == jpsf.FWHM_PER_SIGMA
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    inner = np.asarray(want.valid).copy()
    inner[:2] = False                       # the two border stars
    assert inner.sum() >= 10
    for name in ("amplitude", "fwhm_x", "fwhm_y", "background"):
        np.testing.assert_allclose(getattr(got, name).numpy()[inner],
                                   np.asarray(getattr(want, name))[inner],
                                   rtol=1e-3, err_msg=name)
    for name in ("x0", "y0"):
        np.testing.assert_allclose(getattr(got, name).numpy()[inner],
                                   np.asarray(getattr(want, name))[inner],
                                   atol=1e-3, err_msg=name)
    for name in ("chi2_red", "fwhm_x_err", "fwhm_y_err", "axial_ratio"):
        np.testing.assert_allclose(getattr(got, name).numpy()[inner],
                                   np.asarray(getattr(want, name))[inner],
                                   rtol=1e-2, err_msg=name)
    np.testing.assert_array_equal(got.circular.numpy()[inner],
                                  np.asarray(want.circular)[inner])
    np.testing.assert_allclose(got.fwhm_x.numpy()[inner], FWHM, atol=0.1)
    np.testing.assert_allclose(got.fwhm_y.numpy()[inner], FWHM, atol=0.1)


def test_fit_gaussian2d_survives_singular_systems():
    """An all-zero cutout and a NaN one give a singular or non-finite
    normal system: the fit carries on, as ``jnp.linalg.solve`` lets the
    JAX one, and only ``valid`` tells."""
    img, xs, ys, _ = _starfield(0)
    cuts, ix, iy = tpsf.extract_cutouts(_t(img), _t(xs[:4]), _t(ys[:4]), 16)
    cuts = cuts.clone()
    cuts[1] = 0.0
    cuts[2] = float("nan")
    ok = torch.ones(4, dtype=torch.bool)
    got = tpsf.fit_gaussian2d(cuts, ok, ix, iy)
    want = jpsf.fit_gaussian2d(jnp.asarray(cuts.numpy()),
                               jnp.asarray(ok.numpy()),
                               jnp.asarray(ix.numpy()),
                               jnp.asarray(iy.numpy()))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.valid.tolist() == [True, False, False, True]
    np.testing.assert_allclose(got.fwhm_x.numpy()[3],
                               np.asarray(want.fwhm_x)[3], rtol=1e-3)


def test_median_fwhm_matches_jax():
    got, want = _fits()
    # the same table through both: the port's own fits differ by 1e-3
    as_t = tpsf.PSFFits(*(_t(np.asarray(f)) for f in want))
    for (gm, gs), (wm, ws) in zip(tpsf.median_fwhm(as_t),
                                  jpsf.median_fwhm(want)):
        np.testing.assert_allclose(gm.numpy(), np.asarray(wm), rtol=1e-6)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-5,
                                   atol=1e-7)
    (mfx, _), (mfy, _) = tpsf.median_fwhm(got)
    assert float(mfx) == pytest.approx(FWHM, abs=0.1)
    assert float(mfy) == pytest.approx(FWHM, abs=0.1)


def test_nearest_neighbor_and_isolation_match_jax():
    x = np.array([10.0, 13.0, 50.0, 90.0, 91.0], np.float32)
    y = np.array([10.0, 14.0, 50.0, 90.0, 90.0], np.float32)
    for valid in (np.ones(5, bool), np.array([1, 0, 1, 1, 0], bool),
                  np.array([0, 0, 1, 0, 0], bool)):
        want = np.asarray(jpsf.nearest_neighbor_dist(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid)))
        got = tpsf.nearest_neighbor_dist(_t(x), _t(y), _t(valid)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_array_equal(
            tpsf.isolated_mask(_t(x), _t(y), _t(valid), 16.0).numpy(),
            np.asarray(jpsf.isolated_mask(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(valid), 16.0)))


# ---- background -----------------------------------------------------------

def test_spline_zoom_matrix_equals_jax_module():
    for n_in, n_out in ((6, 96), (8, 128), (1, 7), (16, 16)):
        a = tbg._spline_zoom_matrix(n_in, n_out)
        b = jbg._spline_zoom_matrix(n_in, n_out)
        assert a.dtype == np.float64 and a.tobytes() == b.tobytes()


def _sky_image(seed=5):
    img, _xs, _ys, _ = _starfield(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    return (img + 0.4 * xx + 0.25 * yy).astype(np.float32)


@pytest.mark.parametrize("nsigma,npixels,dilate", [(3.0, 5, 11), (2.0, 3, 5)])
def test_source_mask_matches_jax(nsigma, npixels, dilate):
    img = _sky_image()
    want = np.asarray(jbg.source_mask(jnp.asarray(img), nsigma=nsigma,
                                      npixels=npixels, dilate=dilate))
    got = tbg.source_mask(_t(img), nsigma=nsigma, npixels=npixels,
                          dilate=dilate)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.02 < want.mean() < 0.9


@pytest.mark.parametrize("upsample", ["bilinear", "spline"])
@pytest.mark.parametrize("masked", [False, True])
def test_background2d_matches_jax(upsample, masked):
    """Box medians are order statistics of the same float32 values; the
    upsampling sums a few float32 products: 1e-5 relative.  With the
    mask, boxes under the exclude percentile take the global fill."""
    img = _sky_image()
    mask = None
    if masked:
        mask = np.asarray(jbg.source_mask(jnp.asarray(img), dilate=5)).copy()
        mask[0:24, 0:32] = True               # two boxes wholly excluded
    kw = dict(nboxes_y=4, nboxes_x=8, upsample=upsample)
    want = np.asarray(jbg.background2d(
        jnp.asarray(img), None if mask is None else jnp.asarray(mask), **kw))
    got = tbg.background2d(_t(img), None if mask is None else _t(mask), **kw)
    assert got.shape == (H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    with pytest.raises(ValueError, match="not divisible"):
        tbg.background2d(_t(img), nboxes_y=5, nboxes_x=8)
    with pytest.raises(ValueError, match="unknown upsample"):
        tbg.background2d(_t(img), upsample="cubic")


# ---- cosmic ---------------------------------------------------------------

def _cr_image(seed=6):
    img, xs, ys, _ = _starfield(seed, sky=300.0)
    rng = np.random.default_rng(seed)
    img = img.copy()
    hits = np.zeros((H, W), bool)
    cy = rng.integers(4, H - 4, 25)
    cx = rng.integers(4, W - 4, 25)
    hits[cy, cx] = True
    hits[50, 60:63] = True                         # a short track
    img[hits] += rng.uniform(1500, 8000, hits.sum()).astype(np.float32)
    img[20:26, 30:36] = 70000.0                    # a saturated core
    return img, hits


def test_cosmic_filters_match_jax():
    img, _ = _cr_image()
    for size in (3, 5, 7):
        np.testing.assert_array_equal(
            tcos._median_filter(_t(img), size).numpy(),
            np.asarray(jcos._median_filter(jnp.asarray(img), size)))
    good = img < 1500
    want = np.asarray(jcos._masked_median_filter(jnp.asarray(img),
                                                 jnp.asarray(good), 5))
    got = tcos._masked_median_filter(_t(img), _t(good), 5).numpy()
    np.testing.assert_array_equal(got, want)          # NaN where none good
    assert np.isnan(want).any()
    np.testing.assert_allclose(
        tcos._laplacian_subsampled(_t(img)).numpy(),
        np.asarray(jcos._laplacian_subsampled(jnp.asarray(img))),
        rtol=1e-6, atol=1e-3)
    np.testing.assert_array_equal(tcos._gaussian_psf_kernel(3.5, 7),
                                  jcos._gaussian_psf_kernel(3.5, 7))
    k = tcos._gaussian_psf_kernel(3.5, 7)
    np.testing.assert_allclose(
        tcos._conv_static(_t(img), k).numpy(),
        np.asarray(jcos._conv_static(jnp.asarray(img), k)), rtol=1e-5)
    np.testing.assert_array_equal(
        tcos._dilate3(_t(good)).numpy(),
        np.asarray(jcos._dilate3(jnp.asarray(good))))


@pytest.mark.parametrize("fsmode", ["convolve", "median"])
def test_lacosmic_matches_jax(fsmode):
    """The same hits flagged and the same pixels cleaned.  The detection
    statistic is a ratio of float32 stencil sums, so a pixel that sits on
    a threshold may flip: at most 2 pixels of the mask may differ, and
    the cleaned image agrees to 1e-4 relative elsewhere."""
    img, hits = _cr_image()
    kw = dict(gain=1.5, readnoise=8.0, satlevel_e=65535.0 * 1.5, niter=3,
              fsmode=fsmode)
    want, want_m = jcos.lacosmic(jnp.asarray(img), **kw)
    got, got_m = tcos.lacosmic(_t(img), **kw)
    want, want_m = np.asarray(want), np.asarray(want_m)
    assert got_m.dtype == torch.bool
    differ = got_m.numpy() != want_m
    assert differ.sum() <= 2
    near = tcos._dilate3(tcos._dilate3(_t(differ))).numpy()
    np.testing.assert_allclose(got.numpy()[~near], want[~near], rtol=1e-4)
    assert got_m.numpy()[hits].mean() >= 0.9
    assert not got_m.numpy()[20:26, 30:36].any()       # the saturated core
    with pytest.raises(ValueError, match="fsmode"):
        tcos.lacosmic(_t(img), fsmode="mean")


# ---- composite ------------------------------------------------------------

def _channels(seed=7):
    rng = np.random.default_rng(seed)
    base, _, _, _ = _starfield(seed)
    return np.stack([base * s + rng.normal(0, 3, base.shape)
                     for s in (1.0, 0.7, 1.3)]).astype(np.float32)


def test_percentile_matches_jnp():
    """The sort-based percentile against numpy's (1e-6: one float32
    interpolation) and against ``jnp.percentile``, which computes the
    position in float32 (off by ~1e-3 of an index at 12288 values, times
    a steep tail: 3e-5 relative)."""
    ch = _channels().reshape(3, -1)
    for pct in (0.0, 0.5, 37.3, 50.0, 99.8, 100.0):
        got = tcomp._percentile(_t(ch), pct).numpy()
        np.testing.assert_allclose(
            got, np.percentile(ch.astype(np.float64), pct, axis=1), rtol=1e-6)
        want = np.asarray(jnp.percentile(jnp.asarray(ch), pct, axis=1))
        np.testing.assert_allclose(got, want, rtol=3e-5)
    bad = ch.copy()
    bad[1, 5] = np.nan
    assert np.isnan(tcomp._percentile(_t(bad), 50.0).numpy()).tolist() == \
        [False, True, False]


@pytest.mark.parametrize("mode", ["asinh", "gamma", "linear"])
def test_stretch_channels_matches_jax(mode):
    ch = _channels()
    want = np.asarray(jcomp.stretch_channels(jnp.asarray(ch), mode=mode))
    got = tcomp.stretch_channels(_t(ch), mode=mode)
    assert got.shape == (H, W, 3)
    # the white point differs by up to 3e-5 relative (see the percentile
    # test), asinh / pow in float32 add 1e-6: 5e-5 on values in [0, 1]
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    assert 0.0 <= got.min() and got.max() <= 1.0


def test_stretch_channels_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown stretch mode"):
        tcomp.stretch_channels(_t(_channels()), mode="log")


@pytest.mark.parametrize("bits", [8, 16])
def test_compose_rgb_matches_jax(bits):
    """Within one count: a value that lands on x.5 may round either way."""
    r, g, b = _channels()
    want = jcomp.compose_rgb(r, g, b, bits=bits)
    for args in ((r, g, b), (_t(r), _t(g), _t(b))):
        got = tcomp.compose_rgb(*args, bits=bits, device="cpu")
        assert got.dtype == want.dtype and got.shape == (H, W, 3)
        assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def test_ops_exports_follow_the_jax_package():
    """The port's ``ops`` package exports exactly the names of the JAX
    package's."""
    import astrophotography_tpu.ops as jops

    assert sorted(tops.__all__) == sorted(jops.__all__)
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
