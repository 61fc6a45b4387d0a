"""Port parity: RAW conversion (``ops/demosaic.py``), each of the ten
public functions against the JAX package on the same numpy mosaics, for
all four Bayer phases, with and without black subtraction.

Tolerances: ``rtol=1e-5, atol=0.05`` (the JAX suite's own bound for its
goldens).  Two rules are looser, each stated where it is used: AHD's
homogeneity tests can flip on another rounding of one product (the
clip-tie rule below), and ``percentile_renorm`` takes its percentile
position in float64 where jnp takes it in float32 (3e-5 relative).
"""

import os

import numpy as np
import pytest
import torch

from astrophotography_tpu import synth
from astrophotography_tpu.ops import demosaic as jdk
from astrophotography_tpu_torch import ops as tops
from astrophotography_tpu_torch.ops import demosaic as tdk

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores
torch.set_num_threads(1)

H, W = 64, 96
RTOL, ATOL = 1e-5, 0.05
#: largest share of AHD pixels allowed to take another of their three
#: candidate values than the JAX function's (measured here: 0)
AHD_FLIP_SHARE = 2e-3

PATTERNS = {
    "RGGB": np.array([[0, 1], [3, 2]], np.uint8),
    "BGGR": np.array([[2, 1], [3, 0]], np.uint8),
    "GRBG": np.array([[1, 0], [2, 3]], np.uint8),
    "GBRG": np.array([[1, 2], [0, 3]], np.uint8),
}
BLACKS = np.array([512.0, 500.0, 520.0, 508.0], np.float32)
WB = np.array([2.0, 1.0, 1.5, 1.0], np.float32)
WHITE = 16383.0

phases = pytest.mark.parametrize("phase", sorted(PATTERNS))
black_on_off = pytest.mark.parametrize("subtract_black", [True, False])


def _t(x):
    return torch.from_numpy(np.array(x))


def _mosaic(phase, seed=3):
    """A uint16 mosaic of a smooth scene plus noise (so that AHD has real
    edges to choose on) and its colour map."""
    scene = synth.make_rgb_scene((H, W), seed=seed, peak=9000)
    cmap = synth.bayer_color_map((H, W), PATTERNS[phase])
    rng = np.random.default_rng(seed)
    planes = np.stack([scene[..., 0], scene[..., 1], scene[..., 2],
                       scene[..., 1]])
    sites = np.take_along_axis(planes, cmap[None].astype(np.int64), 0)[0]
    sites = sites + rng.normal(0, 20, (H, W)) + BLACKS[cmap]
    return np.clip(sites, 0, WHITE).astype(np.uint16), cmap


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _assert_ahd_tie_rule(got, want, cand_h, cand_v):
    """``got`` equals ``want`` within the tolerance on all but a small
    share of pixels, and at each differing pixel it is one of the three
    values the function could have chosen there."""
    got, want = np.asarray(got), np.asarray(want)
    bad = (np.abs(got - want) > RTOL * np.abs(want) + ATOL).any(axis=-1)
    share = bad.mean()
    assert share <= AHD_FLIP_SHARE, share
    if bad.any():
        cand_h, cand_v = np.asarray(cand_h), np.asarray(cand_v)
        options = np.stack([cand_h, cand_v, 0.5 * (cand_h + cand_v)])
        err = np.abs(options[:, bad] - got[bad][None]).max(axis=-1)
        tol = RTOL * np.abs(got[bad]).max(axis=-1) + ATOL
        assert (err.min(axis=0) <= tol).all()
    return share


@phases
def test_demosaic_bilinear_matches_jax(phase):
    mosaic, cmap = _mosaic(phase)
    want = jdk.demosaic_bilinear(mosaic.astype(np.float32), cmap)
    got = tdk.demosaic_bilinear(_t(mosaic), _t(cmap))
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    _close(got, want)


@phases
def test_demosaic_mhc_matches_jax(phase):
    mosaic, cmap = _mosaic(phase)
    want = jdk.demosaic_mhc(mosaic.astype(np.float32), cmap)
    got = tdk.demosaic_mhc(_t(mosaic), _t(cmap))
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    _close(got, want)


@phases
def test_demosaic_ahd_matches_jax_by_the_tie_rule(phase):
    mosaic, cmap = _mosaic(phase)
    want = jdk.demosaic_ahd(mosaic.astype(np.float32), cmap)
    got = tdk.demosaic_ahd(_t(mosaic), _t(cmap))
    assert got.dtype == torch.float32 and got.shape == (H, W, 3)
    cand_h, cand_v = tdk._ahd_candidates(_t(mosaic), _t(cmap))
    _assert_ahd_tie_rule(got, want, cand_h, cand_v)


def test_ahd_tie_rule_rejects_a_value_outside_the_candidates():
    """The rule itself: a flipped pixel passes, a foreign value fails."""
    mosaic, cmap = _mosaic("RGGB")
    got = tdk.demosaic_ahd(_t(mosaic), _t(cmap)).numpy()
    cand_h, cand_v = (c.numpy() for c in
                      tdk._ahd_candidates(_t(mosaic), _t(cmap)))
    y, x = np.argwhere(np.abs(cand_h - cand_v).max(axis=-1) > 5.0)[0]
    flipped = got.copy()
    flipped[y, x] = cand_v[y, x] if np.allclose(got[y, x], cand_h[y, x]) \
        else cand_h[y, x]
    assert _assert_ahd_tie_rule(flipped, got, cand_h, cand_v) > 0
    foreign = got.copy()
    foreign[y, x] += 7.0
    with pytest.raises(AssertionError):
        _assert_ahd_tie_rule(foreign, got, cand_h, cand_v)


@phases
@black_on_off
def test_safe_subtract_and_direct_grey_match_jax(phase, subtract_black):
    mosaic, cmap = _mosaic(phase)
    want = jdk.safe_subtract_black(mosaic, cmap, BLACKS)
    got = tdk.safe_subtract_black(_t(mosaic), _t(cmap), _t(BLACKS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jdk.raw_to_grey_direct(mosaic, cmap, BLACKS, WB,
                                  subtract_black=subtract_black)
    got = tdk.raw_to_grey_direct(_t(mosaic), _t(cmap), _t(BLACKS), _t(WB),
                                 subtract_black=subtract_black)
    _close(got, want)


@phases
@black_on_off
def test_raw_to_rgb_and_grey_linear_match_jax(phase, subtract_black):
    mosaic, cmap = _mosaic(phase)
    args = (mosaic, cmap, BLACKS, WB, WHITE)
    targs = (_t(mosaic), _t(cmap), _t(BLACKS), _t(WB), WHITE)
    want = jdk.raw_to_rgb(*args, subtract_black=subtract_black)
    got = tdk.raw_to_rgb(*targs, subtract_black=subtract_black)
    _close(got, want, "raw_to_rgb mhc")
    want = jdk.raw_to_grey_linear(*args, subtract_black=subtract_black)
    got = tdk.raw_to_grey_linear(*targs, subtract_black=subtract_black)
    assert got.shape == (H, W)
    _close(got, want, "raw_to_grey_linear mhc")


@pytest.mark.parametrize("algorithm", ["bilinear", "ahd"])
def test_raw_to_rgb_other_algorithms_match_jax(algorithm):
    mosaic, cmap = _mosaic("GRBG")
    want = jdk.raw_to_rgb(mosaic, cmap, BLACKS, WB, WHITE,
                          algorithm=algorithm)
    got = tdk.raw_to_rgb(_t(mosaic), _t(cmap), _t(BLACKS), _t(WB), WHITE,
                         algorithm=algorithm)
    if algorithm == "ahd":
        sub = tdk.safe_subtract_black(_t(mosaic), _t(cmap), _t(BLACKS))
        scaled = sub * _t(WB)[_t(cmap).long()] \
            * (65535.0 / (WHITE - float(BLACKS.max())))
        _assert_ahd_tie_rule(got, want,
                             *tdk._ahd_candidates(scaled, _t(cmap)))
    else:
        _close(got, want)


def test_grey_linear_is_the_three_term_luma_of_rgb():
    """Exactly (0.299 R + 0.587 G) + 0.114 B of the clipped RGB: no
    matrix product, so the CPU and the card round alike."""
    mosaic, cmap = _mosaic("RGGB")
    targs = (_t(mosaic), _t(cmap), _t(BLACKS), _t(WB), WHITE)
    rgb = tdk.raw_to_rgb(*targs).clamp(0.0, 65535.0)
    want = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]) + 0.114 * rgb[..., 2]
    assert torch.equal(tdk.raw_to_grey_linear(*targs), want)


@phases
@black_on_off
def test_split_channels_matches_jax(phase, subtract_black):
    mosaic, cmap = _mosaic(phase)
    want = np.asarray(jdk.split_channels(mosaic, cmap, BLACKS,
                                         subtract_black))
    got = tdk.split_channels(_t(mosaic), _t(cmap), _t(BLACKS),
                             subtract_black).numpy()
    assert got.shape == (4, H, W)
    np.testing.assert_array_equal(got, want)
    for c in range(4):
        assert not got[c][cmap != c].any()


@phases
def test_wb_from_region_matches_jax(phase):
    mosaic, cmap = _mosaic(phase)
    sub = np.asarray(jdk.safe_subtract_black(mosaic, cmap, BLACKS))
    for region in ([0, H - 1, 0, W - 1], [5, 40, 11, 70]):
        want = jdk.wb_from_region(sub, cmap, np.asarray(region, np.int32))
        got = tdk.wb_from_region(_t(sub), _t(cmap), region)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        got_t = tdk.wb_from_region(_t(sub), _t(cmap), torch.tensor(region))
        assert torch.equal(got, got_t)


@pytest.mark.parametrize("shape", [(64, 96), (96, 128)])
def test_percentile_renorm_matches_jax(shape):
    """3e-5 of the output range: jnp.percentile takes the position
    pct / 100 * (M - 1) in float32, the port in float64 as numpy does; at
    the 0.01 / 99.99 % positions that moves the interpolation weight."""
    rng = np.random.default_rng(11)
    img = rng.gamma(2.0, 900.0, shape).astype(np.float32)
    want = np.asarray(jdk.percentile_renorm(img))
    got = tdk.percentile_renorm(_t(img)).numpy()
    assert np.abs(got - want).max() <= 3e-5 * 65535.0
    # against numpy's float64 percentiles the port is exact to rounding
    lo, hi = np.percentile(img.astype(np.float64), [0.01, 99.99])
    ref = (img - np.float32(lo)) * (65535.0 / np.float32(hi - lo))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0.05)


def test_port_matches_the_pinned_goldens():
    """The JAX suite's value-pinned goldens, at the JAX suite's tolerance
    (AHD by the tie rule)."""
    g = np.load(os.path.join(os.path.dirname(__file__), "data",
                             "demosaic_golden.npz"))
    vals = _t(g["mosaic"].astype(np.float32))
    cmap = _t(g["color_map"].astype(np.int32))
    _close(tdk.demosaic_bilinear(vals, cmap), g["bilinear"], "bilinear")
    _close(tdk.demosaic_mhc(vals, cmap), g["mhc"], "mhc")
    _assert_ahd_tie_rule(tdk.demosaic_ahd(vals, cmap), g["ahd"],
                         *tdk._ahd_candidates(vals, cmap))


def test_measured_sites_are_kept_exactly():
    mosaic, cmap = _mosaic("BGGR")
    v = mosaic.astype(np.float32)
    for fn in (tdk.demosaic_bilinear, tdk.demosaic_mhc, tdk.demosaic_ahd):
        rgb = fn(_t(mosaic), _t(cmap)).numpy()
        for color, chan in ((0, 0), (1, 1), (3, 1), (2, 2)):
            sites = cmap == color
            np.testing.assert_array_equal(rgb[..., chan][sites], v[sites])


def test_unknown_algorithm_raises():
    mosaic, cmap = _mosaic("RGGB")
    for fn in (tdk.raw_to_rgb, tdk.raw_to_grey_linear):
        with pytest.raises(ValueError, match="unknown demosaic algorithm"):
            fn(_t(mosaic), _t(cmap), _t(BLACKS), _t(WB), WHITE,
               algorithm="vng")


def test_ops_exports_the_ten_names():
    for name in ("demosaic_ahd", "demosaic_bilinear", "demosaic_mhc",
                 "raw_to_rgb", "raw_to_grey_linear", "raw_to_grey_direct",
                 "split_channels", "wb_from_region", "percentile_renorm",
                 "safe_subtract_black"):
        assert getattr(tops, name) is getattr(tdk, name)
        assert name in tops.__all__
