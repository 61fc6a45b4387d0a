"""Port parity: K2's ``v_bounds`` and ``snap_geom`` inputs against the
JAX package's Pallas kernel (interpret mode on the CPU backend), and the
row-banded warp+combine (``parallel/fused.banded_warp_combine``) against
the port's whole-frame ``warp_combine``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu.ops import pallas_warp_combine as pwc
from astrophotography_tpu_torch.ops import warp_combine as twc
from astrophotography_tpu_torch.parallel import banded_warp_combine
from tests.test_torch_warp_combine import (_capture_jax_prep, _compare,
                                           _scene)

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

#: (v_bounds, snap_geom): bounds inside the image, and a snap geometry
#: whose half-extents (5, 4) let the 0.002-0.004 rad rotations of the
#: scene snap (0.004 * 5 < 0.05), which the frame's own (63.5, 31.5)
#: would not, with the translation taken off-centre
NARROW = ((9.0, 49.5), (40.0, 20.0, 5.0, 4.0))
#: bounds beyond the image (an interior band's) and a centre outside it
WIDE = ((-30.0, 200.0), (63.5, -40.0, 63.5, 120.0))


def _geom(case):
    vb, sg = case
    return np.asarray(vb, np.float32), np.asarray(sg, np.float32)


@pytest.mark.parametrize("case", [NARROW, WIDE])
def test_plan_with_bounds_and_geom_matches_jax_exactly(monkeypatch, case):
    """The per-frame table (snapped matrices, flags, row bounds) and the
    window origins, bit for bit, from the JAX host prep."""
    _cal, raw, masters, mats, er, fs = _scene(5, 64, 128, seed=7)
    vb, sg = _geom(case)
    seen = _capture_jax_prep(
        monkeypatch, raw, mats, masters=jnp.asarray(masters),
        exp_ratios=jnp.asarray(er), flux_scales=jnp.asarray(fs),
        tile=(32, 64), v_bounds=jnp.asarray(vb), snap_geom=jnp.asarray(sg))
    plan = twc.plan_warp_combine(
        (5, 64, 128), torch.from_numpy(mats), torch.from_numpy(er),
        torch.from_numpy(fs), tile=(32, 64), v_bounds=torch.from_numpy(vb),
        snap_geom=torch.from_numpy(sg))
    np.testing.assert_array_equal(plan.table[:, :11].numpy(), seen["mats"])
    np.testing.assert_array_equal(plan.byp.numpy(), seen["byp"])
    np.testing.assert_array_equal(plan.bxp.numpy(), seen["bxp"])
    assert (plan.table[:, 9].numpy() == vb[0]).all()
    assert (plan.table[:, 10].numpy() == vb[1]).all()
    default = twc.plan_warp_combine((5, 64, 128), torch.from_numpy(mats),
                                    tile=(32, 64))
    assert (default.table[:, 9] == 2.0).all()
    assert (default.table[:, 10] == 60.0).all()
    if case is NARROW:
        # the small half-extents snap every frame; the frame's own do not
        assert plan.table[:, 8].sum() == 5 and default.table[:, 8].sum() == 2


@pytest.mark.parametrize("case,taps,source", [
    (NARROW, "exact", "calibrated"),
    (WIDE, "lowrank", "raw_masters"),
    (((12.0, 45.0), (63.5, 31.5, 63.5, 31.5)), "exact", "raw_masters"),
])
def test_warp_combine_with_bounds_and_geom_matches_pallas(case, taps, source):
    """Values and coverage with both inputs set, at
    tests/test_torch_warp_combine.py's tolerance (``_compare``).  Every
    frame is shifted down >= 4 px so the top tiles' taps stay inside the
    image (interpret mode reads unassembled window rows as NaN).  The
    seed keeps the 8192 pixels free of a clip tie (``_compare`` allows
    1e-4 of them, less than one pixel here; seeds 13 and 14 have one,
    with and without the two inputs)."""
    cal, raw, masters, mats, er, fs = _scene(5, 64, 128, seed=15,
                                             ty_range=(4.0, 6.0))
    vb, sg = _geom(case)
    if source == "calibrated":
        jargs, targs, jkw, tkw = (jnp.asarray(cal),), \
            (torch.from_numpy(cal),), {}, {}
    else:
        jargs, targs = (jnp.asarray(raw),), (torch.from_numpy(raw),)
        jkw = dict(masters=jnp.asarray(masters), exp_ratios=jnp.asarray(er),
                   flux_scales=jnp.asarray(fs))
        tkw = dict(masters=torch.from_numpy(masters),
                   exp_ratios=torch.from_numpy(er),
                   flux_scales=torch.from_numpy(fs))
    ref = np.asarray(pwc.pallas_warp_combine(
        *jargs, jnp.asarray(mats), tile=(32, 64), general_taps=taps,
        v_bounds=jnp.asarray(vb), snap_geom=jnp.asarray(sg), **jkw))
    kw = dict(tile=(32, 64), general_taps=taps, v_bounds=torch.from_numpy(vb),
              snap_geom=torch.from_numpy(sg), **tkw)
    got = twc.warp_combine(*targs, torch.from_numpy(mats), **kw)
    _compare(got.numpy(), ref)
    assert (got != 0).float().mean() > 0.4
    if vb[0] > 2.0:
        # the bounds cut rows the default keeps
        full = twc.warp_combine(*targs, torch.from_numpy(mats),
                                **{**kw, "v_bounds": None})
        assert (full != 0).sum() > (got != 0).sum()
    # the plain twin takes the same arguments
    plain = twc.warp_combine_plain(*targs, torch.from_numpy(mats), **kw)
    assert torch.equal(plain, got)


def test_bounds_and_geom_shapes_are_checked():
    cal, _raw, _m, mats, _er, _fs = _scene(3, 64, 128, seed=1)
    c, m = torch.from_numpy(cal), torch.from_numpy(mats)
    with pytest.raises(ValueError, match="v_bounds must have shape"):
        twc.warp_combine(c, m, tile=(32, 64), v_bounds=torch.zeros(3))
    with pytest.raises(ValueError, match="snap_geom must have shape"):
        twc.warp_combine(c, m, tile=(32, 64), snap_geom=torch.zeros(2))


# ---- the band loop -------------------------------------------------------

def _stack(n, h, w, seed, theta_max=0.0):
    """Frames of one smooth scene with blocky structure and per-frame
    offsets; translations are multiples of 1/64 px (exact in float32
    next to the row offsets the bands add), rotations about the centre."""
    rng = np.random.default_rng(seed)
    yy = np.linspace(0, 30, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 20, w, dtype=np.float32)[None, :]
    small = rng.normal(0, 5, (h // 16, w // 16)).astype(np.float32)
    base = 800.0 + yy + xx + np.kron(small, np.ones((16, 16), np.float32))
    frames = np.stack([base + float(i)
                       + rng.normal(0, 2, (h, w)).astype(np.float32)
                       for i in range(n)])
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    mats = []
    for f in range(n):
        theta = 0.0 if f == 0 or theta_max == 0.0 else float(
            rng.choice([-1.0, 1.0]) * rng.uniform(0.5, 1.0) * theta_max)
        tx, ty = (0.0, 0.0) if f == 0 else \
            np.round(rng.uniform(-3, 3, 2) * 64) / 64
        c, s = np.cos(theta), np.sin(theta)
        mats.append([[c, -s, tx + cx - c * cx + s * cy],
                     [s, c, ty + cy - s * cx - c * cy]])
    return frames.astype(np.float32), np.asarray(mats, np.float32)


def _clip_tie_rule(got, ref):
    """tests/test_parallel_fused.py's rule: equal zero masks, median
    |diff| < 1e-3, and beyond 0.5 + 1e-4 |ref| (a sample at a clip bound
    kept in one arithmetic order only) on under 1e-4 of the pixels."""
    got, ref = got.numpy(), ref.numpy()
    np.testing.assert_array_equal(got == 0, ref == 0)
    both = (got != 0) & (ref != 0)
    assert both.mean() > 0.85
    err = np.abs(got[both] - ref[both])
    assert np.median(err) < 1e-3
    assert (err > 0.5 + 1e-4 * np.abs(ref[both])).mean() < 1e-4


@pytest.mark.parametrize("n_bands", [2, 4])
@pytest.mark.parametrize("source", ["calibrated", "raw_masters"])
def test_banded_translations_are_bit_identical(n_bands, source):
    """Pure translations: every band snaps to the whole image's
    translation and keeps the whole image's row coverage, so the stitched
    bands equal the whole frame bit for bit, edge rows included."""
    frames, mats = _stack(4, 256, 128, seed=3)
    kw = dict(tile=(32, 64), span=8)
    if source == "raw_masters":
        rng = np.random.default_rng(9)
        flat = (1.0 + 0.05 * np.cos(np.arange(128) * 0.05)[None, :]
                * np.ones((256, 1))).astype(np.float32)
        bias = (300.0 + rng.normal(0, 2, (256, 128))).astype(np.float32)
        er = np.array([1.0, 0.5, 2.0, 1.5], np.float32)
        dark = np.abs(rng.normal(20, 3, (256, 128))).astype(np.float32)
        frames = np.clip(np.rint(frames * flat + bias
                                 + er[:, None, None] * dark), 0, 65535) \
            .astype(np.uint16)
        kw.update(masters=torch.from_numpy(np.stack(
            [1.0 / flat, bias / flat, dark / flat]).astype(np.float32)),
            exp_ratios=torch.from_numpy(er))
    f, m = torch.from_numpy(frames), torch.from_numpy(mats)
    whole = twc.warp_combine(f, m, **kw)
    banded = banded_warp_combine(f, m, n_bands, halo=32, **kw)
    assert banded.shape == whole.shape == (256, 128)
    assert torch.equal(banded, whole)
    assert (whole[:8] == 0).any() and (whole != 0).float().mean() > 0.9


@pytest.mark.parametrize("taps", ["exact", "lowrank"])
@pytest.mark.parametrize("n_bands", [2, 4])
def test_banded_rotations_follow_the_clip_tie_rule(taps, n_bands):
    """Rotations above the snap tolerance (0.003 rad * 127.5 px = 0.4 px
    at the corners): the per-band matrices carry the rotation terms and
    every band takes the general tap path."""
    frames, mats = _stack(4, 256, 128, seed=23, theta_max=0.003)
    f, m = torch.from_numpy(frames), torch.from_numpy(mats)
    kw = dict(tile=(32, 64), general_taps=taps)
    plan = twc.plan_warp_combine(frames.shape, m, **kw)
    assert plan.table[:, 8].sum() == 1          # only frame 0 snaps
    whole = twc.warp_combine(f, m, **kw)
    banded = banded_warp_combine(f, m, n_bands, halo=32, **kw)
    _clip_tie_rule(banded, whole)


def test_banded_one_band_is_the_whole_frame():
    frames, mats = _stack(3, 128, 128, seed=5, theta_max=0.002)
    f, m = torch.from_numpy(frames), torch.from_numpy(mats)
    whole = twc.warp_combine(f, m, tile=(32, 64))
    _clip_tie_rule(banded_warp_combine(f, m, 1, halo=32, tile=(32, 64)),
                   whole)


def test_banded_rejects_bad_geometry():
    frames, mats = _stack(2, 256, 128, seed=1)
    f, m = torch.from_numpy(frames), torch.from_numpy(mats)
    with pytest.raises(ValueError, match="halo must be smaller"):
        banded_warp_combine(f, m, 4, halo=64, tile=(32, 64))
    with pytest.raises(ValueError, match="not divisible by n_bands"):
        banded_warp_combine(f, m, 3, halo=16, tile=(32, 64))
