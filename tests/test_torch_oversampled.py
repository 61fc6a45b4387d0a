"""Port parity at wide filter footprints (an oversampled rig: stars of
8-23 px FWHM): K1 (``detect_tiles``) against the JAX package's
``pallas_detect_tiles`` (interpret mode on the CPU backend) at FWHM 8,
21 and 22.7 px (filter radii 6, 16 and 17), the lean pipeline at
``fwhm=8.0`` against JAX's, and chip_smoke.py's on-device workload
generator with stars of 8 px FWHM."""

import hashlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu import synth
from astrophotography_tpu.models import PipelineConfig as JaxConfig
from astrophotography_tpu.models.pipeline import (
    calibrate_register_stack_lean as jax_lean)
from astrophotography_tpu.ops import pallas_detect as jpd
from astrophotography_tpu_torch.models import (calibrate_register_stack_lean,
                                               from_jax_config)
from astrophotography_tpu_torch.ops import detect as tdetect
from astrophotography_tpu_torch.ops import detect_tiles as tdt

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

N, H, W = 2, 256, 512
THRESH = 60.0


def _stack(fwhm: float, seed: int):
    """Raw uint16 frames of stars of ``fwhm`` with bias, dark (exp ratio
    2) and a flat with row-to-row structure, as test_torch_detect's
    stack; the fluxes scale with fwhm^2, so the peak amplitudes are those
    of its 3 px stars."""
    rng = np.random.default_rng(seed)
    scale = (fwhm / 3.0) ** 2
    frames = np.stack([synth.make_starfield(
        (H, W), n_stars=12, fwhm=fwhm, background=500.0, read_noise=4.0,
        flux_range=(2000.0 * scale, 80000.0 * scale), seed=seed + f + 1,
        margin=24, min_sep=30.0)[0] for f in range(N)]).astype(np.float32)
    bias = (250.0 + rng.normal(0, 2.0, (H, W))).astype(np.float32)
    dark = np.abs(rng.normal(3.0, 1.0, (H, W))).astype(np.float32)
    flat = (1.0 + 0.1 * np.sin(np.arange(H) * 0.7)[:, None]
            + 0.05 * np.cos(np.arange(W) * 0.013)[None, :]).astype(np.float32)
    raw = np.clip(frames * flat + bias + 2.0 * dark, 0, 65535) \
        .astype(np.uint16)
    return raw, bias, dark, flat


@pytest.mark.parametrize("fwhm,r", [(8.0, 6), (21.0, 16), (22.7, 17)])
def test_detect_tiles_matches_pallas_wide(fwhm, r):
    """K1 at the ring route's radii 6 and 16 and the separable route's
    17, with every calibration plane, at the tolerances of
    test_torch_detect.test_detect_tiles_matches_pallas: maxima within
    2 % + 0.5 (the TPU kernel's lane pass is bf16), equal argmax on the
    strong tiles, equal empty tiles; the offsets within 0.02 bin per 3 px
    of FWHM (0.02 at FWHM 3 there): the flatter a wide density's peak,
    the more its parabola offsets magnify the bf16 pass's rounding (at
    FWHM 21 they move by 0.028 bin, 0.13 % of the FWHM)."""
    assert tdetect._kernel_radius(fwhm) == r
    raw, bias, dark, flat = _stack(fwhm, seed=3)
    thr = np.full((N,), THRESH, np.float32)
    er = np.full((N,), 2.0, np.float32)
    mf = np.array(jpd.master_densities(jnp.asarray(bias), jnp.asarray(dark),
                                       jnp.asarray(flat), fwhm=fwhm))
    a = (1.0 / flat).astype(np.float32)
    ref = jpd.pallas_detect_tiles(
        jnp.asarray(raw), jnp.asarray(thr), mf_bc=jnp.asarray(mf),
        a_plane=jnp.asarray(a), exp_ratios=jnp.asarray(er), fwhm=fwhm,
        band=64)
    got = tdt.detect_tiles(
        torch.from_numpy(raw), torch.from_numpy(thr),
        mf_bc=torch.from_numpy(mf), a_plane=torch.from_numpy(a),
        exp_ratios=torch.from_numpy(er), fwhm=fwhm)
    (rmax, ridx, ryo, rxo) = [np.asarray(x) for x in ref]
    (gmax, gidx, gyo, gxo) = [x.numpy() for x in got]
    assert gmax.shape == rmax.shape == (N, H // 64, W // 256)
    empty = rmax <= -1e37
    np.testing.assert_array_equal(gmax <= -1e37, empty)
    live = ~empty
    assert np.all(np.abs(gmax[live] - rmax[live])
                  <= 0.02 * np.abs(rmax[live]) + 0.5)
    np.testing.assert_array_equal(gidx[empty], 0)
    strong = rmax >= 10 * THRESH
    assert strong.sum() >= 8
    np.testing.assert_array_equal(gidx[strong], ridx[strong])
    np.testing.assert_allclose(gyo[strong], ryo[strong], atol=0.02 * fwhm / 3)
    np.testing.assert_allclose(gxo[strong], rxo[strong], atol=0.02 * fwhm / 3)
    np.testing.assert_array_equal(gyo[empty], 0.0)


LH, LW, LN = 256, 768, 4
LEAN = dict(max_stars=24, match_k=10, detect_fast=True, detect_bin_rows=True,
            detect_topk="tile", detect_mode="chunked", detect_chunk=2,
            detect_impl="fused", fused_tile=(32, 256), warp_span=8,
            fwhm=8.0)


def _oversampled_stack(seed=7):
    """4 frames of 12 isolated stars of 8 px FWHM (at least 48 px apart,
    30 px from the edges), dithered by up to 6 px and turned by up to
    0.01 rad, with bias, dark (exp ratio 2) and flat."""
    rng = np.random.default_rng(seed)
    xs, ys = [], []
    while len(xs) < 12:
        x, y = rng.uniform(30, LW - 30), rng.uniform(30, LH - 30)
        if all((x - a) ** 2 + (y - b) ** 2 >= 48 ** 2 for a, b in zip(xs, ys)):
            xs.append(x)
            ys.append(y)
    xs, ys = np.asarray(xs), np.asarray(ys)
    flux = rng.uniform(150000, 600000, len(xs))
    cx, cy = (LW - 1) / 2, (LH - 1) / 2
    frames, truth = [], []
    for i in range(LN):
        th = rng.uniform(-0.01, 0.01) if i else 0.0
        tx, ty = rng.uniform(-6, 6, 2) if i else (0.0, 0.0)
        c, s = np.cos(th), np.sin(th)
        sx = c * (xs - cx) - s * (ys - cy) + cx + tx
        sy = s * (xs - cx) + c * (ys - cy) + cy + ty
        img = np.full((LH, LW), 200.0)
        for x, y, f in zip(sx, sy, flux):
            img += synth.gaussian_star((LH, LW), x, y, f, 8.0)
        frames.append(img + rng.normal(0, 5.0, img.shape))
        truth.append((tx, ty))
    bias = (250.0 + rng.normal(0, 2.0, (LH, LW))).astype(np.float32)
    dark = np.abs(rng.normal(3.0, 1.0, (LH, LW))).astype(np.float32)
    flat = (1.0 + 0.1 * np.cos(np.arange(LW) * 0.013)[None, :]) \
        .astype(np.float32) * np.ones((LH, 1), np.float32)
    raw = np.clip(np.stack(frames) * flat + bias + 2.0 * dark, 0, 65535) \
        .astype(np.uint16)
    return raw, dict(bias=bias, dark=dark, flat=flat,
                     exp_ratios=np.full((LN,), 2.0, np.float32))


@pytest.mark.parametrize("centroid", ["kernel", "com"])
def test_lean_pipeline_fwhm8_matches_jax(centroid):
    """The lean path with ``fwhm=8.0`` (K1 on the ring route, radius 6)
    on stars of 8 px FWHM: the same reference frame and inliers, each
    frame's translation within 0.05 px of JAX's, and the stacks agreeing
    as test_torch_pipeline holds them at FWHM 3."""
    raw, kw = _oversampled_stack()
    jcfg = JaxConfig(centroid=centroid, **LEAN)
    out_j, diag_j = jax_lean(jnp.asarray(raw), config=jcfg,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    out_t, diag_t = calibrate_register_stack_lean(
        torch.from_numpy(raw), config=from_jax_config(jcfg),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert int(diag_t["ref_frame"]) == int(diag_j["ref_frame"])
    assert (diag_t["n_inliers"].numpy() >= 5).all()
    dt = np.stack([np.abs(diag_t[k].numpy() - np.asarray(diag_j[k]))
                   for k in ("tx", "ty")]).max(axis=0)
    assert (dt < 0.05).all(), dt
    out_t, out_j = out_t.numpy(), np.asarray(out_j)
    assert out_t.shape == (LH, LW) and np.isfinite(out_t).all()
    assert ((out_t != 0) == (out_j != 0)).mean() > 0.99
    both = (out_t != 0) & (out_j != 0)
    assert both.mean() > 0.8
    assert np.median(np.abs(out_t[both] - out_j[both])) < 0.5


def test_smoke_workload_stars_at_fwhm8():
    """chip_smoke.make_workload_on_device, run on the CPU at 3 x 1024^2
    with stars of 8 px FWHM: the port's find_stars at ``fwhm=8.0`` finds
    every isolated planted star (none other within 4 FWHM, where two
    profiles would blend) of each calibrated frame within 0.5 px of where
    ``workload_geometry`` put it."""
    import chip_smoke as cs

    n, size = 3, 1024
    fr, bias, dark, flat, er, _off, mats = cs.make_workload_on_device(
        n, size, torch.device("cpu"), seed=4, star_fwhm=8.0)
    geo = cs.workload_geometry(n, size, seed=4)
    np.testing.assert_array_equal(geo["mats"], mats)
    cal = ((fr.to(torch.float32) - torch.from_numpy(bias)
            - er * torch.from_numpy(dark - bias)) / torch.from_numpy(flat))
    for i in range(n):
        px, py = geo["px"][i], geo["py"][i]
        sep = np.hypot(px[:, None] - px[None, :], py[:, None] - py[None, :])
        np.fill_diagonal(sep, np.inf)
        isolated = sep.min(axis=1) > 32.0
        assert isolated.sum() >= 30
        stars = tdetect.find_stars(cal[i] - cs.SKY, fwhm=8.0, threshold=50.0,
                                   max_stars=64)
        ok = stars.valid.numpy()
        sx, sy = stars.x.numpy()[ok], stars.y.numpy()[ok]
        d = np.hypot(sx[:, None] - px[None, isolated],
                     sy[:, None] - py[None, isolated]).min(axis=0)
        assert (d < 0.5).all(), d.max()


def test_smoke_workload_default_unchanged():
    """At its default star FWHM (3 px) the on-device generator makes the
    stacks it made before it took ``star_fwhm``: the digests of 3 x 256^2
    (seed 2) and of 2 rotated frames (seed 5) made on the CPU, and an
    explicit 3 px equal to the default."""
    import chip_smoke as cs

    cpu = torch.device("cpu")

    def digest(out):
        return hashlib.sha256(out[0].view(torch.int16).numpy().tobytes()) \
            .hexdigest()

    snap = cs.make_workload_on_device(3, 256, cpu, seed=2)
    assert digest(snap) == ("18618d60277d203caa8685ce071eb872"
                            "2ce5abb0755101e4a8263ebfdd1547d2")
    assert snap[5] == pytest.approx(2.8271532739198486, abs=0)
    rot = cs.make_workload_on_device(2, 256, cpu, rotate=True, seed=5)
    assert digest(rot) == ("32a0fe3f4203ef6e39a5bc7608dcf1b5"
                           "ee87de477c101b525f016714c52e59ff")
    again = cs.make_workload_on_device(3, 256, cpu, seed=2, star_fwhm=3.0)
    assert digest(again) == digest(snap)
