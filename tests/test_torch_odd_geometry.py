"""Port parity at shapes aligned to nothing: the twin of
tests/test_odd_geometry.py.

The port's pipelines and ``ap_stack`` against the JAX package's on the
same numpy inputs, at (250, 236) (neither axis a multiple of 128) and
(501, 333) (both odd: not even a multiple of 8), where K2's plan pads the
image up to its tile grid.  The bounds are the JAX test's own between
its two paths: on the pixels both cover, median |diff| < 0.05 ADU and
99th percentile < 0.5 ADU (0.05 ADU on a 180 ADU sky is 0.03 %); equal
zero and NaN masks, equal inlier counts, and the stars recovered as the
JAX test counts them.  The JAX package's Pallas kernels run in interpret
mode on the CPU backend, the port's wrappers run their plain twins.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu import synth
from astrophotography_tpu.cli.ap_stack import main as jax_ap_stack
from astrophotography_tpu.io.fits import Header, read_image, write_image
from astrophotography_tpu.models import PipelineConfig as JaxConfig
from astrophotography_tpu.models import \
    calibrate_register_stack as jax_stack
from astrophotography_tpu.models.pipeline import \
    calibrate_register_stack_lean as jax_lean
from astrophotography_tpu_torch.cli.ap_stack import main as port_ap_stack
from astrophotography_tpu_torch.models import (PipelineConfig,
                                               calibrate_register_stack,
                                               calibrate_register_stack_lean)

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

ODD_SHAPES = [(250, 236), (501, 333)]
BASE = dict(max_stars=24, match_k=8)


def _odd_stack(shape, n_frames=4, seed=5, n_stars=10):
    """The JAX test's frames: isolated Gaussian stars on a 180 ADU sky
    with 5 ADU noise, frame 0 the reference, the others dithered by up
    to 3 px.  Returns (frames (N, H, W) float32, (star xs, ys))."""
    rng = np.random.default_rng(seed)
    h, w = shape
    xs = rng.uniform(25, w - 25, n_stars)
    ys = rng.uniform(25, h - 25, n_stars)
    keep = [i for i in range(n_stars)
            if all((xs[i] - xs[j]) ** 2 + (ys[i] - ys[j]) ** 2 > 400
                   for j in range(i))]
    xs, ys = xs[keep], ys[keep]
    fl = rng.uniform(30000, 80000, len(xs))
    frames = []
    for i in range(n_frames):
        dx, dy = (rng.uniform(-3, 3, 2) if i else (0.0, 0.0))
        img = np.full(shape, 180.0, np.float32)
        for x, y, f in zip(xs + dx, ys + dy, fl):
            img += synth.gaussian_star(shape, x, y, f, 3.0)
        img += rng.normal(0, 5.0, shape).astype(np.float32)
        frames.append(img)
    return np.stack(frames).astype(np.float32), (xs, ys)


def _stars_recovered(stacked, xs, ys):
    """Planted stars found within 1 px in ``stacked``, counted as the JAX
    test counts them (its find_stars above 7 sigma of the clipped
    statistics)."""
    from astrophotography_tpu.ops import find_stars, sigma_clipped_stats

    _, med, std = (float(v) for v in sigma_clipped_stats(
        jnp.asarray(stacked), sigma=3.0))
    stars = find_stars(jnp.asarray(stacked) - med, fwhm=3.0,
                       threshold=7.0 * std, max_stars=32)
    v = np.asarray(stars.valid)
    fx, fy = np.asarray(stars.x)[v], np.asarray(stars.y)[v]
    return sum(1 for x, y in zip(xs, ys)
               if np.hypot(fx - x, fy - y).min() < 1.0)


def _agree(got, want, shape):
    """The JAX test's bounds between two paths, here the port and JAX."""
    assert got.shape == want.shape == shape
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got == 0, want == 0)
    both = (got != 0) & (want != 0)
    assert both.mean() > 0.8
    err = np.abs(got[both] - want[both])
    assert np.median(err) < 0.05
    assert np.percentile(err, 99) < 0.5


@pytest.mark.parametrize("impl", ["xla", "pallas", "fused"])
@pytest.mark.parametrize("shape", ODD_SHAPES)
def test_register_stack_odd_shape(shape, impl):
    """``calibrate_register_stack`` with each combine: the XLA-style
    combine, K3 and K2 (the fused kernel pads the image to its tiles)."""
    frames, (xs, ys) = _odd_stack(shape)
    want, dj = jax_stack(jnp.asarray(frames),
                         config=JaxConfig(combine_impl=impl, **BASE))
    got, dt = calibrate_register_stack(
        torch.from_numpy(frames),
        config=PipelineConfig(combine_impl=impl, **BASE))
    got = got.numpy()
    _agree(got, np.asarray(want), shape)
    np.testing.assert_array_equal(dt["n_inliers"].numpy(),
                                  np.asarray(dj["n_inliers"]))
    assert int(dt["ref_frame"]) == int(dj["ref_frame"])
    inl = dt["n_inliers"].numpy()
    ref = int(dt["ref_frame"])
    assert all(inl[i] >= 4 for i in range(len(inl)) if i != ref), inl
    assert _stars_recovered(got, xs, ys) >= len(xs) - 1


@pytest.mark.parametrize("detect", [dict(detect_mode="chunked",
                                         detect_chunk=2), {}],
                         ids=["chunked", "default"])
def test_lean_pipeline_odd_shape(detect):
    """``calibrate_register_stack_lean`` (raw uint16, the bias folded into
    K2's calibration) at (250, 236)."""
    shape = (250, 236)
    frames, (xs, ys) = _odd_stack(shape)
    bias = np.full(shape, 250.0, np.float32)
    raw = np.clip(frames + bias, 0, 65535).astype(np.uint16)
    want, dj = jax_lean(jnp.asarray(raw), bias=jnp.asarray(bias),
                        config=JaxConfig(**BASE, **detect))
    got, dt = calibrate_register_stack_lean(
        torch.from_numpy(raw), bias=torch.from_numpy(bias),
        config=PipelineConfig(**BASE, **detect))
    got = got.numpy()
    _agree(got, np.asarray(want), shape)
    np.testing.assert_array_equal(dt["n_inliers"].numpy(),
                                  np.asarray(dj["n_inliers"]))
    assert _stars_recovered(got, xs, ys) >= len(xs) - 1


def test_ap_stack_cli_odd_shape(tmp_path):
    """``ap_stack`` on 3 FITS frames of 250 x 236, the port with
    ``--device cpu``: the stack within the bounds, the weight map equal,
    NSTACK 3 and the stars recovered."""
    frames, (xs, ys) = _odd_stack((250, 236), n_frames=3)
    paths = []
    for i, f in enumerate(frames):
        h = Header()
        h["EXPTIME"] = 60.0
        p = str(tmp_path / f"f{i}.fits")
        write_image(p, f, h)
        paths.append(p)
    outs = {}
    for name, main, extra in (("jax", jax_ap_stack, []),
                              ("port", port_ap_stack, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.fits")
        wout = str(tmp_path / f"{name}_w.fits")
        assert main(paths + ["-o", out, "--weight_out", wout, "-l", "ERROR"]
                    + extra) == 0
        outs[name] = (read_image(out), read_image(wout)[0])
    (got, hdr), wmap = outs["port"]
    (want, _), wmap_j = outs["jax"]
    _agree(got, want, (250, 236))
    assert hdr["NSTACK"] == 3
    assert wmap.shape == (250, 236)
    assert np.isclose(wmap[125, 118], 3.0)
    np.testing.assert_allclose(wmap, wmap_j, rtol=0, atol=1e-5)
    assert _stars_recovered(got, xs, ys) >= len(xs) - 1
