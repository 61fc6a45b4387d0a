"""Port parity: the fused raw->candidate detector (K1) and its host
pieces, against the JAX package (the Pallas kernel runs in interpret
mode on the CPU backend, as the JAX suite runs it)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu import synth
from astrophotography_tpu.ops import detect as jdetect
from astrophotography_tpu.ops import pallas_detect as jpd
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import detect as tdetect
from astrophotography_tpu_torch.ops import detect_tiles as tdt

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

N, H, W = 2, 256, 512
THRESH = 60.0


def _stack(seed=0):
    """Raw uint16 frames plus bias, dark (exp ratio 2) and a flat with
    row-to-row structure, so every calibration plane matters."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(N):
        img, _ = synth.make_starfield((H, W), n_stars=12, background=500.0,
                                      read_noise=4.0, seed=seed + f + 1,
                                      margin=24, min_sep=30.0)
        frames.append(img)
    frames = np.stack(frames).astype(np.float32)
    bias = (250.0 + rng.normal(0, 2.0, (H, W))).astype(np.float32)
    dark = np.abs(rng.normal(3.0, 1.0, (H, W))).astype(np.float32)
    dark[100, 300] = 4000.0                       # a hot pixel
    flat = (1.0 + 0.1 * np.sin(np.arange(H) * 0.7)[:, None]
            + 0.05 * np.cos(np.arange(W) * 0.013)[None, :]).astype(np.float32)
    raw = np.clip(frames * flat + bias + 2.0 * dark, 0, 65535) \
        .astype(np.uint16)
    return raw, bias, dark, flat


def test_filter_constants_identical():
    for fwhm in (2.5, 3.0, 4.5):
        ours = tdt._filter_taps(fwhm)
        ref = jpd._filter_taps(fwhm)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert tdt._paroff_calibration(fwhm) == jpd._paroff_calibration(fwhm)
        assert tdetect._kernel_radius(fwhm) == jdetect._kernel_radius(fwhm)
        # the kernel's cached parameter block carries the same constants
        params, r = tdt._kernel_params(fwhm)
        gr, gc, _r, mean_w, inv_den = ref
        (cy1, cy3, cy5), (cx1, cx3, cx5) = jpd._paroff_calibration(fwhm)
        want = np.concatenate([gr, gc, np.asarray(
            [mean_w, inv_den, cy1, cy3, cy5, cx1, cx3, cx5], np.float32)])
        assert r == _r
        np.testing.assert_array_equal(np.asarray(params, np.float32), want)
        assert tdt._kernel_params(fwhm) is tdt._kernel_params(fwhm)


def test_master_densities_match():
    _raw, bias, dark, flat = _stack()
    for fl in (None, flat):
        ref = np.asarray(jpd.master_densities(
            jnp.asarray(bias), jnp.asarray(dark),
            None if fl is None else jnp.asarray(fl)))
        got = tdt.master_densities(
            torch.from_numpy(bias), torch.from_numpy(dark),
            None if fl is None else torch.from_numpy(fl)).numpy()
        assert got.shape == ref.shape == (2, H // 2, W)
        # both round through bf16 op by op; 2% of each plane's amplitude
        # (in practice they agree bit for bit)
        for k in range(2):
            scale = np.abs(ref[k]).max()
            assert np.abs(got[k] - ref[k]).max() <= 0.02 * scale, k


def _run_both(raw, thr, mf=None, a=None, er=None):
    ref = jpd.pallas_detect_tiles(
        jnp.asarray(raw), jnp.asarray(thr),
        mf_bc=None if mf is None else jnp.asarray(mf),
        a_plane=None if a is None else jnp.asarray(a),
        exp_ratios=None if er is None else jnp.asarray(er), band=64)
    got = tdt.detect_tiles(
        torch.from_numpy(raw), torch.from_numpy(thr),
        mf_bc=None if mf is None else torch.from_numpy(mf),
        a_plane=None if a is None else torch.from_numpy(a),
        exp_ratios=None if er is None else torch.from_numpy(er))
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


@pytest.mark.parametrize("masters", ["none", "bias_dark", "full"])
def test_detect_tiles_matches_pallas(masters):
    raw, bias, dark, flat = _stack(seed=3)
    thr = np.full((N,), THRESH, np.float32)
    er = np.full((N,), 2.0, np.float32)
    mf = a = None
    if masters != "none":
        fl = flat if masters == "full" else None
        mf = np.array(jpd.master_densities(         # writable copy
            jnp.asarray(bias), jnp.asarray(dark),
            None if fl is None else jnp.asarray(fl)))
        a = None if fl is None else (1.0 / flat).astype(np.float32)
    (rmax, ridx, ryo, rxo), (gmax, gidx, gyo, gxo) = _run_both(
        raw, thr, mf, a, er)
    assert gmax.shape == rmax.shape == (N, H // 64, W // 256)
    assert gidx.dtype == np.int32
    empty = rmax <= -1e37
    np.testing.assert_array_equal(gmax <= -1e37, empty)
    # density values: bf16 lane pass on the TPU side (as
    # tests/test_pallas_detect.py bounds it against f32)
    live = ~empty
    assert np.all(np.abs(gmax[live] - rmax[live])
                  <= 0.02 * np.abs(rmax[live]) + 0.5)
    np.testing.assert_array_equal(gidx[empty], 0)
    strong = rmax >= 10 * THRESH
    assert strong.sum() >= 8
    np.testing.assert_array_equal(gidx[strong], ridx[strong])
    np.testing.assert_allclose(gyo[strong], ryo[strong], atol=0.02)
    np.testing.assert_allclose(gxo[strong], rxo[strong], atol=0.02)
    np.testing.assert_array_equal(gyo[empty], 0.0)


def test_detect_tiles_rejects_bad_geometry():
    with pytest.raises(ValueError, match="geometry"):
        tdt.detect_tiles(torch.zeros((1, 96, 512), dtype=torch.uint16),
                         torch.ones(1))


def test_detect_tiles_float_frames_match_uint16():
    raw, _bias, _dark, _flat = _stack(seed=5)
    thr = torch.full((N,), THRESH)
    a = tdt.detect_tiles(torch.from_numpy(raw), thr)
    b = tdt.detect_tiles(torch.from_numpy(raw.astype(np.float32)), thr)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("h", [64, 128, 4096])
@pytest.mark.parametrize("n,w", [(1, 256), (8, 1024), (100, 4096), (3, 1536)])
def test_detect_kernel_layout(n, h, w):
    """The rolling K1 kernel's launch shape: the block's tile columns
    divide the frame's, its threads are 64 per tile column plus the two
    halo threads rounded up to warps, the strips cover every tile row,
    and the shared rows (two buffers of G and Box, a ring of four
    density rows) stay small."""
    lay = kernels._detect_layout(n, h, w)
    tyn, txn = h // 64, w // 256
    assert lay["tile_cols"] in (1, 2) and txn % lay["tile_cols"] == 0
    assert lay["tile_cols"] == max(k for k in (1, 2) if txn % k == 0)
    core = 64 * lay["tile_cols"]
    assert lay["threads"] % 32 == 0
    assert core + 2 <= lay["threads"] < core + 2 + 32 and lay["threads"] <= 160
    assert 1 <= lay["strip_tiles"] <= min(8, tyn)
    assert (lay["segments"] - 1) * lay["strip_tiles"] < tyn \
        <= lay["segments"] * lay["strip_tiles"]
    assert lay["smem_bytes"] == 4 * 8 * (4 * (core + 2) + 8) <= 17 * 1024
    # a grid that fills the card keeps the longest strip
    if n * (txn // lay["tile_cols"]) * -(-tyn // 8) >= 792:
        assert lay["strip_tiles"] == min(8, tyn)
    assert kernels._detect_layout(100, 4096, 4096) == {
        "tile_cols": 2, "strip_tiles": 8, "threads": 160, "segments": 8,
        "smem_bytes": 16896}


def test_detect_kernel_routes():
    """K1's route for every radius the TPU kernel reaches (1 to 128: its
    lane filter spans 128 columns and its band 128 binned rows each
    side): the rolling kernel at 2 and 3, the ring kernel at 1 and 4-16,
    the separable route (column pass through device memory) from 17.
    Radii past 128 raise."""
    for r in range(1, 129):
        assert kernels._detect_route(r) == (
            "rolling" if r in (2, 3) else
            "ring" if r <= 16 else "separable"), r
    for r in (0, 129):
        with pytest.raises(ValueError, match="radii 1 to 128"):
            kernels._detect_route(r)


@pytest.mark.parametrize("r", range(1, 129))
def test_detect_kernel_layout_every_radius(r):
    """The launch shape of each route (mirrors ``launch_rolling``,
    ``launch_ring`` and ``launch_separable``) at 100 x 4096^2: blocks of
    2 tile columns walking strips of 8 tiles on every route; the ring
    kernel has ceil((r + 1) / 4) halo threads each side and keeps its 2r
    binned rows beside the 8 shared rows, so 2 of its blocks fit an SM
    (227 KB) up to radius 16; the rolling and planes kernels keep 8
    shared rows, the planes kernel's with ceil(r / 4) + 1 groups of 4
    columns left of the strip, ceil(r / 4) + 4 right of it, and the row
    taps padded to a multiple of 4."""
    route = kernels._detect_route(r)
    n = kernels._detect_chunk(100, 4096, 4096) if route == "separable" \
        else 100
    lay = kernels._detect_layout(n, 4096, 4096, r)
    assert (lay["tile_cols"], lay["strip_tiles"], lay["segments"]) == \
        (2, 8, 8)
    q = -(-r // 4)
    if route == "rolling":
        assert lay == kernels._detect_layout(n, 4096, 4096)
    elif route == "ring":
        halo = -(-(r + 1) // 4)
        assert 128 + 2 * halo <= lay["threads"] == 160
        assert lay["smem_bytes"] == 4 * (2 * r + 8) * (4 * (128 + 2 * halo)
                                                       + 32)
        assert 2 * lay["smem_bytes"] <= 232448
    else:
        assert lay["threads"] == 160
        assert lay["smem_bytes"] == 4 * (8 * 4 * (128 + 2 * (q + 1) + 3)
                                         + (2 * r + 4) // 4 * 4)
        assert lay["smem_bytes"] <= 48 * 1024


@pytest.mark.parametrize("n,h,w,chunk", [(16, 4096, 4096, 16),
                                         (100, 4096, 4096, 16),
                                         (3, 64, 256, 3),
                                         (1, 16384, 16384, 1)])
def test_detect_separable_chunk(n, h, w, chunk):
    """The separable route's G and Box planes (8 B per binned pixel) take
    at most 1 GiB at once, or one frame's."""
    got = kernels._detect_chunk(n, h, w)
    assert got == chunk
    assert got * 8 * (h // 2) * w <= max(1 << 30, 8 * (h // 2) * w)
