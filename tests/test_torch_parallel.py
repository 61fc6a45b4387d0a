"""Port parity: the multi-device layer (``parallel/{launch,mesh,halo,
fused,sharded}``) on 4 CPU ranks over gloo, against the one-device port
and the JAX package's multi-device functions on the conftest's virtual
CPU mesh (its Pallas kernels in interpret mode).

The ranks are spawned processes (``parallel.launch.spawn``, a FileStore
in a temporary directory, no network); their programs are in
``tests/torch_parallel_ranks.py``.  One spawn runs every sharded half of
the parity checks (``ranks``); the dry run and the failing rank spawn
their own.  Geometry follows ``tests/test_parallel.py`` and
``tests/test_parallel_fused.py``, cut to the interpreter's budget."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from astrophotography_tpu import parallel as jpar
from astrophotography_tpu import synth
from astrophotography_tpu.models import PipelineConfig as JaxConfig
from astrophotography_tpu.models.pipeline import (
    calibrate_register_stack as jax_unfused,
    calibrate_register_stack_lean as jax_lean)
from astrophotography_tpu.ops.pallas_warp_combine import pallas_warp_combine
from astrophotography_tpu_torch import parallel as tpar
from astrophotography_tpu_torch.graft_entry import dryrun_multichip
from astrophotography_tpu_torch.models import (calibrate_register_stack,
                                               calibrate_register_stack_lean,
                                               PipelineConfig)
from astrophotography_tpu_torch.parallel import launch
from astrophotography_tpu_torch.parallel.fused import banded_warp_combine
from astrophotography_tpu_torch.models.pipeline import (lean_kernel_kwargs,
                                                        lean_masters)
from astrophotography_tpu_torch.ops.register import Similarity
from astrophotography_tpu_torch.parallel.mesh import mesh_shape
from astrophotography_tpu_torch.ops.warp_combine import warp_combine
from tests.test_register_stack import _make_dithered_stack
from tests.test_torch_bands import _clip_tie_rule, _stack
from tests.test_torch_warp_combine import _compare, _scene
from tests.torch_parallel_ranks import box5, failing_rank, parity_rank

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6);
# every rank sets the same
torch.set_num_threads(1)

WORLD = 4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _raw_masters_case(h, n_bands_halo):
    """tests/test_torch_bands.py's raw uint16 + masters translation case:
    translations are multiples of 1/64 px, so every band sums the
    snapped translation exactly."""
    frames, mats = _stack(4, h, 128, seed=3)
    rng = np.random.default_rng(9)
    flat = (1.0 + 0.05 * np.cos(np.arange(128) * 0.05)[None, :]
            * np.ones((h, 1))).astype(np.float32)
    bias = (300.0 + rng.normal(0, 2, (h, 128))).astype(np.float32)
    er = np.array([1.0, 0.5, 2.0, 1.5], np.float32)
    dark = np.abs(rng.normal(20, 3, (h, 128))).astype(np.float32)
    raw = np.clip(np.rint(frames * flat + bias + er[:, None, None] * dark),
                  0, 65535).astype(np.uint16)
    masters = np.stack([1.0 / flat, bias / flat, dark / flat]) \
        .astype(np.float32)
    return {"frames": _t(raw), "matrices": _t(mats), "masters": _t(masters),
            "exp_ratios": _t(er), "halo": n_bands_halo,
            "kw": dict(tile=(32, 64), span=8)}


def _rotation_case(taps):
    frames, mats = _stack(4, 256, 128, seed=23, theta_max=0.003)
    return {"frames": _t(frames), "matrices": _t(mats), "halo": 32,
            "kw": dict(tile=(32, 64), general_taps=taps)}


#: the two JAX interpret configurations: (source, taps)
JAX_CASES = (("raw_masters", "exact"), ("calibrated", "lowrank"))


def _jax_case(source, taps):
    """tests/test_torch_bands.py's scene (frames shifted down >= 4 px so
    the top tiles' taps stay inside the image)."""
    cal, raw, masters, mats, er, fs = _scene(5, 64, 128, seed=15,
                                             ty_range=(4.0, 6.0))
    kw = dict(tile=(32, 64), general_taps=taps)
    if source == "calibrated":
        return {"frames": _t(cal), "matrices": _t(mats), "halo": 16,
                "kw": kw}
    return {"frames": _t(raw), "matrices": _t(mats), "masters": _t(masters),
            "exp_ratios": _t(er), "halo": 16, "kw": kw}


def _unfused_inputs():
    """tests/test_parallel.py:98-139's frames (8 rolled copies of a 256^2
    field), with a bias, a dark (exposure ratios) and a flat."""
    rng = np.random.default_rng(17)
    img, _ = synth.make_starfield((256, 256), n_stars=10, fwhm=3.0,
                                  background=150.0, read_noise=4.0,
                                  flux_range=(20000.0, 60000.0), seed=17,
                                  min_sep=18.0)
    frames = np.stack([
        np.roll(np.roll(img, int(rng.integers(-3, 4)), 0),
                int(rng.integers(-3, 4)), 1)
        + rng.normal(0, 3, img.shape) for _ in range(8)]).astype(np.float32)
    bias = (100.0 + rng.normal(0, 1, (256, 256))).astype(np.float32)
    dark = np.full((256, 256), 4.0, np.float32)
    flat = (1.0 + 0.02 * np.cos(np.arange(256) * 0.03)[None, :]
            * np.ones((256, 1))).astype(np.float32)
    er = np.linspace(0.5, 1.5, 8).astype(np.float32)
    lights = (frames * flat + bias + er[:, None, None] * dark) \
        .astype(np.float32)
    return lights, {"bias": bias, "dark": dark + bias, "flat": flat,
                    "exp_ratios": er}


UNFUSED_CONFIGS = (dict(max_stars=16, match_k=8),
                   dict(max_stars=16, match_k=8, combine_impl="pallas",
                        n_bands=2))
#: the unfused pipeline with ``badpix_mask`` and ``flux_scales``: 'xla'
#: with the 'median' noise centre, 'pallas' (held to JAX too), 'fused'
EXTRA_CONFIGS = (dict(max_stars=16, match_k=8, noise_center="median"),
                 dict(max_stars=16, match_k=8, combine_impl="pallas",
                      n_bands=2),
                 dict(max_stars=16, match_k=8, combine_impl="fused"))


def _extras_inputs(lights):
    """The unfused lights with 60 hot pixels (+5000 ADU in every frame)
    that ``badpix_mask`` marks, and flux scales around 1."""
    rng = np.random.default_rng(21)
    bad = np.zeros(lights.shape[1:], bool)
    bad[rng.integers(0, 256, 60), rng.integers(0, 256, 60)] = True
    frames = lights.copy()
    frames[:, bad] += 5000.0
    return {"frames": _t(frames), "badpix": _t(bad),
            "flux_scales": _t(np.linspace(0.9, 1.2, 8).astype(np.float32)),
            "configs": EXTRA_CONFIGS}


def _lean_inputs():
    """Case 0: tests/test_parallel_fused.py:100-147 (chunked detection);
    case 1: K1's path (fused detection) on 4 frames of 256x1024."""
    h = w = 128
    frames, _truth, _ = _make_dithered_stack(n_frames=4, shape=(h, w), seed=9)
    bias = np.full((h, w), 250.0, np.float32)
    raw = np.clip(frames + bias, 0, 65535).astype(np.uint16)
    chunked = {"frames": _t(raw), "masters": {"bias": _t(bias)},
               "config": dict(max_stars=24, match_k=10,
                              detect_mode="chunked", detect_chunk=2,
                              detect_topk="tile", detect_fast=True,
                              fused_tile=(16, w))}
    rng = np.random.default_rng(4)
    h, w = 256, 1024
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((h, w), 300.0)
    for x0, y0 in rng.uniform([30, 30], [w - 30, h - 30], (40, 2)):
        img += rng.uniform(1e4, 4e4) * np.exp(
            -0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2) / 1.6)
    frames = np.stack([np.roll(img, (d, -d), (0, 1)) for d in (0, 2, 4, 6)])
    flat = (1.0 + 0.03 * np.sin(np.arange(w) * 0.02)[None, :]
            * np.ones((h, 1))).astype(np.float32)
    bias = np.full((h, w), 200.0, np.float32)
    dark = np.full((h, w), 3.0, np.float32)
    er = np.array([1.0, 1.2, 0.8, 1.0], np.float32)
    raw = np.clip(frames * flat + bias + er[:, None, None] * dark
                  + rng.normal(0, 4, frames.shape), 0, 65535) \
        .astype(np.uint16)
    fused = {"frames": _t(raw),
             "masters": {"bias": _t(bias), "dark": _t(dark + bias),
                         "flat": _t(flat), "exp_ratios": _t(er)},
             "config": dict(max_stars=16, match_k=8, detect_fast=True,
                            detect_bin_rows=True, detect_topk="tile",
                            detect_impl="fused", centroid="kernel",
                            fused_tile=(32, 256), warp_span=8)}
    return [chunked, fused]


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    lights, masters = _unfused_inputs()
    return {
        "grid": torch.arange(4 * 64 * 8, dtype=torch.float32)
        .reshape(4, 64, 8),
        "u16": _t(rng.integers(0, 65536, (2, 32, 8)).astype(np.uint16)),
        "image": _t(rng.normal(size=(128, 64)).astype(np.float32)),
        "warp_row": [_raw_masters_case(256, 32), _rotation_case("exact"),
                     _rotation_case("lowrank")],
        "warp_sq": [_raw_masters_case(256, 32)]
        + [_jax_case(*c) for c in JAX_CASES],
        "unfused": {"frames": _t(lights), "configs": UNFUSED_CONFIGS,
                    "masters": {k: _t(v) for k, v in masters.items()},
                    "extras": _extras_inputs(lights)},
        "lean": _lean_inputs(),
    }


@pytest.fixture(scope="module")
def ranks(inputs):
    """Every rank's results of ``parity_rank``, in rank order."""
    return launch.spawn(parity_rank, WORLD, device="cpu", transport="gloo",
                        args=(inputs,))


def _banded(case, n_bands):
    return banded_warp_combine(
        case["frames"], case["matrices"], n_bands,
        masters=case.get("masters"), exp_ratios=case.get("exp_ratios"),
        halo=case["halo"], **case["kw"])


# ---- the package surface and the mesh ------------------------------------

def test_parallel_exports_every_jax_name():
    assert set(jpar.__all__) <= set(tpar.__all__)
    assert set(tpar.__all__) - set(jpar.__all__) == {"banded_warp_combine"}
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)), name


def test_mesh_arithmetic_matches_jax():
    """tests/test_parallel.py:26-32's meshes and error, on 8 devices."""
    devs = jax.devices()[:8]
    for kw in ({}, {"n_frame": 2}, {"n_space": 4}, {"n_frame": 4,
                                                     "n_space": 2}):
        want = jpar.frame_space_mesh(devices=devs, **kw).devices.shape
        assert mesh_shape(8, kw.get("n_frame"), kw.get("n_space")) == want
    with pytest.raises(ValueError) as jerr:
        jpar.frame_space_mesh(n_frame=3, n_space=2, devices=devs)
    with pytest.raises(ValueError) as terr:
        mesh_shape(8, 3, 2)
    assert str(terr.value) == str(jerr.value) == \
        "mesh 3x2 does not match 8 devices"


def test_mesh_on_the_ranks(ranks):
    for r, res in enumerate(ranks):
        assert res["mesh_error"] == "mesh 3x2 does not match 4 devices"
        row, sq, flat = res["meshes"]
        assert row[:2] == ({"frame": 1, "space": 4},
                           {"frame": 0, "space": r})
        assert row[3] == [0, 1, 2, 3] and row[2] == [r]
        assert sq[:2] == ({"frame": 2, "space": 2},
                          {"frame": r // 2, "space": r % 2})
        assert sq[2] == [r % 2, 2 + r % 2]
        assert sq[3] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert flat[0] == {"frame": 4, "space": 1}
        assert {m[4] for m in res["meshes"]} == {"gloo"}


def test_placement_follows_the_partition_specs(ranks, inputs):
    grid = inputs["grid"]
    for r, res in enumerate(ranks):
        f, s = r // 2, r % 2
        got = res["placement"]
        assert torch.equal(got["shard_frames"],
                           grid[2 * f:2 * f + 2, 32 * s:32 * s + 32])
        assert torch.equal(got["shard_spatial"],
                           grid[:, 32 * s:32 * s + 32])
        assert torch.equal(got["replicate"], grid)
        assert torch.equal(got["local_frames"], grid[2 * f:2 * f + 2])
        assert res["split_error"] == "height 30 not divisible by space axis 4"


# ---- the halo exchange ---------------------------------------------------

def test_halo_exchange_pads_with_neighbour_rows(ranks, inputs):
    """uint16 rows travel as bytes; zero rows at the global edges."""
    u16 = inputs["u16"].view(torch.int16)
    zero = torch.zeros((2, 3, 8), dtype=torch.int16)
    for r, res in enumerate(ranks):
        got = res["halo_u16"]
        assert got.dtype == torch.uint16 and got.shape == (2, 14, 8)
        want = torch.cat([
            zero if r == 0 else u16[:, 8 * r - 3:8 * r],
            u16[:, 8 * r:8 * r + 8],
            zero if r == 3 else u16[:, 8 * r + 8:8 * r + 11]], dim=1)
        assert torch.equal(got.view(torch.int16), want)
        (rec,) = res["halo_traffic"]
        sides = 1 if r in (0, 3) else 2
        assert rec["op"] == "halo" and rec["transport"] == "gloo"
        assert rec["bytes_sent"] == rec["bytes_received"] == sides * 96
        assert rec["staging_ms"] == 0.0


def test_stencil_matches_unsharded_and_jax(ranks, inputs):
    """tests/test_parallel.py:56-77: a 5x5 box mean through
    ``sharded_map_overlap`` (halo 2) on a 1x4 mesh equals the unsharded
    stencil bit for bit, and JAX's ``sharded_map_overlap``."""
    img = inputs["image"]
    got = ranks[0]["stencil"]
    assert torch.equal(got, box5(img))

    def jbox5(x):
        h, w = x.shape
        p = jnp.pad(x, 2)
        acc = jnp.zeros_like(x)
        for dy in range(5):
            for dx in range(5):
                acc = acc + p[dy:dy + h, dx:dx + w]
        return acc / 25.0

    mesh = jpar.frame_space_mesh(n_frame=1, n_space=4,
                                 devices=jax.devices()[:4])
    lifted = jpar.sharded_map_overlap(jbox5, mesh, halo=2)
    with mesh:
        want = np.asarray(lifted(jax.device_put(
            img.numpy(), jpar.shard_spatial(mesh))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


# ---- sharded_warp_combine ------------------------------------------------

@pytest.mark.parametrize("k,what", [(0, "translations uint16 masters"),
                                    (1, "rotations exact"),
                                    (2, "rotations lowrank")])
def test_sharded_warp_combine_is_the_band_loop(ranks, inputs, k, what):
    """1x4 mesh against ``banded_warp_combine`` with 4 bands and the same
    halo: K2 gets identical inputs, so the stacks agree bit for bit."""
    want = _banded(inputs["warp_row"][k], 4)
    for res in ranks:
        got = res["warp_row"][k]
        assert got.shape == want.shape
        assert torch.equal(got, want), what
    assert (want != 0).float().mean() > 0.9


def test_sharded_translations_equal_the_whole_frame(ranks, inputs):
    """Translations that float32 sums exactly: the sharded stack is the
    whole-frame kernel's, edge rows included (2 'space' ranks)."""
    case = inputs["warp_sq"][0]
    whole = warp_combine(
        case["frames"], case["matrices"], masters=case["masters"],
        exp_ratios=case["exp_ratios"], **case["kw"])
    assert torch.equal(ranks[0]["warp_sq"][0], _banded(case, 2))
    assert torch.equal(ranks[0]["warp_sq"][0], whole)


def test_sharded_rotations_follow_the_clip_tie_rule(ranks, inputs):
    case = inputs["warp_row"][1]
    whole = warp_combine(case["frames"], case["matrices"],
                                    **case["kw"])
    _clip_tie_rule(ranks[0]["warp_row"][1], whole)


@pytest.mark.parametrize("k", [1, 2])
def test_sharded_warp_combine_matches_pallas(ranks, inputs, k):
    """2 'space' ranks against JAX's whole-frame ``pallas_warp_combine``
    (interpret mode) at tests/test_torch_warp_combine.py's tolerance."""
    case = inputs["warp_sq"][k]
    source, taps = JAX_CASES[k - 1]
    jkw = {}
    if source == "raw_masters":
        jkw = dict(masters=jnp.asarray(case["masters"].numpy()),
                   exp_ratios=jnp.asarray(case["exp_ratios"].numpy()))
    ref = np.asarray(pallas_warp_combine(
        jnp.asarray(case["frames"].numpy()),
        jnp.asarray(case["matrices"].numpy()), **case["kw"], **jkw))
    got = ranks[0]["warp_sq"][k]
    _compare(got.numpy(), ref)
    assert (got != 0).float().mean() > 0.4
    assert torch.equal(got, _banded(case, 2))


def test_sharded_warp_combine_rejects_bad_halo(ranks):
    for res in ranks:
        assert res["halo_error"] == \
            "halo must be smaller than the per-device band"


# ---- the pipelines -------------------------------------------------------

@pytest.fixture(scope="module")
def unfused_refs(inputs):
    """JAX's one-device run of the first config; the port's one-device
    runs of both configs with n_space x as many bands (the bands the
    sharded run warps)."""
    unf = inputs["unfused"]
    jkw = {k: jnp.asarray(v.numpy()) for k, v in unf["masters"].items()}
    out, diag = jax_unfused(jnp.asarray(unf["frames"].numpy()),
                            config=JaxConfig(**UNFUSED_CONFIGS[0]), **jkw)
    port = [calibrate_register_stack(
        unf["frames"], config=PipelineConfig(
            **{**cfg, "n_bands": 2 * cfg.get("n_bands", 1)}),
        **unf["masters"]) for cfg in UNFUSED_CONFIGS]
    return (np.asarray(out), {k: np.asarray(v) for k, v in diag.items()}), \
        port


def _same_diagnostics(got: dict, want: dict):
    for k, v in got.items():
        w = want[k]
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w), k
        else:
            assert v == w, k


@pytest.mark.parametrize("k", [0, 1])
def test_sharded_unfused_pipeline_is_the_one_device_band_loop(
        ranks, unfused_refs, k):
    """2x2 mesh against the one-device port warping the same bands
    (config.n_bands sub-bands of each 'space' band; config 1 combines
    with K3's twin): detection is per frame and the warp per frame and
    band, so the diagnostics and the stack agree bit for bit, within
    tests/test_parallel.py:98-139's rtol 1e-5 / atol 1e-2."""
    want, wdiag = unfused_refs[1][k]
    for res in ranks:
        got, diag = res["unfused"][k]
        assert torch.equal(got, want)
        _same_diagnostics(diag, wdiag)
        assert diag["n_inliers"].min() >= 6
    assert ranks[0]["unfused_band_error"] == \
        "band height 128 not divisible by n_bands 3"


def test_sharded_unfused_pipeline_matches_jax(ranks, unfused_refs):
    """tests/test_parallel.py:98-139's geometry on a 2x2 mesh against
    JAX's one-device run: JAX's inliers (at least 6), reference frame and
    translations (1e-3 px), and the stack by the port's cross-package
    rule (tests/test_torch_unfused_pipeline.py: median |diff| < 1e-3,
    > 1 ADU on < 0.5 % of the pixels; the two packages round the
    registration differently, 3e-4 px, which moves star cores)."""
    (want, jd), _port = unfused_refs
    got, diag = ranks[0]["unfused"][0]
    np.testing.assert_array_equal(diag["n_inliers"].numpy(), jd["n_inliers"])
    assert diag["n_inliers"].min() >= 6
    assert diag["ref_frame"] == int(jd["ref_frame"])
    for k in ("tx", "ty"):
        np.testing.assert_allclose(diag[k].numpy(), jd[k], rtol=0, atol=1e-3)
    diff = np.abs(got.numpy() - want)
    assert np.median(diff) < 1e-3
    assert (diff > 1.0).mean() < 0.005


@pytest.fixture(scope="module")
def extras_refs(inputs):
    """The one-device port with ``badpix_mask`` and ``flux_scales`` under
    each EXTRA_CONFIGS entry, warping n_space x as many bands (the
    whole frame under 'fused'), and JAX's frame-sharded run of the
    'pallas' entry."""
    unf = inputs["unfused"]
    ext = unf["extras"]
    kw = {**unf["masters"], "badpix_mask": ext["badpix"],
          "flux_scales": ext["flux_scales"]}
    port = []
    for cfg in EXTRA_CONFIGS:
        if cfg.get("combine_impl") != "fused":
            cfg = {**cfg, "n_bands": 2 * cfg.get("n_bands", 1)}
        port.append(calibrate_register_stack(
            ext["frames"], config=PipelineConfig(**cfg), **kw))
    return port, _jax_frame_sharded(
        ext["frames"].numpy(), {k: v.numpy() for k, v in kw.items()},
        JaxConfig(**EXTRA_CONFIGS[1]))


def _jax_frame_sharded(frames, kw, cfg):
    """tests/test_parallel.py:100-140's run: JAX's
    ``calibrate_register_stack`` jitted on a 4x2 (frame, space) mesh of
    the conftest's CPU devices, the frames sharded over 'frame', the
    stack constrained to rows over 'space'."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jpar.frame_space_mesh(n_frame=4, n_space=2,
                                 devices=jax.devices()[:8])
    with mesh:
        sharded = jax.device_put(
            frames, NamedSharding(mesh, P("frame", None, None)))

        def step(fr):
            stacked, diag = jax_unfused(
                fr, config=cfg, **{k: jnp.asarray(v) for k, v in kw.items()})
            stacked = jax.lax.with_sharding_constraint(
                stacked, NamedSharding(mesh, P("space", None)))
            return stacked, diag

        out, diag = jax.jit(step)(sharded)
    return np.asarray(out), {k: np.asarray(v) for k, v in diag.items()}


@pytest.mark.parametrize("k,what", [(0, "xla, median noise centre"),
                                    (1, "pallas")])
def test_sharded_unfused_with_badpix_and_flux_is_the_band_loop(
        ranks, extras_refs, k, what):
    """``badpix_mask`` and ``flux_scales`` on the 2x2 mesh: the repair
    and the scales work frame by frame, so the stack equals the
    one-device port warping the same bands bit for bit, and the
    diagnostics too (the 'median' noise statistics fold their sums)."""
    want, wdiag = extras_refs[0][k]
    for res in ranks:
        got, diag, mats, halo = res["unfused_extras"][k]
        assert torch.equal(got, want), what
        _same_diagnostics(diag, {n: wdiag[n] for n in diag})
        assert torch.equal(mats, wdiag["matrices"])
        assert halo is None
        assert diag["n_inliers"].min() >= 6


def test_sharded_unfused_with_badpix_and_flux_matches_jax(ranks, extras_refs):
    """The 'pallas' entry against JAX's frame-sharded run, by
    test_sharded_unfused_pipeline_matches_jax's rule."""
    want, jd = extras_refs[1]
    got, diag, _mats, _halo = ranks[0]["unfused_extras"][1]
    np.testing.assert_array_equal(diag["n_inliers"].numpy(), jd["n_inliers"])
    assert diag["ref_frame"] == int(jd["ref_frame"])
    for key in ("tx", "ty"):
        np.testing.assert_allclose(diag[key].numpy(), jd[key], rtol=0,
                                   atol=1e-3)
    diff = np.abs(got.numpy() - want)
    assert np.median(diff) < 1e-3
    assert (diff > 1.0).mean() < 0.005


def test_sharded_unfused_fused_is_the_band_loop(ranks, inputs, extras_refs):
    """combine_impl='fused' on the 2x2 mesh: each rank gathers the
    calibrated rows of its band and runs K2 over 'space' with the halo
    the solved matrices need; bit for bit the band loop on the
    one-device calibrated stack at that halo, the one-device diagnostics
    bit for bit, the clip-tie rule against the one-device whole frame
    (the bands round the snapped translation beside their row offset);
    n_bands > 1 is refused, as on one device."""
    from astrophotography_tpu_torch.ops.calibrate import calibrate_batch

    unf = inputs["unfused"]
    ext = unf["extras"]
    cfg = PipelineConfig(**EXTRA_CONFIGS[2])
    whole, wdiag = extras_refs[0][2]
    m = unf["masters"]
    cal = calibrate_batch(ext["frames"], m["bias"], m["dark"], m["flat"],
                          m["exp_ratios"], badpix_mask=ext["badpix"]) \
        * ext["flux_scales"][:, None, None]
    _n, h, w = cal.shape
    halos = {res["unfused_extras"][2][3] for res in ranks}
    assert len(halos) == 1
    (halo,) = halos
    assert halo == _halo_of(ranks[0]["unfused_extras"][2][1], h, w)
    banded = banded_warp_combine(cal, wdiag["matrices"], 2, halo=halo,
                                 **lean_kernel_kwargs(cfg, h, w))
    for res in ranks:
        got, diag, mats, _halo = res["unfused_extras"][2]
        _same_diagnostics(diag, {n: wdiag[n] for n in diag})
        assert torch.equal(mats, wdiag["matrices"])
        assert torch.equal(got, banded)
    _clip_tie_rule(got, whole)
    assert ranks[0]["fused_band_error"] == \
        "combine_impl='fused' subsumes banding; use n_bands=1"


def _lean_tie_rule(got, ref):
    """tests/test_parallel_fused.py:100-147's rule."""
    both = (got != 0) & (ref != 0)
    assert both.mean() > 0.8
    err = np.abs(got[both] - ref[both])
    assert (err > 0.5 + 1e-4 * np.abs(ref[both])).mean() < 3e-4


def test_sharded_lean_pipeline_matches_jax(ranks, inputs):
    """tests/test_parallel_fused.py:100-147 on a 2x2 mesh: JAX's inliers,
    the clip-tie rule against JAX's stack."""
    case = inputs["lean"][0]
    want, dj = jax_lean(jnp.asarray(case["frames"].numpy()),
                        bias=jnp.asarray(case["masters"]["bias"].numpy()),
                        config=JaxConfig(**case["config"]))
    for res in ranks:
        got, diag, _halo = res["lean"][0]
        np.testing.assert_array_equal(diag["n_inliers"].numpy(),
                                      np.asarray(dj["n_inliers"]))
        _lean_tie_rule(got.numpy(), np.asarray(want))


def test_sharded_lean_with_fused_detection_matches_one_device(ranks,
                                                              inputs):
    """K1's path (detection on each frame shard) with masters and
    exposure ratios: the one-device lean's diagnostics bit for bit (every
    frame is detected on its own), and its matrices through the band
    loop at the halo the ranks derived (2 bands) bit for bit.  Against the
    one-device whole frame: equal coverage and a median |diff| under
    1e-3 (a band sums each solved translation next to its own row offset,
    ~1e-4 px, which moves these steep 1.3 px stars by up to ~1 ADU)."""
    case = inputs["lean"][1]
    cfg = PipelineConfig(**case["config"])
    m = case["masters"]
    whole, diag = calibrate_register_stack_lean(case["frames"], config=cfg,
                                                **m)
    _n, h, w = case["frames"].shape
    mats = Similarity(*(diag[k] for k in ("scale", "theta", "tx", "ty",
                                          "n_inliers", "rms"))).matrix()
    masters = lean_masters(m["bias"], m["dark"], m["flat"], cfg, h, w,
                           torch.device("cpu"))
    halo = ranks[0]["lean"][1][2]
    banded = banded_warp_combine(case["frames"], mats, 2, masters=masters,
                                 exp_ratios=m["exp_ratios"], halo=halo,
                                 **lean_kernel_kwargs(cfg, h, w))
    for res in ranks:
        got, gdiag, _halo = res["lean"][1]
        _same_diagnostics(gdiag, diag)
        assert gdiag["n_inliers"].min() >= 6
        assert torch.equal(got, banded)
        np.testing.assert_array_equal(got.numpy() == 0, whole.numpy() == 0)
        assert float((got - whole).abs().median()) < 1e-3


def _halo_of(diag: dict, h: int, w: int) -> int:
    """The halo rule in numpy: the largest |source row - output row| at
    the image corners of the registered frames, plus Lanczos3's 6 tap
    rows, rounded up to 8."""
    mats = Similarity(*(diag[k] for k in ("scale", "theta", "tx", "ty",
                                          "n_inliers", "rms"))).matrix()
    m = mats.numpy().astype(np.float64)
    xs, ys = np.array([0, w - 1, 0, w - 1]), np.array([0, 0, h - 1, h - 1])
    reach = np.abs(m[:, 1, 0:1] * xs + (m[:, 1, 1:2] - 1) * ys
                   + m[:, 1, 2:3]).max()
    return -(-(int(np.ceil(reach)) + 6) // 8) * 8


def test_sharded_lean_checks_the_halo(ranks, inputs):
    """Each 'space' band gets the halo the solved matrices need, the same
    on every rank; the lean path's exchanges are the gathers and the
    halo."""
    for k, case in enumerate(inputs["lean"]):
        _n, h, w = case["frames"].shape
        halos = {res["lean"][k][2] for res in ranks}
        assert halos == {_halo_of(ranks[0]["lean"][k][1], h, w)}
    assert ranks[0]["traffic_ops"] == ["all_gather", "halo"]


@pytest.mark.parametrize("ty,band,want", [
    (0.0, 1024, 8), (3.2, 1024, 16), (-3.2, 1024, 16), (24.0, 32, 31),
    (30.0, 32, None)])
def test_lean_halo_rule(ty, band, want):
    """``lean_halo``: reach + 6 rows rounded up to 8, kept below the band;
    a rejected frame (moved out of the field) does not count; a band that
    cannot hold the reach is an error."""
    from astrophotography_tpu_torch.ops.register import REJECTED_TRANSLATION
    from astrophotography_tpu_torch.parallel.sharded import lean_halo

    mats = torch.zeros((3, 2, 3))
    mats[:, 0, 0] = mats[:, 1, 1] = 1.0
    mats[1, 1, 2] = ty
    mats[2, :, 2] = REJECTED_TRANSLATION
    if want is None:
        with pytest.raises(ValueError, match="band of 32 rows too small"):
            lean_halo(mats, 4096, 4096, band)
    else:
        assert lean_halo(mats, 4096, 4096, band) == want


# ---- the launcher and the dry run ----------------------------------------

def test_dryrun_multichip_on_cpu_ranks(capsys):
    ranks = dryrun_multichip(4, size=128, lean_size=128, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip: 4 ranks on cpu, transport gloo" in out
    assert ("dryrun_multichip OK: mesh {'frame': 2, 'space': 2}, "
            "stacked (128, 128), inliers [") in out
    assert "sharded-fused-with-masters (128, 128), lean-sharded (128, 128)" \
        in out
    assert all(r["finite"] for r in ranks)
    assert [r["inliers"] for r in ranks] == [ranks[0]["inliers"]] * 4
    with pytest.raises(ValueError, match="8-row-aligned bands"):
        dryrun_multichip(4, size=100, device="cpu")


def test_a_failing_rank_fails_the_run():
    with pytest.raises(RuntimeError) as err:
        launch.spawn(failing_rank, 2, device="cpu", transport="gloo")
    assert "rank 1:" in str(err.value)
    assert "ValueError: rank 1 fails on purpose" in str(err.value)


def test_transport_rule_is_checked_before_launch(monkeypatch):
    with pytest.raises(ValueError, match="needs CUDA devices"):
        launch.spawn(failing_rank, 2, device="cpu", transport="nccl")
    with pytest.raises(ValueError, match="transport must be one of"):
        launch.spawn(failing_rank, 2, device="cpu", transport="mpi")
    shared = [torch.device("cuda", 0)] * 4
    with pytest.raises(ValueError, match="4 ranks share 1 card"):
        launch.check_transport(shared, "nccl")
    launch.check_transport(shared, "gloo")
    launch.check_transport([torch.device("cuda", r) for r in range(4)],
                           "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert launch.rank_devices(None, 3) == [torch.device("cuda", 0)] * 3
    assert launch.default_transport("cuda", 3) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert launch.rank_devices("cuda", 4) == [torch.device("cuda", r)
                                              for r in range(4)]
    assert launch.default_transport(None, 4) == "nccl"


def test_device_none_means_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        launch.spawn(failing_rank, 2, transport="gloo")
    with pytest.raises(RuntimeError, match="is_available"):
        dryrun_multichip(2, size=64)


def test_spawn_refuses_card_tensors_and_shares_host_ones():
    x = torch.zeros(4)
    launch._share((x, {"a": [x]}))
    assert x.is_shared()
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        launch._share(({"a": meta},))
