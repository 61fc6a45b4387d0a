"""Port parity: the lean calibrate -> detect -> register -> warp -> stack
path end to end against the JAX package's
``calibrate_register_stack_lean`` (its Pallas kernels in interpret mode
on the CPU backend), plus the configuration converter and the
port's independence from JAX."""

import functools
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu.models import PipelineConfig as JaxConfig
from astrophotography_tpu.models.pipeline import (
    calibrate_register_stack_lean as jax_lean)
from astrophotography_tpu_torch.models import (PipelineConfig,
                                               calibrate_register_stack_lean,
                                               from_jax_config)
from tests.test_register_stack import _make_dithered_stack

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N = 256, 768, 4
BASE = dict(max_stars=24, match_k=10, detect_fast=True, detect_bin_rows=True,
            detect_topk="tile", detect_mode="chunked", detect_chunk=2,
            detect_impl="fused", fused_tile=(32, 256), warp_span=8)


#: near-tie seed: under centroid='com' with full masters, the port and
#: JAX centre one frame's 5x5 boxes one binned row apart (the port's
#: detector density is float32 where the TPU kernel's lane pass is bf16;
#: ROADMAP.md section 3).  Measured on the CPU: frame 3 moves by
#: 0.0032 px in tx and 0.0974 px in ty; seed 34 moves one frame by
#: 0.08 px in both and changes its inlier count by one.
TIE_SEED = 33
#: bound on that frame's shift: the measured 0.0974 px with room for
#: platform rounding, well under the 0.5 px rms bound of registration
TIE_TOL_PX = 0.15


@functools.lru_cache(maxsize=None)
def _inputs(masters: str, seed: int = None):
    """4 dithered, rotated frames with bias only, or bias + dark + flat
    (exp ratio 2), as tests/test_pallas_detect.py builds them.

    The default seeds keep every registration star off a near-tie
    between two binned peak rows (see ``TIE_SEED``)."""
    if seed is None:
        seed = 21 if masters == "bias" else 35
    frames, _truths, _ = _make_dithered_stack(n_frames=N, shape=(H, W),
                                              seed=seed)
    rng = np.random.default_rng(seed)
    if masters == "bias":
        bias = np.full((H, W), 250.0, np.float32)
        raw = np.clip(frames + bias, 0, 65535).astype(np.uint16)
        return raw, dict(bias=bias)
    bias = np.full((H, W), 250.0, np.float32) \
        + rng.normal(0, 2.0, (H, W)).astype(np.float32)
    dark = np.abs(rng.normal(3.0, 1.0, (H, W))).astype(np.float32)
    flat = (1.0 + 0.1 * np.cos(np.arange(W) * 0.013)[None, :]) \
        .astype(np.float32) * np.ones((H, 1), np.float32)
    raw = np.clip(frames * flat + bias + 2.0 * dark, 0, 65535) \
        .astype(np.uint16)
    return raw, dict(bias=bias, dark=dark, flat=flat,
                     exp_ratios=np.full((N,), 2.0, np.float32))


def _run_both(raw, kw, centroid):
    jcfg = JaxConfig(centroid=centroid, **BASE)
    out_j, diag_j = jax_lean(jnp.asarray(raw), config=jcfg,
                             **{k: jnp.asarray(v) for k, v in kw.items()})
    out_t, diag_t = calibrate_register_stack_lean(
        torch.from_numpy(raw), config=from_jax_config(jcfg),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert int(diag_t["ref_frame"]) == int(diag_j["ref_frame"])
    dt = np.stack([np.abs(diag_t[k].numpy() - np.asarray(diag_j[k]))
                   for k in ("tx", "ty")]).max(axis=0)
    return out_t.numpy(), np.asarray(out_j), diag_t, dt


def _assert_stacks_agree(out_t, out_j):
    assert out_t.shape == (H, W) and np.isfinite(out_t).all()
    assert ((out_t != 0) == (out_j != 0)).mean() > 0.99
    both = (out_t != 0) & (out_j != 0)
    assert both.mean() > 0.8
    assert np.median(np.abs(out_t[both] - out_j[both])) < 0.5


@pytest.mark.parametrize("centroid", ["kernel", "com"])
@pytest.mark.parametrize("masters", ["bias", "full"])
def test_lean_pipeline_matches_jax(centroid, masters):
    raw, kw = _inputs(masters)
    out_t, out_j, diag_t, dt = _run_both(raw, kw, centroid)
    assert (diag_t["n_inliers"].numpy() >= 5).all()
    assert (dt < 0.05).all(), dt
    _assert_stacks_agree(out_t, out_j)


def test_lean_pipeline_near_tie_bounded():
    """On a near-tie seed the float32-vs-bf16 density divergence moves
    one frame past the 0.05 px bound above, and by no more than
    ``TIE_TOL_PX``; every other frame still agrees within 0.05 px."""
    raw, kw = _inputs("full", TIE_SEED)
    out_t, out_j, diag_t, dt = _run_both(raw, kw, "com")
    assert (diag_t["n_inliers"].numpy() >= 5).all()
    assert (dt < TIE_TOL_PX).all(), dt
    assert (dt >= 0.05).sum() <= 1, dt
    _assert_stacks_agree(out_t, out_j)


def test_config_converter_round_trips():
    jcfg = JaxConfig(centroid="kernel", general_taps="lowrank",
                     fused_tile=(32, 256), ref_frame="auto", **{
                         k: v for k, v in BASE.items() if k != "fused_tile"})
    cfg = from_jax_config(jcfg)
    for name in jcfg.__dataclass_fields__:
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert from_jax_config(JaxConfig()) == PipelineConfig()
    for bad in (dict(centroid="kernal"), dict(detect_impl="fused2"),
                dict(noise_center="mode"), dict(general_taps="fast")):
        with pytest.raises(ValueError):
            PipelineConfig(**bad)


@pytest.mark.parametrize("centroid", ["kernel", "com"])
def test_detect_stars_fused_matches_jax(centroid):
    """The detection glue (noise stats, K1, top-k, centroids) gives the
    JAX package's Stars tables on the same raw frames."""
    from astrophotography_tpu.models.pipeline import (
        _detect_stars_fused as jax_detect)
    from astrophotography_tpu_torch.models import stars_to_numpy
    from astrophotography_tpu_torch.models.pipeline import (
        _detect_stars_fused as torch_detect)

    raw, kw = _inputs("bias")
    jcfg = JaxConfig(centroid=centroid, **BASE)
    er = np.ones((N,), np.float32)
    want = stars_to_numpy(jax_detect(jnp.asarray(raw), jnp.asarray(kw["bias"]),
                                     None, None, jnp.asarray(er), jcfg))
    got = stars_to_numpy(torch_detect(
        torch.from_numpy(raw), torch.from_numpy(kw["bias"]), None, None,
        torch.from_numpy(er), from_jax_config(jcfg)))
    np.testing.assert_array_equal(got["valid"], want["valid"])
    v = want["valid"]
    assert v.sum(axis=1).min() >= 5
    np.testing.assert_allclose(got["flux"][v], want["flux"][v], rtol=0.02,
                               atol=0.5)
    np.testing.assert_allclose(got["x"][v], want["x"][v], atol=0.05)
    np.testing.assert_allclose(got["y"][v], want["y"][v], atol=0.05)


def test_resolve_device_never_falls_back():
    from astrophotography_tpu_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    assert resolve_device(torch.device("cpu")).type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert resolve_device().type == "cuda"
        assert resolve_device(None).type == "cuda"
    else:
        # no argument means the card, never a quiet CPU
        for dev in ("cuda", None):
            with pytest.raises(RuntimeError, match="cuda"):
                resolve_device(dev)
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device()


def test_unported_paths_raise():
    """The unfused path takes a ``badpix_mask`` (a tensor or a numpy
    array) and repairs the flagged pixels before it detects, and no
    ``NotImplementedError`` is left in the port's ``ops/``.  A fused
    detector the geometry or the config cannot take is a ValueError."""
    from astrophotography_tpu_torch.models import calibrate_register_stack

    raw, kw = _inputs("bias")
    hot = np.zeros((H, W), bool)
    hot[40:200:16, 50:700:50] = True
    raw = raw.copy()
    raw[:, hot] = 60000
    frames = torch.from_numpy(raw)
    bias = torch.from_numpy(kw["bias"])
    cfg = PipelineConfig(max_stars=24, match_k=10, detect_nsigma=7.0)
    clean, diag = calibrate_register_stack(frames, bias=bias,
                                           badpix_mask=hot, config=cfg)
    as_tensor, _ = calibrate_register_stack(
        frames, bias=bias, badpix_mask=torch.from_numpy(hot), config=cfg)
    assert torch.equal(clean, as_tensor)
    assert (diag["n_inliers"].numpy() >= 5).all()
    # the reference frame is warped by the identity: its hot pixels stay
    # at 60000 in one of four samples unless they were repaired
    assert float(clean[torch.from_numpy(hot)].max()) < 5000.0
    ops_dir = os.path.join(REPO, "astrophotography_tpu_torch", "ops")
    for name in sorted(os.listdir(ops_dir)):
        if name.endswith(".py"):
            with open(os.path.join(ops_dir, name)) as f:
                assert "NotImplementedError" not in f.read(), name
    with pytest.raises(ValueError, match="detect_impl='fused'"):
        calibrate_register_stack_lean(frames, bias=bias, config=PipelineConfig(
            **{**BASE, "detect_fast": False}))


def test_smoke_workload_equals_bench_workload():
    """bench_torch.py's jax-free workload generator (the one chip_smoke.py
    uses) makes bench.py's workload exactly, and its matrices map
    reference stars onto frames."""
    import bench
    import bench_torch
    import chip_smoke

    assert chip_smoke.make_workload is bench_torch.make_workload
    for rotate in (False, True):
        ours = bench_torch.make_workload(3, 160, rotate=rotate)
        ref = bench._make_workload(3, 160, rotate=rotate)
        for a, b in zip(ours[:6], ref):
            np.testing.assert_array_equal(a, b)
        mats = ours[6]
        np.testing.assert_allclose(mats[0], np.eye(2, 3), atol=1e-12)
        assert np.allclose(mats[:, :, :2] @ mats[:, :, :2].transpose(0, 2, 1),
                           np.eye(2))


def test_port_never_imports_jax():
    """The port's whole CPU path runs in a fresh interpreter without JAX
    (or any module of the JAX package) ever being imported."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from astrophotography_tpu_torch.models import (
            PipelineConfig, calibrate_register_stack,
            calibrate_register_stack_lean)
        rng = np.random.default_rng(0)
        h, w = 128, 512
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.full((h, w), 300.0)
        for x0, y0 in rng.uniform(30, 100, (12, 2)) * [4.2, 0.9]:
            img += 3e4 * np.exp(-0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2) / 1.6)
        frames = np.stack([np.roll(img, (d, d), (0, 1)) for d in (0, 1, 2)])
        frames += rng.normal(0, 4, frames.shape)
        raw = torch.from_numpy(np.clip(frames, 0, 65535).astype(np.uint16))
        cfg = PipelineConfig(max_stars=4, match_k=4, detect_fast=True,
                             detect_bin_rows=True, detect_topk="tile",
                             detect_impl="fused", centroid="kernel",
                             fused_tile=(32, 256), warp_span=8)
        out, diag = calibrate_register_stack_lean(raw, config=cfg)
        assert out.shape == (h, w) and bool(torch.isfinite(out).all())
        out, diag = calibrate_register_stack(raw, config=PipelineConfig(
            max_stars=4, match_k=4, n_bands=2, combine_impl="pallas",
            noise_center="median"))
        assert out.shape == (h, w) and bool(torch.isfinite(out).all())
        import importlib
        import pkgutil
        import astrophotography_tpu_torch as port
        for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(mod.name)
        from astrophotography_tpu_torch import ops, parallel
        for name in ("badpix", "background", "composite", "cosmic",
                     "imarith", "photometry", "psf"):
            assert hasattr(ops, name), name
        assert callable(parallel.banded_warp_combine)
        # the multi-device layer: ranks spawned from here import no JAX
        from astrophotography_tpu_torch.parallel import launch
        from tests.torch_parallel_ranks import no_jax_rank
        fr = torch.from_numpy(frames[:2, :64, :64].astype(np.float32))
        ranks = launch.spawn(no_jax_rank, 2, device="cpu", transport="gloo",
                             args=(fr, torch.eye(2, 3).repeat(2, 1, 1)))
        assert ranks == [[], []], ranks
        import chip_smoke
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "astrophotography_tpu"
                     or m.startswith("astrophotography_tpu."))
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


def test_port_imports_without_optional_packages():
    """Every sub-package of the port and every tool imports in a fresh
    interpreter in which ``yaml``, ``imageio``, ``matplotlib`` and
    ``rawpy`` cannot be imported: they are needed only by the functions
    that parse or write a YAML file, write a graphics format other than
    PNG, plot, or read a camera's own RAW format.  The FITS / DNG / PNG
    path and a source list then run end to end."""
    code = textwrap.dedent("""
        import sys
        for name in ("yaml", "imageio", "imageio.v3", "matplotlib", "rawpy"):
            sys.modules[name] = None
        import importlib
        from astrophotography_tpu_torch.__main__ import _TOOLS
        for mod in ("", ".io", ".core", ".api", ".ops", ".models",
                    ".parallel", ".utils", ".synth", ".wcs",
                    ".wcs.astrometry", ".graft_entry", ".cli.ap_stack"):
            importlib.import_module("astrophotography_tpu_torch" + mod)
        for tool in _TOOLS:
            importlib.import_module("astrophotography_tpu_torch.cli." + tool)
        import os, tempfile
        import numpy as np
        from astrophotography_tpu_torch import synth
        from astrophotography_tpu_torch.cli.dksraw import main
        from astrophotography_tpu_torch.io.raw import write_dng
        from astrophotography_tpu_torch.io.fits import read_image
        with tempfile.TemporaryDirectory() as tmp:
            scene = synth.make_rgb_scene((16, 24), seed=1)
            dng = os.path.join(tmp, "a.dng")
            write_dng(dng, synth.mosaic_from_rgb(scene), compression=7)
            for out in ("a.fits", "a.png"):
                assert main(["grey", dng, "-o", os.path.join(tmp, out),
                             "--device", "cpu", "-l", "ERROR"]) == 0
            assert read_image(os.path.join(tmp, "a.fits"))[0].shape == (16, 24)
            # a format that needs imageio fails as an error of that call
            assert main(["grey", dng, "-o", os.path.join(tmp, "a.tiff"),
                         "--device", "cpu", "-l", "CRITICAL"]) == 1
            # the star finder writes its source list without yaml; its
            # quality report (YAML) fails as an error of that call
            from astrophotography_tpu_torch.core import StarFinder
            from astrophotography_tpu_torch.io.fits import write_image
            img = np.full((64, 64), 100.0, np.float32)
            img[30:33, 30:33] += 5000.0
            write_image(os.path.join(tmp, "s.fits"), img)
            finder = StarFinder(os.path.join(tmp, "s.fits"), device="cpu")
            finder.write_source_list(os.path.join(tmp, "src.fits"))
            try:
                finder.write_quality_report(os.path.join(tmp, "q.yml"))
                raise AssertionError("yaml was importable")
            except ImportError:
                pass
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "astrophotography_tpu"
                     or m.startswith("astrophotography_tpu."))
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")
