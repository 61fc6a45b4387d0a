"""Port parity: the batch reduction driver (``core/reduce.reduce_all``)
against the JAX package's, file to file, and the port's twin of the
repository's entry point (``graft_entry``).

The observing run is ``tests/test_reduce_composite.py``'s 128^2 dataset
(masters, three dithered 60 s lights of one field in V) plus a second
filter group (R, three lights, two of 120 s, with a small field
rotation), and a planted TAN WCS on the first light of each group, so
the navigate stage anchors on it without a network.  Both packages reduce it with
``combine_impl`` 'xla', 'pallas' and 'fused' (the JAX package's K2 and
K3 in interpret mode).

Tolerances: the same produced file names; calibrated frames equal;
stacks within the unfused parity rule (``tests/test_torch_unfused_
pipeline.py``: median |diff| < 1e-3, > 1 ADU on under 0.5 % of the
pixels); weight maps within 1e-5; on a grid of pixels the anchor's nav
WCS within 1e-6 px and the registered frames' within the registration
tolerance of the unfused parity tests (1e-3 px: each package solves its
own similarity in float32; given the same similarity
``solve_from_reference`` agrees to 1e-6 px, tests/test_torch_wcs.py);
equal stack headers but for the HISTORY line that carries
the run's seconds.  A second run (noclean) rewrites nothing.
"""

import functools
import os
import shutil

import numpy as np
import pytest
import torch

from astrophotography_tpu import synth
from astrophotography_tpu.core import reduce as jred
from astrophotography_tpu.io.fits import Header, open_fits, read_image, write_image
from astrophotography_tpu.wcs import TanWCS
from astrophotography_tpu_torch.core import reduce as tred
from astrophotography_tpu_torch.utils import timing as ttiming

torch.set_num_threads(1)

SHAPE = (128, 128)
ENGINES = ("xla", "pallas", "fused")
#: registration agreement (px), as tests/test_torch_unfused_pipeline.py
T_TOL = 1e-3
WCS = TanWCS((83.8, -5.4), (64.5, 64.5),
             np.array([[-2.5e-4, 1.0e-6], [1.2e-6, 2.5e-4]]))


def _make_dataset(root):
    """tests/test_reduce_composite.py's run (same draws), a second group
    in R, and a planted WCS on the first light of each group."""
    rng = np.random.default_rng(50)
    caldir, datadir = root / "cal", root / "data"
    caldir.mkdir()
    datadir.mkdir()
    bias = rng.normal(300.0, 2.0, SHAPE).astype(np.float32)
    hdr = Header()
    hdr["IMAGETYP"] = "MASTER BIAS"
    write_image(str(caldir / "master_bias.fits"), bias, hdr)
    dark = bias + 60.0 * 0.5
    dhdr = Header()
    dhdr["IMAGETYP"] = "MASTER DARK"
    dhdr["EXPTIME"] = 60.0
    write_image(str(caldir / "master_dark.fits"), dark.astype(np.float32),
                dhdr)
    base_x = rng.uniform(20, 108, 10)
    base_y = rng.uniform(20, 108, 10)
    flux = rng.uniform(30000, 80000, 10)
    for filt in ("V", "R"):
        for i in range(3):
            dx, dy = (rng.uniform(-3, 3, 2) if i else (0.0, 0.0))
            theta = np.deg2rad(0.3 * i) if filt == "R" else 0.0
            exptime = 120.0 if (filt == "R" and i) else 60.0
            c, s = np.cos(theta), np.sin(theta)
            xs = c * (base_x - 64) - s * (base_y - 64) + 64 + dx
            ys = s * (base_x - 64) + c * (base_y - 64) + 64 + dy
            img = np.full(SHAPE, 150.0)
            for x, y, f in zip(xs, ys, flux):
                img += synth.gaussian_star(SHAPE, x, y, f * exptime / 60.0,
                                           3.0)
            img = rng.poisson(img).astype(np.float32)
            img += bias + 30.0 * exptime / 60.0
            lhdr = Header()
            lhdr["IMAGETYP"] = "LIGHT"
            lhdr["EXPTIME"] = exptime
            lhdr["OBJECT"] = "TestField"
            lhdr["TELESCOP"] = "T05"
            lhdr["FILTER"] = filt
            lhdr["DATE-OBS"] = f"2026-08-01T0{i}:00:00"
            if i == 0:
                WCS.to_header(lhdr)
            write_image(str(datadir / f"light{filt}{i:02d}.fits"), img, lhdr)
    return str(datadir), str(caldir)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("reduce")
    return root, _make_dataset(root)


@functools.lru_cache(maxsize=None)
def _jax_run(root, engine):
    """The JAX package's run of ``engine``, once per module."""
    datadir, caldir = root / "data", root / "cal"
    out = str(root / f"jax-{engine}")
    produced = jred.reduce_all(str(datadir), str(caldir), out,
                               jred.ReduceConfig(combine_impl=engine,
                                                 astrometry=True))
    return out, produced


def _rel(produced, out):
    return {k: [os.path.relpath(p, out) for p in v]
            for k, v in produced.items()}


@pytest.mark.parametrize("engine", ENGINES)
def test_reduce_all_matches_jax(dataset, engine, tmp_path):
    root, (datadir, caldir) = dataset
    jout, jprod = _jax_run(root, engine)
    tout = str(tmp_path / "port")
    tprod = tred.reduce_all(datadir, caldir, tout,
                            tred.ReduceConfig(combine_impl=engine,
                                              astrometry=True),
                            device="cpu")
    assert _rel(tprod, tout) == _rel(jprod, jout)
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout))
    assert len(tprod["stacks"]) == 2 and len(tprod["navigated"]) == 6
    for name in sorted(os.listdir(jout)):
        got, want = os.path.join(tout, name), os.path.join(jout, name)
        if name.startswith("cal-"):
            np.testing.assert_array_equal(read_image(got)[0],
                                          read_image(want)[0])
        elif name.startswith("stack-"):
            g, gh = read_image(got)
            w, wh = read_image(want)
            diff = np.abs(g - w)
            assert np.median(diff) < 1e-3, name
            assert (diff > 1.0).mean() < 0.005, name
            assert (g != 0).mean() > 0.8
            skip = {"HISTORY"}
            assert [c for c in gh._cards if c[0] not in skip] == \
                [c for c in wh._cards if c[0] not in skip]
            assert gh["NSTACK"] == 3 and gh["ASTRSOLV"] is True
        elif name.startswith("weight-"):
            np.testing.assert_allclose(read_image(got)[0],
                                       read_image(want)[0], rtol=0,
                                       atol=1e-5)
        elif name.startswith("nav-"):
            tw = TanWCS.from_header(open_fits(got)[0].header)
            jw = TanWCS.from_header(open_fits(want)[0].header)
            gx, gy = np.meshgrid(np.linspace(1, 128, 9),
                                 np.linspace(1, 128, 9))
            ra, dec = jw.pix2world(gx.ravel(), gy.ravel())
            px, py = tw.world2pix(ra, dec)
            # the anchor keeps its own header WCS; the others come from
            # each package's own registration (tx / ty agree to T_TOL)
            tol = 1e-6 if name.endswith("00.fits") else T_TOL
            np.testing.assert_allclose(px, gx.ravel(), rtol=0, atol=tol)
            np.testing.assert_allclose(py, gy.ravel(), rtol=0, atol=tol)
            np.testing.assert_array_equal(read_image(got)[0],
                                          read_image(want)[0])
        elif name.startswith("src-"):
            g, w = open_fits(got), open_fits(want)
            assert [h.name for h in g] == [h.name for h in w]
            for col in ("X", "Y", "ra", "dec"):
                np.testing.assert_allclose(g["AP_XYPOS"][col],
                                           w["AP_XYPOS"][col], rtol=0,
                                           atol=2e-3 if col in "XY" else 1e-6)


def test_noclean_rerun_rewrites_nothing(dataset, tmp_path):
    """The second run skips every output (the same mtimes) and still
    lists them; ``--clean`` would recompute."""
    _root, (datadir, caldir) = dataset
    out = str(tmp_path / "port")
    cfg = tred.ReduceConfig(combine_impl="pallas", astrometry=True)
    first = tred.reduce_all(datadir, caldir, out, cfg, device="cpu")
    mtimes = {f: os.path.getmtime(os.path.join(out, f))
              for f in os.listdir(out)}
    second = tred.reduce_all(datadir, caldir, out, cfg, device="cpu")
    assert {f: os.path.getmtime(os.path.join(out, f))
            for f in os.listdir(out)} == mtimes
    assert {k: sorted(v) for k, v in second.items()} == \
        {k: sorted(v) for k, v in first.items()}


def test_stage_split_and_skybg(dataset, tmp_path, monkeypatch):
    """Every stage of the split is recorded (calibrate and quality per
    light, navigate per group, read / upload / register / combine /
    download / weight map / write per stack); with ``skybg`` the
    calibrated frames equal the JAX package's within float32 rounding."""
    _root, (datadir, caldir) = dataset
    timers = []

    class Recording(ttiming.StageTimer):
        def __init__(self):
            super().__init__()
            timers.append(self)

    monkeypatch.setattr(tred, "StageTimer", Recording)
    cfg = dict(skybg=True, stack=True, quality=False)
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    tred.reduce_all(datadir, caldir, tout,
                    tred.ReduceConfig(astrometry=False, **cfg), device="cpu")
    jred.reduce_all(datadir, caldir, jout,
                    jred.ReduceConfig(astrometry=False, **cfg))
    stages = [r["stage"].split(" ")[0] for r in timers[0].records]
    assert stages.count("calibrate") == 6
    for s in ("read", "upload", "register", "combine", "download",
              "weight", "write"):
        assert stages.count(s) == 2, s
    for name in sorted(os.listdir(jout)):
        if name.startswith("cal-"):
            np.testing.assert_allclose(read_image(os.path.join(tout, name))[0],
                                       read_image(os.path.join(jout, name))[0],
                                       rtol=1e-5, atol=1e-3)


def test_mixed_shapes_and_helpers(tmp_path):
    """A group whose frames differ in shape is skipped with an error,
    as in JAX; scan / group / find_masters agree."""
    data, cal = tmp_path / "data", tmp_path / "cal"
    data.mkdir()
    cal.mkdir()
    for i, shape in enumerate(((32, 32), (32, 48))):
        hdr = Header()
        for k, v in dict(OBJECT="X", TELESCOP="T05", FILTER="V",
                         EXPTIME=10.0).items():
            hdr[k] = v
        write_image(str(data / f"l{i}.fits"), np.ones(shape, np.float32), hdr)
    (data / "junk.fits").write_bytes(b"not a fits file")
    for name in ("master_flat_R.fits", "master_bias.fits"):
        write_image(str(cal / name), np.ones((32, 32), np.float32), Header())
    assert [vars(x) for x in tred.scan_lights(str(data))] == \
        [vars(x) for x in jred.scan_lights(str(data))]
    for filt in ("V", "R", None):
        assert tred.find_masters(str(cal), filt) == \
            jred.find_masters(str(cal), filt)
    cfg = dict(quality=False)
    got = tred.reduce_all(str(data), str(cal), str(tmp_path / "t"),
                          tred.ReduceConfig(**cfg), device="cpu")
    want = jred.reduce_all(str(data), str(cal), str(tmp_path / "j"),
                           jred.ReduceConfig(**cfg))
    assert _rel(got, str(tmp_path / "t")) == _rel(want, str(tmp_path / "j"))
    assert got["stacks"] == []
    shutil.rmtree(tmp_path / "t")
    with pytest.raises(RuntimeError):
        tred.reduce_all(str(cal / "none"), str(cal), str(tmp_path / "t"),
                        device="cpu")


def test_graft_entry_matches_jax():
    """``graft_entry.entry()`` against ``__graft_entry__.entry()``: the
    same example inputs, the stack within the unfused parity rule."""
    import __graft_entry__ as jentry
    from astrophotography_tpu_torch import graft_entry as tentry

    jfn, jargs = jentry.entry()
    tfn, targs = tentry.entry(device="cpu")
    for a, b in zip(targs, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = tfn(*targs).numpy()
    want = np.asarray(jfn(*jargs))
    assert got.shape == (128, 128) and np.isfinite(got).all()
    diff = np.abs(got - want)
    assert np.median(diff) < 1e-3 and (diff > 1.0).mean() < 0.005
