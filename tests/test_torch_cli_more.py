"""Port parity: the file-level tools of the reduction path, each run on
the same files and argv as its JAX twin (the port's with ``--device
cpu``): ``ap_find_stars``, ``ap_astrometry`` (the network-free ``--ref``
solve), ``ap_fix_cosmic_rays``, ``ap_imarith``, ``ap_composite``,
``ap_measure_background``, ``ap_add_metadata``, ``ap_quality_summary``
and ``ap_tidy_files``; and the surface of every port tool against the
JAX tool's.

Exit codes are equal.  Outputs agree within the tolerance of the op
behind each tool: the source list as ``tests/test_torch_star_finder.py``
holds it; the local WCS solve within 1e-3 px (each package registers in
float32); ``lacosmic`` 1e-4 relative away from at most two mask pixels
(``tests/test_torch_engines.py``); ``imarith`` exactly; the composite
within one count; ``background2d`` 1e-5 relative; headers, CSV bytes and
renames exactly.
"""

import argparse
import importlib
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

from astrophotography_tpu import synth
from astrophotography_tpu.io.fits import Header, open_fits, read_image, write_image
from astrophotography_tpu.wcs import TanWCS

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
QUIET = ["-l", "ERROR"]
SHAPE = (128, 160)
WCS = TanWCS((83.8, -5.4), (80.5, 64.5),
             np.array([[-2.5e-4, 1.0e-6], [1.2e-6, 2.5e-4]]))
HOST_ONLY = ("ap_add_metadata", "ap_quality_summary", "ap_tidy_files")
NEW_TOOLS = ("ap_find_stars", "ap_astrometry", "ap_fix_cosmic_rays",
             "ap_imarith", "ap_composite", "ap_measure_background",
             "ap_add_metadata", "ap_quality_summary", "ap_tidy_files",
             "ap_stack", "ap_reduce")


def _tools(name):
    return (importlib.import_module(f"astrophotography_tpu.cli.{name}"),
            importlib.import_module(f"astrophotography_tpu_torch.cli.{name}"))


def _run(name, argv_j, argv_t=None):
    """Exit codes of the JAX tool and the port tool (with --device cpu
    unless it is host-only)."""
    j, t = _tools(name)
    extra = [] if name in HOST_ONLY else CPU
    return (j.main(argv_j + QUIET),
            t.main((argv_j if argv_t is None else argv_t) + QUIET + extra))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two dithered starfield frames (the first carries a TAN WCS) with
    the header keys the finder and the tools read."""
    root = tmp_path_factory.mktemp("cli")
    img, truth = synth.make_starfield(
        SHAPE, n_stars=16, fwhm=3.2, background=300.0, read_noise=5.0,
        flux_range=(20000.0, 80000.0), seed=7, min_sep=16.0)
    out = {"root": root, "truth": truth}
    for i, (dx, dy) in enumerate(((0.0, 0.0), (2.25, -1.5))):
        frame = np.roll(img, (int(dy), int(dx)), axis=(0, 1)) if i else img
        hdr = Header()
        for k, v in dict(EXPTIME=60.0, GAIN=1.5, OBJECT="Field",
                         TELESCOP="T05", FILTER="V", FOCALLEN=450.0,
                         XPIXSZ=5.4, YPIXSZ=5.4, RA="05:35:12",
                         DEC="-05:24:00").items():
            hdr[k] = v
        if i == 0:
            WCS.to_header(hdr)
        path = str(root / f"frame{i}.fits")
        write_image(path, frame.astype(np.float32), hdr)
        out[f"frame{i}"] = path
    return out


@pytest.mark.parametrize("extra", [[], ["--nofwhm", "--max_sources", "8"]],
                         ids=["default", "nofwhm"])
def test_ap_find_stars(files, tmp_path, extra):
    outs = {}
    for tag in ("j", "t"):
        outs[tag] = [str(tmp_path / f"{tag}{s}") for s in
                     ("src.fits", "q.yml", "r.reg")]
    argv = lambda o: [files["frame0"], o[0], "--quality_report", o[1],
                      "--ds9", o[2]] + extra
    assert _run("ap_find_stars", argv(outs["j"]), argv(outs["t"])) == (0, 0)
    sj, st = open_fits(outs["j"][0]), open_fits(outs["t"][0])
    assert [h.name for h in st] == [h.name for h in sj]
    assert list(st[0].header) == list(sj[0].header)
    for col in ("X", "Y"):
        np.testing.assert_allclose(st["AP_XYPOS"][col], sj["AP_XYPOS"][col],
                                   rtol=0, atol=2e-3)
    np.testing.assert_allclose(st["AP_L1MAG"]["adu_per_sec"],
                               sj["AP_L1MAG"]["adu_per_sec"], rtol=1e-5)
    if not extra:
        assert st[0].header["AP_FWHM"] == pytest.approx(
            sj[0].header["AP_FWHM"], rel=1e-3)
    with open(outs["j"][1]) as a, open(outs["t"][1]) as b:
        qj, qt = yaml.safe_load(a), yaml.safe_load(b)
    assert list(qt) == list(qj) and qt["image_info"] == qj["image_info"]
    with open(outs["j"][2]) as a, open(outs["t"][2]) as b:
        assert len(a.read().splitlines()) == len(b.read().splitlines())
    # a missing input fails in both
    assert _run("ap_find_stars", [str(tmp_path / "none.fits"),
                                  outs["j"][0]]) == (1, 1)


def test_ap_astrometry_ref_solve(files, tmp_path, monkeypatch):
    """``--ref``: the second frame registered against the WCS-bearing
    first; without ``--ref`` or a key both tools exit 1."""
    monkeypatch.delenv("ASTROMETRY_API_KEY", raising=False)
    j_find, _ = _tools("ap_find_stars")
    src = str(tmp_path / "src1.fits")
    ref_src = str(tmp_path / "src0.fits")
    assert j_find.main([files["frame1"], src, "--nofwhm"] + QUIET) == 0
    assert j_find.main([files["frame0"], ref_src, "--nofwhm"] + QUIET) == 0
    outs = {}
    for tag in ("j", "t"):
        shutil.copy(src, tmp_path / f"{tag}src1.fits")
        outs[tag] = str(tmp_path / f"{tag}nav.fits")
    argv = lambda tag: [files["frame1"], str(tmp_path / f"{tag}src1.fits"),
                        outs[tag], "--ref", files["frame0"],
                        "--ref_srclist", ref_src]
    assert _run("ap_astrometry", argv("j"), argv("t")) == (0, 0)
    hj, ht = open_fits(outs["j"])[0], open_fits(outs["t"])[0]
    np.testing.assert_array_equal(ht.data, hj.data)
    wj, wt = TanWCS.from_header(hj.header), TanWCS.from_header(ht.header)
    gx, gy = np.meshgrid(np.linspace(1, SHAPE[1], 7),
                         np.linspace(1, SHAPE[0], 7))
    px, py = wt.world2pix(*wj.pix2world(gx.ravel(), gy.ravel()))
    np.testing.assert_allclose(px, gx.ravel(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(py, gy.ravel(), rtol=0, atol=1e-3)
    for tag in ("j", "t"):
        assert "ra" in open_fits(str(tmp_path / f"{tag}src1.fits"))[
            "AP_XYPOS"].columns
    # the planted shift comes back through the solved WCS
    ra, dec = WCS.pix2world(40.0, 30.0)
    x, y = wt.world2pix(ra, dec)
    assert abs(float(x) - 42.0) < 0.1 and abs(float(y) - 29.0) < 0.1
    assert _run("ap_astrometry", [files["frame1"], src,
                                  str(tmp_path / "o.fits")]) == (1, 1)
    # the port's --ref solve detects on the reference itself without
    # --ref_srclist, as the JAX tool does
    j, t = _tools("ap_astrometry")
    assert t.main(argv("t")[:5] + QUIET + CPU) == 0


def test_ap_fix_cosmic_rays(files, tmp_path):
    img, hdr = read_image(files["frame0"])
    rng = np.random.default_rng(5)
    ys, xs = rng.integers(6, SHAPE[0] - 6, 10), rng.integers(6, SHAPE[1] - 6,
                                                             10)
    img[ys, xs] += 9000.0
    src = str(tmp_path / "cr.fits")
    write_image(src, img, hdr)
    outs = {t: [str(tmp_path / f"{t}{s}.fits") for s in ("out", "diff",
                                                          "mask")]
            for t in ("j", "t")}
    argv = lambda o: [src, o[0], "--crdiffim", o[1], "--crmaskim", o[2],
                      "--niter", "3"]
    assert _run("ap_fix_cosmic_rays", argv(outs["j"]),
                argv(outs["t"])) == (0, 0)
    (gj, hj), (gt, ht) = (read_image(outs[t][0]) for t in ("j", "t"))
    assert abs(ht["CR_NPIX"] - hj["CR_NPIX"]) <= 2
    close = np.abs(gt - gj) <= 1e-4 * np.abs(gj) + 1e-4
    assert (~close).sum() <= 2 * 25
    mj = read_image(outs["j"][2], as_float32=False)[0]
    mt = read_image(outs["t"][2], as_float32=False)[0]
    assert mt.dtype == mj.dtype == np.uint8 and (mt != mj).sum() <= 2
    assert (gt[ys, xs] < 3000).mean() >= 0.75
    dj, dt = (read_image(outs[t][1])[0] for t in ("j", "t"))
    assert (np.abs(dt - dj) > 1e-4 * np.abs(dj) + 1e-3).sum() <= 2 * 25


@pytest.mark.parametrize("op,value,extra", [
    ("ADD", "12.5", []), ("mul", "0.5", ["--units", "e-"]),
    ("SUB", "frame1", []), ("DIV", "frame1", []), ("div", "0", [])])
def test_ap_imarith(files, tmp_path, op, value, extra):
    value = files.get(value, value)
    outs = [str(tmp_path / f"{t}.fits") for t in ("j", "t")]
    assert _run("ap_imarith", [files["frame0"], op, value, outs[0]] + extra,
                [files["frame0"], op, value, outs[1]] + extra) == (0, 0)
    (gj, hj), (gt, ht) = (read_image(o, as_float32=False) for o in outs)
    assert gt.dtype == gj.dtype
    np.testing.assert_array_equal(gt, gj)
    assert list(ht.items()) == list(hj.items())


def test_ap_imarith_int16_and_mismatch(files, tmp_path):
    path = str(tmp_path / "i16.fits")
    write_image(path, (np.arange(20 * 30).reshape(20, 30) - 300)
                .astype(np.int16), Header())
    outs = [str(tmp_path / f"{t}.fits") for t in ("j", "t")]
    assert _run("ap_imarith", [path, "MUL", "3", outs[0]],
                [path, "MUL", "3", outs[1]]) == (0, 0)
    gj, gt = (read_image(o, as_float32=False)[0] for o in outs)
    assert gt.dtype == gj.dtype == np.int16
    np.testing.assert_array_equal(gt, gj)
    assert _run("ap_imarith", [path, "ADD", files["frame0"],
                               outs[0]]) == (1, 1)


@pytest.mark.parametrize("extra,suffix", [([], "png"),
                                          (["--bits", "16", "--mode",
                                            "gamma"], "png")])
def test_ap_composite(files, tmp_path, extra, suffix):
    chans = [files["frame0"], files["frame1"], files["frame0"]]
    outs = [str(tmp_path / f"{t}.{suffix}") for t in ("j", "t")]
    assert _run("ap_composite", chans + [outs[0]] + extra,
                chans + [outs[1]] + extra) == (0, 0)
    iio = pytest.importorskip("imageio.v3")
    gj, gt = (iio.imread(o) for o in outs)
    assert gt.dtype == gj.dtype and gt.shape == gj.shape == SHAPE + (3,)
    assert np.abs(gt.astype(np.int64) - gj.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("extra", [
    ["--nbg_cols", "4", "--nbg_rows", "4", "--min_bgwidth", "16",
     "--min_bgheight", "16"],
    ["--nbg_cols", "4", "--nbg_rows", "4", "--min_bgwidth", "16",
     "--min_bgheight", "16", "--bg_upsample", "bilinear", "--srclist",
     "SRC"],
], ids=["spline", "srclist"])
def test_ap_measure_background(files, tmp_path, extra):
    if "SRC" in extra:
        src = str(tmp_path / "src.fits")
        j_find, _ = _tools("ap_find_stars")
        assert j_find.main([files["frame0"], src] + QUIET) == 0
        extra = [src if e == "SRC" else e for e in extra]
    outs = {t: [str(tmp_path / f"{t}{s}.fits") for s in ("bg", "sub")]
            for t in ("j", "t")}
    argv = lambda o: [files["frame0"], o[0], "--subtract", o[1]] + extra
    assert _run("ap_measure_background", argv(outs["j"]),
                argv(outs["t"])) == (0, 0)
    for k in range(2):
        (gj, hj), (gt, ht) = (read_image(outs[t][k]) for t in ("j", "t"))
        np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-3)
        assert list(ht) == list(hj)


def test_ap_add_metadata(tmp_path):
    name = ("raw-T05-davestrickland-NGC_6888-20200716-231744-Ha-BIN1-E-"
            "180-001.fit")
    paths = []
    for tag in ("j", "t"):
        (tmp_path / tag).mkdir()
        path = str(tmp_path / tag / name)
        hdr = Header()
        hdr["DATE-OBS"] = "2020-07-17T05:17:44"
        write_image(path, np.zeros((4, 4), np.float32), hdr)
        paths.append(path)
    assert _run("ap_add_metadata", [paths[0]], [paths[1]]) == (0, 0)
    hj, ht = (open_fits(p)[0].header for p in paths)
    assert list(ht.items()) == list(hj.items())
    assert ht["AIRMASS"] > 1.0
    assert _run("ap_add_metadata", [paths[0], "--mode", "yamlkeyval"],
                [paths[1], "--mode", "yamlkeyval"]) == (1, 1)


def test_ap_quality_summary(tmp_path):
    for i, filt in enumerate(("V", "R", "V")):
        with open(tmp_path / f"qual_{i}.yml", "w") as fh:
            yaml.dump({"image_info": {"object": "M42", "telescope": "T05",
                                      "filter": filt},
                       "psf_info": {"fwhm_x": {"fwhm_val_pix": 2.5 + i}}},
                      fh)
    outs = [str(tmp_path / f"{t}.csv") for t in ("j", "t")]
    assert _run("ap_quality_summary", [str(tmp_path), outs[0]],
                [str(tmp_path), outs[1]]) == (0, 0)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()
    assert _run("ap_quality_summary", [str(tmp_path), outs[0], "--prefix",
                                       "nothing"]) == (1, 1)


@pytest.mark.parametrize("extra", [[], ["--dry_run"], ["--fix_permissions"]])
def test_ap_tidy_files(tmp_path, extra):
    trees = []
    for tag in ("j", "t"):
        root = tmp_path / tag
        (root / "night one").mkdir(parents=True)
        (root / "night one" / "light 1.fits").write_bytes(b"x")
        (root / "flat 2.fits").write_bytes(b"y")
        (root / "flat_2.fits").write_bytes(b"taken")
        trees.append(root)
    assert _run("ap_tidy_files", [str(trees[0])] + extra,
                [str(trees[1])] + extra) == (0, 0)

    def listing(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, ds, fs in os.walk(root) for f in fs + ds)

    assert listing(trees[1]) == listing(trees[0])


def _actions(name):
    """Every option of a tool's parser: (flags, dest, default, choices,
    nargs, required), help text left out."""
    captured = {}

    def capture(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)

    mp = pytest.MonkeyPatch()
    mp.setattr(argparse.ArgumentParser, "parse_args", capture)
    try:
        with pytest.raises(SystemExit):
            importlib.import_module(name).parse([])
    finally:
        mp.undo()
    return [(tuple(a.option_strings), a.dest, a.default,
             tuple(a.choices) if a.choices else None, a.nargs, a.required)
            for a in captured["parser"]._actions]


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_cli_surface_equals_jax_plus_device(tool):
    """The port tool's options are the JAX tool's, plus ``--device``
    (default cuda) where it computes; ``--help`` exits 0 and no
    arguments is a usage error."""
    want = _actions(f"astrophotography_tpu.cli.{tool}")
    got = _actions(f"astrophotography_tpu_torch.cli.{tool}")
    device = (("--device",), "device", "cuda", None, None, False)
    if tool not in HOST_ONLY:
        assert device in got
        got = [a for a in got if a != device]
    assert got == want
    _j, t = _tools(tool)
    with pytest.raises(SystemExit) as exc:
        t.main(["--help"])
    assert exc.value.code == 0
    with pytest.raises(SystemExit) as exc:
        t.main([])
    assert exc.value.code == 2


def test_main_lists_every_jax_tool(capsys):
    from astrophotography_tpu import __main__ as jmain
    from astrophotography_tpu_torch import __main__ as tmain

    assert tmain._TOOLS == jmain._TOOLS
    assert tmain.main() == 1
    text = capsys.readouterr().out
    for tool in tmain._TOOLS:
        importlib.import_module(f"astrophotography_tpu_torch.cli.{tool}")
        assert f"astrophotography_tpu_torch.cli.{tool}" in text


def test_tools_fail_without_a_card(files, tmp_path):
    """The default device is the card; without one a tool exits 1 and
    writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = str(tmp_path / "o.fits")
    _j, t = _tools("ap_imarith")
    assert t.main([files["frame0"], "ADD", "1", out, "-l", "CRITICAL"]) == 1
    _j, t = _tools("ap_find_stars")
    assert t.main([files["frame0"], out, "-l", "CRITICAL"]) == 1
    assert not os.path.exists(out)
