"""Port parity: ``core/star_finder.StarFinder`` against the JAX package's
on the same 256 x 256 FITS starfield (29 stars, one saturated, with the
RA / DEC / FOCALLEN / XPIXSZ / YPIXSZ keys the header keywords are built
from).

Tolerances: background median and std within rtol 1e-6; equal detection
and photometry counts; x / y within 2e-3 px, ``adu_per_sec`` within rtol
1e-5; the FWHM medians within rtol 1e-3; the same source-list HDUs,
columns and primary keywords, and the same quality-YAML keys.  The port's
float32 sums and sorts round in another order than XLA's, which is all
these bounds allow for.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from astrophotography_tpu import synth
from astrophotography_tpu.core import star_finder as jsf
from astrophotography_tpu.io.fits import Header, open_fits, write_image
from astrophotography_tpu_torch.core import star_finder as tsf

torch.set_num_threads(1)

KEYS = dict(EXPTIME=60.0, OBJECT="SynthField", TELESCOP="T05", FILTER="V",
            FOCALLEN=450.0, XPIXSZ=5.4, YPIXSZ=5.4, RA="12:30:45",
            DEC="-10:15:30")
KEYS["DATE-OBS"] = "2026-08-16T01:00:00"
SAT_XY = (200.0, 60.0)


@pytest.fixture(scope="module")
def field(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sf")
    img, truth = synth.make_starfield(
        (256, 256), n_stars=28, fwhm=3.4, background=250.0,
        read_noise=6.0, flux_range=(20000.0, 90000.0), seed=31, min_sep=18.0)
    # one saturated star: a flat-topped core at the 16-bit ceiling
    img = img + synth.gaussian_star((256, 256), *SAT_XY, 4.0e6, 3.4)
    img = np.minimum(img, 65535.0).astype(np.float32)
    hdr = Header()
    for k, v in KEYS.items():
        hdr[k] = v
    path = str(tmp / "field.fits")
    write_image(path, img, hdr)
    return path, truth, tmp


def _finders(path, **kw):
    return (jsf.StarFinder(path, **kw),
            tsf.StarFinder(path, device="cpu", **kw))


@pytest.fixture(scope="module")
def measured(field):
    path, _truth, _tmp = field
    j, t = _finders(path)
    return j, t, j.measure_fwhm(), t.measure_fwhm()


def test_background_and_counts(measured):
    j, t, _fj, _ft = measured
    assert t.bg_median == pytest.approx(j.bg_median, rel=1e-6)
    assert t.bg_stddev == pytest.approx(j.bg_stddev, rel=1e-6)
    assert t._nsrcs_detected == j._nsrcs_detected >= 28
    assert t._nsrcs_saturated == j._nsrcs_saturated >= 1
    assert t._nsrcs_photom == j._nsrcs_photom


def test_photometry_table(measured, field):
    j, t, _fj, _ft = measured
    assert list(t.table) == list(j.table)
    for k in ("xcenter", "ycenter"):
        np.testing.assert_allclose(t.table[k], j.table[k], rtol=0, atol=2e-3)
    np.testing.assert_allclose(t.table["adu_per_sec"], j.table["adu_per_sec"],
                               rtol=1e-5)
    np.testing.assert_array_equal(t.table["id"], j.table["id"])
    np.testing.assert_array_equal(t.table["psbl_sat"], j.table["psbl_sat"])
    for k in ("aperture_sum", "bgmed_per_pix", "magnitude", "peak_adu"):
        np.testing.assert_allclose(t.table[k], j.table[k], rtol=1e-5,
                                   atol=1e-3)
    # the saturated star is masked out of the detection
    _path, truth, _tmp = field
    d = np.hypot(t.table["xcenter"] - SAT_XY[0],
                 t.table["ycenter"] - SAT_XY[1])
    assert d.min() > 8.0
    found = sum(np.hypot(t.table["xcenter"] - x,
                         t.table["ycenter"] - y).min() < 0.5
                for x, y in zip(truth["x"], truth["y"]))
    assert found >= 0.9 * len(truth["x"])


def test_fwhm(measured):
    j, t, fj, ft = measured
    assert ft[2] == fj[2] and t._nsrcs_fitted == j._nsrcs_fitted > 0
    for got, want in ((ft, fj), (t._fwhm_x, j._fwhm_x),
                      (t._fwhm_y, j._fwhm_y)):
        assert got[0] == pytest.approx(want[0], rel=1e-3)
        assert got[0] == pytest.approx(3.4, rel=0.1)
    assert ft[1] == pytest.approx(fj[1], rel=0.05, abs=2e-3)
    for k in ("x0", "y0", "fwhm_x", "fwhm_y", "amplitude", "background"):
        got = getattr(t._psf, k)[t._psf.valid]
        want = np.asarray(getattr(j._psf, k))[np.asarray(j._psf.valid)]
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_source_list_and_quality_report(measured, tmp_path):
    j, t, _fj, _ft = measured
    out = {}
    for name, f in (("jax", j), ("port", t)):
        src = str(tmp_path / f"src_{name}.fits")
        qual = str(tmp_path / f"qual_{name}.yml")
        reg = str(tmp_path / f"{name}.reg")
        f.write_source_list(src)
        f.write_quality_report(qual)
        f.write_ds9_region_file(reg)
        with open(qual) as fh:
            report = yaml.safe_load(fh)
        with open(reg) as fh:
            out[name] = (open_fits(src), report, fh.read().splitlines())
    (hj, rj, gj), (ht, rt, gt) = out["jax"], out["port"]
    assert [h.name for h in ht] == [h.name for h in hj] == \
        ["", "AP_XYPOS", "AP_L1MAG", "AP_L1PSF"]
    for a, b in zip(ht[1:], hj[1:]):
        assert list(a.columns) == list(b.columns)
        for col in a.columns:
            assert a[col].dtype == b[col].dtype, col
            assert a[col].shape == b[col].shape, col
    assert list(ht[0].header) == list(hj[0].header)
    for k in ("IMG_FILE", "IMG_COLS", "AP_NDET", "AP_NPHOT", "AP_NFIT",
              "APRX_RA", "APRX_DEC", "APRX_FOV", "APRX_XPS", "RA", "DEC"):
        assert ht[0].header[k] == hj[0].header[k], k
    assert ht[0].header["AP_FWHM"] == pytest.approx(hj[0].header["AP_FWHM"],
                                                    rel=1e-3)

    def keys(d, prefix=""):
        out = []
        for k, v in d.items():
            out.append(prefix + k)
            if isinstance(v, dict):
                out += keys(v, prefix + k + ".")
        return out

    assert keys(rt) == keys(rj)
    assert rt["image_info"] == rj["image_info"]
    assert rt["source_info"]["num_detected"] == \
        rj["source_info"]["num_detected"]
    assert rt["saturation_info"] == rj["saturation_info"]
    assert gt[:3] == gj[:3] and len(gt) == len(gj)


def test_second_pass_trim_and_nosatmask(field):
    """ap_find_stars' refined pass at the fitted FWHM, ``max_sources``
    trimming and ``nosatmask``."""
    path, _truth, _tmp = field
    j, t = _finders(path, max_sources=10, nosatmask=True)
    assert t._mask is None and j._mask is None
    fwhm = j.measure_fwhm()[0]
    t.measure_fwhm()
    for f in (j, t):
        f.source_search(fwhm, 7.0)
        f.aperture_photometry()
    assert t._nsrcs_detected == j._nsrcs_detected
    assert len(t.table["id"]) == len(j.table["id"]) == 10
    np.testing.assert_allclose(t.table["xcenter"], j.table["xcenter"],
                               rtol=0, atol=2e-3)


def test_no_detections(tmp_path):
    """A blank frame: no sources, NaN FWHM written as blank cards, in
    both packages."""
    rng = np.random.default_rng(0)
    path = str(tmp_path / "blank.fits")
    write_image(path, rng.normal(100.0, 3.0, (64, 64)).astype(np.float32),
                Header())
    j, t = _finders(path)
    assert t._nsrcs_detected == j._nsrcs_detected == 0
    fj, ft = j.measure_fwhm(), t.measure_fwhm()
    assert np.isnan(ft[0]) and np.isnan(fj[0]) and ft[2] == fj[2] == 0
    for name, f in (("jax", j), ("port", t)):
        f.write_source_list(str(tmp_path / f"{name}.fits"))
    got = open_fits(str(tmp_path / "port.fits"))
    want = open_fits(str(tmp_path / "jax.fits"))
    assert got[0].header.get("AP_FWHM") is want[0].header.get("AP_FWHM") \
        is None
    assert [h.name for h in got] == [h.name for h in want]


def test_helpers_equal():
    rng = np.random.default_rng(5)
    x, y = rng.uniform(0, 200, 40), rng.uniform(0, 100, 40)
    b = rng.uniform(1, 10, 40)
    np.testing.assert_array_equal(
        tsf.StarFinder.select_fit_candidates(x, y, b, (100, 200), 12),
        jsf.StarFinder.select_fit_candidates(x, y, b, (100, 200), 12))
    for text, hours in (("12:30:45", True), ("-10:15:30", False),
                        ("+5.5", False), ("3:04", True)):
        assert tsf._parse_angle(text, hours) == jsf._parse_angle(text, hours)
    v = {"a": np.float32(1.5), "b": [np.int64(3), np.bool_(True)]}
    assert tsf._plain(v) == jsf._plain(v)


def test_plots_write_png(measured, tmp_path):
    _j, t, _fj, _ft = measured
    pytest.importorskip("matplotlib")
    for fn, name in ((t.plot_image, "det.png"), (t.plot_fits, "fits.png")):
        fn(str(tmp_path / name))
        assert os.path.getsize(tmp_path / name) > 1000
