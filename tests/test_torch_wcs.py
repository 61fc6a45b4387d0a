"""Port parity: the host modules of the file-to-file path, both packages
on the same inputs.

``wcs/wcs`` (``TanWCS``), ``wcs/astrometry`` (hints, the mock-transport
solve, the wcs_file keys), ``core/metadata`` and ``core/quality`` are
host numpy / Python in both packages: every header card, array and CSV
byte is equal.  ``solve_from_reference`` maps its grid through each
package's own ``Similarity`` in float32 (JAX runs with x64 off), so it
agrees to 1e-9 deg on the sky and 1e-6 px in the fitted WCS.
"""

import json
import urllib.parse

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from astrophotography_tpu.core import metadata as jmd
from astrophotography_tpu.core import quality as jq
from astrophotography_tpu.io import fits as jfits
from astrophotography_tpu.ops.register import Similarity as JSim
from astrophotography_tpu.wcs import astrometry as jast
from astrophotography_tpu.wcs import wcs as jwcs
from astrophotography_tpu_torch.core import metadata as tmd
from astrophotography_tpu_torch.core import quality as tq
from astrophotography_tpu_torch.io import fits as tfits
from astrophotography_tpu_torch.ops.register import Similarity as TSim
from astrophotography_tpu_torch.wcs import astrometry as tast
from astrophotography_tpu_torch.wcs import wcs as twcs

torch.set_num_threads(1)

CD = np.array([[-1.5e-4, 1.0e-6], [1.1e-6, 1.5e-4]])
SIP_A = {(2, 0): 1e-7, (0, 2): -5e-8, (1, 1): 2e-8}
SIP_B = {(2, 0): -8e-8, (0, 2): 4e-8}


def _wcs(mod, with_sip):
    return mod.TanWCS((123.456, -45.678), (1024.0, 768.0), CD,
                      SIP_A if with_sip else None, SIP_B if with_sip else None)


def _cards(hdr):
    return [tuple(c) for c in hdr._cards]


def _same_cards(got, want):
    """Equal cards in equal order, values of equal type."""
    got, want = _cards(got), _cards(want)
    assert [c[0] for c in got] == [c[0] for c in want]
    for (k, v, c), (_, rv, rc) in zip(got, want):
        assert c == rc and type(v) is type(rv), k
        assert v == rv or (v != v and rv != rv), k


@pytest.mark.parametrize("with_sip", [False, True])
def test_tanwcs_transforms_bit_identical(with_sip):
    rng = np.random.default_rng(0)
    x = rng.uniform(1, 2048, 200)
    y = rng.uniform(1, 1536, 200)
    j, t = _wcs(jwcs, with_sip), _wcs(twcs, with_sip)
    ra_j, dec_j = j.pix2world(x, y)
    ra_t, dec_t = t.pix2world(x, y)
    np.testing.assert_array_equal(ra_t, ra_j)
    np.testing.assert_array_equal(dec_t, dec_j)
    for got, want in zip(t.world2pix(ra_j, dec_j), j.world2pix(ra_j, dec_j)):
        np.testing.assert_array_equal(got, want)
    assert t.pixel_scale_arcsec == j.pixel_scale_arcsec


@pytest.mark.parametrize("with_sip", [False, True])
def test_tanwcs_header_round_trip_bit_identical(with_sip):
    _same_cards(_wcs(twcs, with_sip).to_header(tfits.Header()),
                _wcs(jwcs, with_sip).to_header(jfits.Header()))
    hdr_t = _wcs(twcs, with_sip).to_header(tfits.Header())
    hdr_j = _wcs(jwcs, with_sip).to_header(jfits.Header())
    back_t = twcs.TanWCS.from_header(hdr_t)
    back_j = jwcs.TanWCS.from_header(hdr_j)
    assert back_t.crval == back_j.crval and back_t.crpix == back_j.crpix
    np.testing.assert_array_equal(back_t.cd, back_j.cd)
    assert back_t.sip_a == back_j.sip_a and back_t.sip_b == back_j.sip_b


def test_tanwcs_from_cdelt_header_bit_identical():
    keys = dict(CTYPE1="RA---TAN", CRVAL1=10.0, CRVAL2=41.0, CRPIX1=500.5,
                CRPIX2=400.0, CDELT1=-2.5e-4, CDELT2=2.5e-4, CROTA2=12.5)
    hj, ht = jfits.Header(), tfits.Header()
    for k, v in keys.items():
        hj[k] = v
        ht[k] = v
    np.testing.assert_array_equal(twcs.TanWCS.from_header(ht).cd,
                                  jwcs.TanWCS.from_header(hj).cd)


@pytest.mark.parametrize("sip_order", [0, 2, 3])
def test_tanwcs_fit_bit_identical(sip_order):
    truth = _wcs(jwcs, sip_order > 0)
    rng = np.random.default_rng(1)
    x = rng.uniform(1, 2048, 60)
    y = rng.uniform(1, 1536, 60)
    ra, dec = truth.pix2world(x, y)
    j = jwcs.TanWCS.fit(x, y, ra, dec, sip_order=sip_order)
    t = twcs.TanWCS.fit(x, y, ra, dec, sip_order=sip_order)
    assert t.crval == j.crval and t.crpix == j.crpix
    np.testing.assert_array_equal(t.cd, j.cd)
    assert t.sip_a == j.sip_a and t.sip_b == j.sip_b


@pytest.mark.parametrize("user_scale", [None, 2.0])
def test_generate_hints_equal(user_scale):
    keys = dict(APRX_RA=123.4, APRX_DEC=-45.7, APRX_XPS=0.54, APRX_YPS=0.56,
                APRX_FOV=0.4, IMG_COLS=2000, IMG_ROWS=1000)
    hj, ht = jfits.Header(), tfits.Header()
    for k, v in keys.items():
        hj[k] = v
        ht[k] = v
    assert tast.generate_hints(ht, user_scale) == \
        jast.generate_hints(hj, user_scale)


def test_xylist_and_wcs_file_keys_equal():
    rng = np.random.default_rng(2)
    x, y = rng.uniform(1, 500, 20), rng.uniform(1, 400, 20)
    assert tast.xylist_fits_bytes(x, y) == jast.xylist_fits_bytes(x, y)
    blob = jfits.HDUList([jfits.ImageHDU(
        None, _wcs(jwcs, True).to_header(jfits.Header()))]).tobytes()
    assert tast.wcs_keys_from_wcs_file(blob) == \
        jast.wcs_keys_from_wcs_file(blob)
    cal = {"ra": 10.0, "dec": 20.0, "pixscale": 0.8, "orientation": 33.0,
           "parity": -1}
    assert tast._calibration_to_wcs(cal, 800, 600) == \
        jast._calibration_to_wcs(cal, 800, 600)


def _solve_inputs(folder, fits_mod):
    rng = np.random.default_rng(3)
    x = rng.uniform(50, 1998, 25)
    y = rng.uniform(50, 1486, 25)
    img_path = str(folder / "img.fits")
    fits_mod.write_image(img_path, np.zeros((1536, 2048), np.float32))
    src_hdr = fits_mod.Header()
    src_hdr["IMG_FILE"] = "img.fits"
    for k, v in dict(APRX_RA=123.4, APRX_DEC=-45.7, APRX_XPS=0.54,
                     APRX_YPS=0.54).items():
        src_hdr[k] = v
    src_path = str(folder / "src.fits")
    fits_mod.HDUList([fits_mod.ImageHDU(None, src_hdr),
                      fits_mod.BinTableHDU({"X": x, "Y": y},
                                           name="AP_XYPOS")]
                     ).writeto(src_path)
    return img_path, src_path


@pytest.mark.parametrize("with_sip", [False, True])
def test_astrometry_solve_mock_transport_bit_identical(tmp_path, with_sip):
    """The same mock transport answers both clients: the stamped image's
    header, the returned WCS and the source list's ra / dec columns."""
    truth_keys = dict(_wcs(jwcs, with_sip).to_header(jfits.Header()).items())
    out = {}
    for name, fits_mod, ast in (("jax", jfits, jast), ("port", tfits, tast)):
        folder = tmp_path / name
        folder.mkdir()
        img, src = _solve_inputs(folder, fits_mod)
        seen = {}

        def transport(xs, ys, w, h, hints, timeout=None, submission_id=None):
            seen.update(n=len(xs), w=w, h=h, hints=hints)
            return dict(truth_keys)

        wcs = ast.Astrometry(transport=transport).solve(
            img, src, str(folder / "wcs.fits"))
        out[name] = (wcs, seen, fits_mod.open_fits(str(folder / "wcs.fits")),
                     fits_mod.open_fits(src))
    (wj, sj, ij, srcj), (wt, st, it, srct) = out["jax"], out["port"]
    assert st == sj
    _same_cards(it[0].header, ij[0].header)
    np.testing.assert_array_equal(it[0].data, ij[0].data)
    np.testing.assert_array_equal(wt.cd, wj.cd)
    assert wt.crval == wj.crval and wt.sip_a == wj.sip_a
    for col in ("X", "Y", "ra", "dec"):
        np.testing.assert_array_equal(srct["AP_XYPOS"][col],
                                      srcj["AP_XYPOS"][col])


def test_astrometry_timeout_retry_and_failure_equal(tmp_path):
    """A first timeout monitors the same submission once more; a second
    gives up (None) — in both packages, call for call."""
    for name, fits_mod, ast in (("jax", jfits, jast), ("port", tfits, tast)):
        folder = tmp_path / name
        folder.mkdir()
        img, src = _solve_inputs(folder, fits_mod)
        calls = []

        def transport(xs, ys, w, h, hints, timeout=None, submission_id=None):
            calls.append(submission_id)
            raise ast.SolveTimeout(submission_id or 77)

        assert ast.Astrometry(transport=transport).solve(
            img, src, str(folder / "o.fits"), timeout=1.0) is None
        assert calls == [None, 77], name
        assert ast.Astrometry(transport=lambda *a, **k: None).solve(
            img, src, str(folder / "o.fits")) is None
        with pytest.raises(RuntimeError):
            ast.Astrometry().solve(img, src, str(folder / "o.fits"))


@pytest.mark.parametrize("with_sip,theta,tx,ty", [
    (False, 0.0, 12.0, -8.0),
    (False, 0.01, 12.25, -8.5),
    (True, 0.004, 20.0, -15.0),
])
def test_solve_from_reference_matches_jax(with_sip, theta, tx, ty):
    """Both packages map the same float32 similarity numbers: the fitted
    WCS agrees to 1e-9 deg on the sky and 1e-6 px back on the pixels."""
    vals = dict(scale=1.0001, theta=theta, tx=tx, ty=ty)
    sim_j = JSim(**{k: jnp.float32(v) for k, v in vals.items()},
                 n_inliers=jnp.int32(20), rms=jnp.float32(0.05))
    sim_t = TSim(**{k: torch.tensor(v, dtype=torch.float32)
                    for k, v in vals.items()},
                 n_inliers=torch.tensor(20), rms=torch.tensor(0.05))
    j = jast.solve_from_reference(_wcs(jwcs, with_sip), sim_j)
    t = tast.solve_from_reference(_wcs(twcs, with_sip), sim_t)
    assert bool(t.sip_a) == bool(j.sip_a) == with_sip
    rng = np.random.default_rng(4)
    x = rng.uniform(1, 2048, 100)
    y = rng.uniform(1, 1536, 100)
    ra_t, dec_t = t.pix2world(x, y)
    ra_j, dec_j = j.pix2world(x, y)
    np.testing.assert_allclose(ra_t, ra_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(dec_t, dec_j, rtol=0, atol=1e-9)
    for got, want in zip(t.world2pix(ra_j, dec_j), (x, y)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- metadata ---------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "raw-T05-davestrickland-NGC_6888-20200716-231744-Ha-BIN1-E-180-001.fit",
    "raw-T20-obs-Cygnus_Loop x1 y2-20200101-etc-more.fit",
    "too-few.fit",
])
def test_parse_itelescope_filename_equal(name):
    try:
        want = jmd.parse_itelescope_filename(name)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            tmd.parse_itelescope_filename(name)
        return
    assert tmd.parse_itelescope_filename(name) == want


def test_site_target_and_airmass_equal():
    assert tmd.SITES == {k: tmd.Site(*v.__dict__.values())
                         for k, v in jmd.SITES.items()}
    assert tmd.TELESCOPE_SITES == jmd.TELESCOPE_SITES
    assert tmd.TARGETS == jmd.TARGETS
    for tel in ("T05", "iTelescope T31", "t16", "T24"):
        assert tmd.get_site(tel).__dict__ == jmd.get_site(tel).__dict__
    for target in ("M42", "ngc 6888", "m 31"):
        assert tmd.resolve_target(target) == jmd.resolve_target(target)
    for date in ("2000-01-01T12:00:00", "2021-03-04T05:06:07.5",
                 "2022-11-30"):
        assert tmd._julian_date(date) == jmd._julian_date(date)
        jd = jmd._julian_date(date)
        assert tmd._gmst_deg(jd) == jmd._gmst_deg(jd)
        for key in jmd.SITES:
            args_t = (83.8221, -5.3911, tmd.SITES[key], date)
            args_j = (83.8221, -5.3911, jmd.SITES[key], date)
            assert tmd.compute_altaz(*args_t) == jmd.compute_altaz(*args_j)
            assert tmd.compute_airmass(*args_t) == \
                jmd.compute_airmass(*args_j)


def test_simbad_resolver_mock_transport_equal():
    urls = {}

    def transport(tag):
        def fetch(url):
            urls[tag] = url
            q = urllib.parse.parse_qs(urllib.parse.urlparse(url).query)
            assert q["FORMAT"] == ["json"]
            return json.dumps({"data": [[83.6331, 22.0145]]}).encode()
        return fetch

    assert tmd.simbad_resolver(transport("port"))("O'Neill 1") == \
        jmd.simbad_resolver(transport("jax"))("O'Neill 1")
    assert urls["port"] == urls["jax"]
    empty = json.dumps({"data": []}).encode()
    assert tmd.simbad_resolver(lambda u: empty)("X") is None
    assert tmd.simbad_resolver(lambda u: b"not json")("X") is None


@pytest.mark.parametrize("mode", ["iTelescope", "iTelescope_resolver",
                                  "yamlkeyval"])
def test_add_metadata_equal_headers(tmp_path, mode):
    name = ("raw-T05-davestrickland-Betelgeuse-20200716-231744-V-BIN1-E-"
            "180-001.fit" if mode == "iTelescope_resolver" else
            "raw-T05-davestrickland-NGC_6888-20200716-231744-Ha-BIN1-E-"
            "180-001.fit")
    yml = str(tmp_path / "meta.yml")
    with open(yml, "w") as fh:
        yaml.safe_dump({"filter": "Ha", "exptime": 180.0, "telescop": "T31",
                        "target": "M42", "tags": [1, 2]}, fh)
    kw = dict(mode="yamlkeyval", yamlfile=yml) if mode == "yamlkeyval" \
        else dict(mode="iTelescope")
    got = {}
    for tag, fits_mod, md in (("jax", jfits, jmd), ("port", tfits, tmd)):
        (tmp_path / tag).mkdir()
        path = str(tmp_path / tag / name)
        hdr = fits_mod.Header()
        hdr["DATE-OBS"] = "2020-07-17T05:17:44"
        fits_mod.write_image(path, np.zeros((4, 4), np.float32), hdr)
        written = md.add_metadata(path, resolver=lambda n: (88.79, 7.41),
                                  **kw)
        got[tag] = (written, fits_mod.open_fits(path)[0].header)
    assert got["port"][0] == got["jax"][0]
    _same_cards(got["port"][1], got["jax"][1])


def test_summarize_quality_equal_csv_bytes(tmp_path):
    reports = [
        {"image_info": {"object": "M42", "telescope": "T05", "filter": "V",
                        "date-obs": "2026-01-02T03:04:05"},
         "background_info": {"median": 101.5, "stddev": 3.25},
         "psf_info": {"num_fit": 3,
                      "fwhm_x": {"fwhm_val_pix": 2.9, "num_data_pts": 3}}},
        {"image_info": {"object": "M42", "telescope": "T05", "filter": "R",
                        "date-obs": "2026-01-02T01:00:00"},
         "source_info": {"num_detected": 12}},
        {"image_info": {"object": "M31", "telescope": "T20", "filter": "V"}},
    ]
    sub = tmp_path / "nested"
    sub.mkdir()
    for i, rep in enumerate(reports):
        folder = sub if i == 2 else tmp_path
        with open(folder / f"qual_{i}.yml", "w") as fh:
            yaml.dump(rep, fh)
    for walk in (False, True):
        out_j = str(tmp_path / f"j{walk}.csv")
        out_t = str(tmp_path / f"t{walk}.csv")
        rows_j = jq.summarize_quality(str(tmp_path), out_j, walk_tree=walk)
        rows_t = tq.summarize_quality(str(tmp_path), out_t, walk_tree=walk)
        assert rows_t == rows_j
        with open(out_t, "rb") as a, open(out_j, "rb") as b:
            assert a.read() == b.read()
    with pytest.raises(RuntimeError):
        tq.summarize_quality(str(tmp_path), out_t, prefix="none")
