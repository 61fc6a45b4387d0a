"""Port parity: the calibration-file engines (``core/masters``,
``core/calibrator``, ``core/badpix_engine``) and their six CLIs, both
packages on the same temp files at 64 x 96.

Data agrees within the tolerance that the underlying op's own parity
test uses (``sigma_clip_combine`` rtol 1e-6 / atol 1e-3,
``calibrate_frame`` rtol 1e-6 / atol 1e-4, the bad-pixel ops exactly,
``lacosmic`` 1e-4 relative away from at most two mask pixels).  Header
cards are equal, order and comments included; the two cards whose value
is a float32 statistic of the data (MEANFULL, RDNOISE) agree to 1e-6
relative.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from astrophotography_tpu import synth
from astrophotography_tpu.cli import ap_auto_badcol as j_auto_badcol
from astrophotography_tpu.cli import ap_calc_read_noise as j_read_noise
from astrophotography_tpu.cli import ap_calibrate as j_calibrate
from astrophotography_tpu.cli import ap_combine_darks as j_combine
from astrophotography_tpu.cli import ap_find_badpix as j_find_badpix
from astrophotography_tpu.cli import ap_fix_badpix as j_fix_badpix
from astrophotography_tpu.core import badpix_engine as jbad
from astrophotography_tpu.core import calibrator as jcal
from astrophotography_tpu.core import masters as jmas
from astrophotography_tpu.io.fits import Header, read_image, write_image
from astrophotography_tpu_torch import core as tcore
from astrophotography_tpu_torch.cli import ap_auto_badcol as t_auto_badcol
from astrophotography_tpu_torch.cli import ap_calc_read_noise as t_read_noise
from astrophotography_tpu_torch.cli import ap_calibrate as t_calibrate
from astrophotography_tpu_torch.cli import ap_combine_darks as t_combine
from astrophotography_tpu_torch.cli import ap_find_badpix as t_find_badpix
from astrophotography_tpu_torch.cli import ap_fix_badpix as t_fix_badpix
from astrophotography_tpu_torch.core import badpix_engine as tbad
from astrophotography_tpu_torch.core import calibrator as tcal
from astrophotography_tpu_torch.core import masters as tmas

torch.set_num_threads(1)

H, W = 64, 96
CPU = ["--device", "cpu"]
FLOAT_STAT_CARDS = {"MEANFULL", "RDNOISE"}
HOT = (np.array([5, 17, 30, 44, 58]), np.array([9, 70, 41, 88, 23]))
BAD_COL = 33


def _write(folder, name, data, **keys):
    hdr = Header()
    for k, v in keys.items():
        hdr[k.replace("_", "-")] = v
    path = str(folder / name)
    write_image(path, data, hdr)
    return path


def _same_cards(got, want):
    """Equal cards in equal order (keyword, value, comment)."""
    got, want = list(got._cards), list(want._cards)
    assert [c[0] for c in got] == [c[0] for c in want]
    for (k, v, c), (_, rv, rc) in zip(got, want):
        assert c == rc, k
        if k in FLOAT_STAT_CARDS:
            assert v == pytest.approx(rv, rel=1e-6), k
        else:
            assert v == rv and type(v) is type(rv), k


def _same_file(path_t, path_j, rtol=0.0, atol=0.0):
    got, ghdr = read_image(path_t, as_float32=False, remove_pedestal=False)
    want, whdr = read_image(path_j, as_float32=False, remove_pedestal=False)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    _same_cards(ghdr, whdr)
    return got, ghdr


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Bias, dark and flat folders (five good frames each, the darks with
    a sixth that is 2 C off), two lights and a work folder."""
    root = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(0)
    temps = {"SET_TEMP": -10.0, "CCD_TEMP": -10.1}
    vignette = 1.0 - 0.2 * ((np.arange(W) - W / 2) / W) ** 2 * np.ones((H, W))
    dark_rate = np.full((H, W), 0.5)
    dark_rate[HOT] = 150.0
    dark_rate[:, BAD_COL] += 4.0
    out = {"root": root, "vignette": vignette}
    for kind in ("bias", "dark", "flat"):
        (root / kind).mkdir()
    for i in range(5):
        _write(root / "bias", f"bias{i}.fits",
               rng.normal(300, 4, (H, W)).round().astype(np.uint16),
               IMAGETYP="BIAS", EXPTIME=0.0, GAIN=1.5, **temps)
        _write(root / "dark", f"dark{i}.fits",
               (300 + dark_rate * 60 + rng.normal(0, 4, (H, W)))
               .round().astype(np.uint16),
               IMAGETYP="DARK", EXPTIME=60.0, **temps)
        _write(root / "flat", f"flat{i}.fits",
               (300 + 20000 * vignette + rng.normal(0, 60, (H, W)))
               .round().astype(np.uint16),
               IMAGETYP="FLAT", EXPTIME=2.0, **temps)
    _write(root / "dark", "dark_warm.fits",
           rng.normal(420, 4, (H, W)).round().astype(np.uint16),
           IMAGETYP="DARK", EXPTIME=60.0, SET_TEMP=-10.0, CCD_TEMP=-8.0)
    scene, _ = synth.make_starfield((H, W), n_stars=6, background=400.0,
                                    seed=3, margin=8)
    lights = []
    for i in range(2):
        img = scene * vignette + 300 + dark_rate * 120 \
            + rng.normal(0, 5, (H, W))
        lights.append(_write(root, f"light{i}.fits",
                             np.clip(img, 0, 65535).round().astype(np.uint16),
                             IMAGETYP="LIGHT", EXPTIME=120.0, GAIN=1.5,
                             PEDESTAL=-100, **temps))
    out["lights"] = lights
    out["scene"] = scene
    return out


@pytest.fixture(scope="module")
def masters(files):
    """The three masters, built by each package from the same folders."""
    root = files["root"]
    paths = {}
    for kind in ("bias", "dark", "flat"):
        pj = str(root / f"j_master_{kind}.fits")
        pt = str(root / f"t_master_{kind}.fits")
        hj = jmas.make_master(str(root / kind), pj)
        ht = tmas.make_master(str(root / kind), pt, device="cpu")
        paths[kind] = (pj, pt, hj, ht)
    return paths


@pytest.mark.parametrize("kind", ["bias", "dark", "flat"])
def test_make_master_matches(masters, kind):
    pj, pt, hj, ht = masters[kind]
    _same_cards(ht, hj)
    got, hdr = _same_file(pt, pj, rtol=1e-6, atol=1e-3)
    assert got.dtype == np.float32
    assert hdr["IMAGETYP"] == f"MASTER {kind.upper()}"
    assert hdr["NCOMBINE"] == 5
    assert [hdr[f"IFILE{n:03d}"] for n in range(5)] \
        == [f"{kind}{n}.fits" for n in range(5)]
    assert "IFILE005" not in hdr       # the warm dark was left out


def test_make_master_takes_a_list_and_a_pattern(files, tmp_path):
    root = files["root"]
    names = [str(root / "bias" / f"bias{i}.fits") for i in (0, 2, 4)]
    hj = jmas.make_master(names, str(tmp_path / "j.fits"), sigma=3.0)
    ht = tmas.make_master(names, str(tmp_path / "t.fits"), sigma=3.0,
                          device="cpu")
    _same_cards(ht, hj)
    assert ht["NCOMBINE"] == 3
    _same_file(str(tmp_path / "t.fits"), str(tmp_path / "j.fits"),
               rtol=1e-6, atol=1e-3)
    ht = tmas.make_master(str(root / "bias"), str(tmp_path / "p.fits"),
                          pattern="bias[01].fits", device="cpu")
    assert ht["NCOMBINE"] == 2
    assert tmas.collect_frames(str(root), pattern="*master*.fits",
                               exclude_pattern="*_master_*") == []


def test_make_master_temperature_filter(files, tmp_path):
    """A wide tolerance lets the warm dark in, in both packages."""
    root = files["root"]
    hj = jmas.make_master(str(root / "dark"), str(tmp_path / "j.fits"),
                          temptol=5.0)
    ht = tmas.make_master(str(root / "dark"), str(tmp_path / "t.fits"),
                          temptol=5.0, device="cpu")
    assert ht["NCOMBINE"] == hj["NCOMBINE"] == 6
    _same_file(str(tmp_path / "t.fits"), str(tmp_path / "j.fits"),
               rtol=1e-6, atol=1e-3)


@pytest.mark.parametrize("case", ["too_few", "mixed_type", "mixed_exptime",
                                  "all_warm"])
def test_make_master_errors_alike(files, tmp_path, case):
    rng = np.random.default_rng(1)

    def frame(name, **keys):
        return _write(tmp_path, name,
                      rng.normal(300, 4, (8, 8)).astype(np.float32), **keys)
    if case == "too_few":
        frame("a.fits", IMAGETYP="BIAS")
    elif case == "mixed_type":
        frame("a.fits", IMAGETYP="BIAS")
        frame("b.fits", IMAGETYP="DARK")
    elif case == "mixed_exptime":
        frame("a.fits", IMAGETYP="DARK", EXPTIME=30.0)
        frame("b.fits", IMAGETYP="DARK", EXPTIME=60.0)
    else:
        for n in "ab":
            frame(f"{n}.fits", IMAGETYP="DARK", SET_TEMP=-10.0,
                  CCD_TEMP=-3.0)
    out = str(tmp_path / "master_out.fits")
    with pytest.raises(jmas.MasterCalError) as jerr:
        jmas.make_master(str(tmp_path), out)
    with pytest.raises(tmas.MasterCalError) as terr:
        tmas.make_master(str(tmp_path), out, device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert issubclass(tmas.MasterCalError, RuntimeError)
    assert not os.path.exists(out)


def test_calc_read_noise_matches(files, tmp_path):
    root = files["root"]
    b1, b2 = (str(root / "bias" / f"bias{i}.fits") for i in (0, 1))
    want = jmas.calc_read_noise(b1, b2, diffim_path=str(tmp_path / "j.fits"))
    got = tmas.calc_read_noise(b1, b2, diffim_path=str(tmp_path / "t.fits"),
                               device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    assert got["gain"] == 1.5
    assert got["read_noise_e"] == pytest.approx(4.0 * 1.5, rel=0.1)
    _same_file(str(tmp_path / "t.fits"), str(tmp_path / "j.fits"))
    got = tmas.calc_read_noise(b1, b2, gain=2.0, sigma=4.0, device="cpu")
    want = jmas.calc_read_noise(b1, b2, gain=2.0, sigma=4.0)
    assert got["read_noise_e"] == pytest.approx(want["read_noise_e"],
                                                rel=1e-6)


def test_calc_read_noise_errors_alike(files, tmp_path):
    b1 = str(files["root"] / "bias" / "bias0.fits")
    small = _write(tmp_path, "small.fits", np.zeros((8, 8), np.float32),
                   GAIN=1.5)
    other = _write(tmp_path, "gain.fits", np.zeros((H, W), np.float32),
                   GAIN=2.5)
    nogain = _write(tmp_path, "nogain.fits",
                    np.random.default_rng(2).normal(0, 3, (H, W))
                    .astype(np.float32))
    for bad in (small, other):
        with pytest.raises(RuntimeError) as jerr:
            jmas.calc_read_noise(b1, bad)
        with pytest.raises(RuntimeError) as terr:
            tmas.calc_read_noise(b1, bad, device="cpu")
        assert str(terr.value) == str(jerr.value)
    assert tmas.calc_read_noise(nogain, nogain, device="cpu")["gain"] == 1.0


def test_calc_read_noise_plot(files, tmp_path):
    root = files["root"]
    b1, b2 = (str(root / "bias" / f"bias{i}.fits") for i in (0, 1))
    plot = str(tmp_path / "hist.png")
    tmas.calc_read_noise(b1, b2, plot_path=plot, device="cpu")
    assert os.path.getsize(plot) > 1000


@pytest.fixture(scope="module")
def user_yaml(files):
    path = str(files["root"] / "user.yml")
    with open(path, "w") as fh:
        yaml.safe_dump({"bad_columns": [5],
                        "bad_rectangles": [[10, 12, 20, 21]]}, fh)
    return path


@pytest.fixture(scope="module")
def masks(files, masters, user_yaml):
    root = files["root"]
    pj, pt = str(root / "j_badpix.fits"), str(root / "t_badpix.fits")
    hj = jbad.find_badpix(masters["dark"][0], pj, sigma=5.0,
                          user_badpix=user_yaml)
    ht = tbad.find_badpix(masters["dark"][0], pt, sigma=5.0,
                          user_badpix=user_yaml, device="cpu")
    return pj, pt, hj, ht


def test_find_badpix_with_a_user_yaml_matches(masks):
    pj, pt, hj, ht = masks
    _same_cards(ht, hj)
    mask, hdr = _same_file(pt, pj)
    assert mask.dtype == np.uint8
    assert (mask[HOT] > 0).all()
    assert (mask[:, 4] == 2).all() and (mask[19:21, 9:12] == 2).all()
    assert hdr["BPIXNUSR"] == H + 6 and hdr["BPIXNAUT"] >= 5


def test_find_badpix_without_a_user_file_matches(masters, tmp_path):
    hj = jbad.find_badpix(masters["dark"][0], str(tmp_path / "j.fits"))
    ht = tbad.find_badpix(masters["dark"][0], str(tmp_path / "t.fits"),
                          device="cpu")
    _same_cards(ht, hj)
    _same_file(str(tmp_path / "t.fits"), str(tmp_path / "j.fits"))
    assert ht["BPIXNUSR"] == 0 and ht["BPIXSIGM"] == 4.0


def test_read_user_badpix_tolerates_absent_sections(user_yaml, tmp_path):
    assert tbad.read_user_badpix(user_yaml) == jbad.read_user_badpix(user_yaml)
    empty = tmp_path / "empty.yml"
    empty.write_text("")
    assert tbad.read_user_badpix(str(empty)) == {
        "bad_columns": [], "bad_rows": [], "bad_rectangles": []}


@pytest.mark.parametrize("deltapix", [1, 2])
def test_fix_badpix_files_matches(files, masks, tmp_path, deltapix):
    pj, pt = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    hj = jbad.fix_badpix_files(files["lights"][0], masks[0], pj,
                               deltapix=deltapix)
    ht = tbad.fix_badpix_files(files["lights"][0], masks[0], pt,
                               deltapix=deltapix, device="cpu")
    _same_cards(ht, hj)
    fixed, hdr = _same_file(pt, pj)
    raw, _ = read_image(files["lights"][0])
    assert hdr["BPIXCORR"] is True and hdr["BPIXNFIX"] > 0
    assert hdr["BPIXNBAD"] == hdr["BPIXNFIX"] + hdr["BPIXNREM"]
    assert (np.abs(fixed[HOT] - raw[HOT]) > 1000).all()
    assert "PEDESTAL" not in hdr


def test_auto_badcol_file_matches(masters, tmp_path):
    yj, yt = str(tmp_path / "j.yml"), str(tmp_path / "t.yml")
    cj, rj = jbad.auto_badcol_file(masters["dark"][0], output_yaml=yj)
    ct, rt = tbad.auto_badcol_file(masters["dark"][0], output_yaml=yt,
                                   device="cpu")
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(rt, rj)
    assert BAD_COL in ct
    with open(yj) as fj, open(yt) as ft:
        assert ft.read() == fj.read()
    ct2, _ = tbad.auto_badcol_file(masters["dark"][0], sigma=50.0,
                                   window=7, device="cpu")
    cj2, _ = jbad.auto_badcol_file(masters["dark"][0], sigma=50.0, window=7)
    np.testing.assert_array_equal(ct2, cj2)


CAL_CASES = {
    "all": dict(bias=True, dark=True, flat=True, badpix=True),
    "no_flat": dict(bias=True, dark=True, flat=False, badpix=False),
    "bias_only": dict(bias=True, dark=False, flat=False, badpix=False),
    "dark_only": dict(bias=False, dark=True, flat=False, badpix=True),
    "flat_raw": dict(bias=True, dark=False, flat=True, badpix=False,
                     norm_flat=False),
    "debiased": dict(bias=True, dark=True, flat=True, badpix=True,
                     dark_still_biased=False, deltapix=1),
    "none": dict(bias=False, dark=False, flat=False, badpix=False),
}


def _calibrators(masters, masks, case):
    opts = dict(CAL_CASES[case])
    use = {k: opts.pop(k) for k in ("bias", "dark", "flat", "badpix")}
    # both read the same master files (the masters' own parity is held
    # above), so the provenance cards name the same files
    kw = {f"master_{k}": masters[k][0] for k in ("bias", "dark", "flat")
          if use[k]}
    if use["badpix"]:
        kw["master_badpix"] = masks[0]
    return (jcal.Calibrator(**kw, **opts),
            tcal.Calibrator(**kw, **opts, device="cpu"))


@pytest.mark.parametrize("case", sorted(CAL_CASES))
def test_calibrator_matches(files, masters, masks, tmp_path, case):
    jc, tc = _calibrators(masters, masks, case)
    for i, light in enumerate(files["lights"]):
        pj, pt = str(tmp_path / f"j{i}.fits"), str(tmp_path / f"t{i}.fits")
        hj = jc.calibrate(light, pj)
        ht = tc.calibrate(light, pt)
        _same_cards(ht, hj)
        got, _ = read_image(pt)
        want, _ = read_image(pj)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    assert ht["BIASCORR"] is CAL_CASES[case]["bias"]
    assert ht["DARKCORR"] is CAL_CASES[case]["dark"]
    assert ht["FLATCORR"] is CAL_CASES[case]["flat"]
    assert ht["BUNIT"] == "adu"
    if case == "all":
        inner = (slice(8, -8), slice(8, -8))
        # the lights carry PEDESTAL = -100, removed before the flat
        # by a flat normalised to a mean of one
        vig = files["vignette"]
        expect = (files["scene"] * vig - 100.0) / (vig / vig.mean())
        assert abs(np.median(got[inner] - expect[inner])) < 5.0


def test_calibrator_fix_cosmic_matches(files, masters, masks, tmp_path):
    raw, hdr = read_image(files["lights"][0], as_float32=False,
                          remove_pedestal=False)
    rng = np.random.default_rng(5)
    hit = raw.copy()
    ys, xs = rng.integers(6, H - 6, 8), rng.integers(6, W - 6, 8)
    hit[ys, xs] = np.minimum(hit[ys, xs].astype(np.int64) + 9000, 65535)
    light = str(tmp_path / "light_cr.fits")
    write_image(light, hit, hdr)
    jc, tc = _calibrators(masters, masks, "all")
    hj = jc.calibrate(light, str(tmp_path / "j.fits"), fix_cosmic=True)
    ht = tc.calibrate(light, str(tmp_path / "t.fits"), fix_cosmic=True)
    assert ht["CR_CLEAN"] is True and ht["CR_NPIX"] > 0
    assert abs(ht["CR_NPIX"] - hj["CR_NPIX"]) <= 2
    for h in (hj, ht):
        h["CR_NPIX"] = 0
    _same_cards(ht, hj)
    got, _ = read_image(str(tmp_path / "t.fits"))
    want, _ = read_image(str(tmp_path / "j.fits"))
    close = np.abs(got - want) <= 1e-4 * np.abs(want) + 1e-4
    # away from at most two mask pixels (and the 5 x 5 each one cleans)
    assert (~close).sum() <= 2 * 25
    assert (got[ys, xs] < 3000).mean() >= 0.75


def test_calibrator_needs_the_exposure_times(files, masters, tmp_path):
    raw, hdr = read_image(files["lights"][0], as_float32=False,
                          remove_pedestal=False)
    del hdr["EXPTIME"]
    light = str(tmp_path / "noexp.fits")
    write_image(light, raw, hdr)
    out = str(tmp_path / "out.fits")
    for cal in (jcal.Calibrator(master_dark=masters["dark"][0]),
                tcal.Calibrator(master_dark=masters["dark"][1],
                                device="cpu")):
        with pytest.raises(RuntimeError, match="exposure time for image"):
            cal.calibrate(light, out)
    # a dark without EXPTIME
    dark, dhdr = read_image(masters["dark"][0])
    del dhdr["EXPTIME"]
    bare = str(tmp_path / "dark_noexp.fits")
    write_image(bare, dark, dhdr)
    with pytest.raises(RuntimeError, match="exposure time for dark"):
        tcal.Calibrator(master_dark=bare, device="cpu").calibrate(
            files["lights"][0], out)
    assert not os.path.exists(out)


def test_exptime_and_gain_lookup():
    for mod in (jcal, tcal):
        hdr = Header()
        assert mod.find_exptime(hdr) is None and mod.find_gain(hdr) == 1.0
        hdr["EXPTIME"] = 30
        hdr["EGAIN"] = 2.5
        assert mod.find_exptime(hdr) == 30.0 and mod.find_gain(hdr) == 2.5
        hdr["EXPOSURE"] = 45.0
        assert mod.find_exptime(hdr) == 45.0


@pytest.mark.parametrize("make", [
    lambda f: tmas.make_master(str(f["root"] / "bias"), "unused.fits"),
    lambda f: tmas.calc_read_noise(f["lights"][0], f["lights"][1]),
    lambda f: tcal.Calibrator(),
    lambda f: tbad.find_badpix(f["lights"][0], "unused.fits"),
    lambda f: tbad.fix_badpix_files(f["lights"][0], f["lights"][1],
                                    "unused.fits"),
    lambda f: tbad.auto_badcol_file(f["lights"][0]),
], ids=["make_master", "calc_read_noise", "Calibrator", "find_badpix",
        "fix_badpix_files", "auto_badcol_file"])
def test_engines_default_to_the_card(files, make):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        make(files)
    assert not os.path.exists("unused.fits")


def test_core_exports():
    for name in ("RawConv", "Calibrator", "make_master", "calc_read_noise",
                 "find_badpix", "fix_badpix_files", "auto_badcol_file",
                 "read_user_badpix", "collect_frames", "check_consistency",
                 "find_exptime", "find_gain", "MasterCalError"):
        assert name in tcore.__all__ and hasattr(tcore, name)


# -- the six CLIs --------------------------------------------------------

def test_cli_combine_darks(files, tmp_path):
    dark = str(files["root"] / "dark")
    pj, pt = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    args = ["--sigma", "4", "--temptol", "1.0", "-l", "ERROR"]
    assert j_combine.main([dark, pj] + args) == 0
    assert t_combine.main([dark, pt] + args + CPU) == 0
    _, hdr = _same_file(pt, pj, rtol=1e-6, atol=1e-3)
    assert hdr["NCOMBINE"] == 5
    empty = tmp_path / "empty"
    empty.mkdir()
    assert t_combine.main([str(empty), pt, "-l", "CRITICAL"] + CPU) == 1
    assert j_combine.main([str(empty), pj, "-l", "CRITICAL"]) == 1


def test_cli_calc_read_noise(files, tmp_path, capsys):
    b1, b2 = (str(files["root"] / "bias" / f"bias{i}.fits") for i in (0, 1))
    assert j_read_noise.main([b1, b2, "-l", "ERROR"]) == 0
    want = capsys.readouterr().out
    assert t_read_noise.main([b1, b2, "-l", "ERROR"] + CPU) == 0
    got = capsys.readouterr().out
    assert got == want and "READ_NOISE=" in got
    assert t_read_noise.main([b1, str(tmp_path / "missing.fits"),
                              "-l", "CRITICAL"] + CPU) == 1


def test_cli_find_and_fix_badpix(files, masters, user_yaml, tmp_path):
    mj, mt = str(tmp_path / "mj.fits"), str(tmp_path / "mt.fits")
    args = ["--sigma", "5", "--user_badpix", user_yaml, "-l", "ERROR"]
    assert j_find_badpix.main([masters["dark"][0], mj] + args) == 0
    assert t_find_badpix.main([masters["dark"][1], mt] + args + CPU) == 0
    got, ghdr = read_image(mt, as_float32=False)
    want, whdr = read_image(mj, as_float32=False)
    np.testing.assert_array_equal(got, want)
    assert ghdr["BPIXNAUT"] == whdr["BPIXNAUT"]
    fj, ft = str(tmp_path / "fj.fits"), str(tmp_path / "ft.fits")
    light = files["lights"][1]
    assert j_fix_badpix.main([light, mj, fj, "--deltapix", "2",
                              "-l", "ERROR"]) == 0
    assert t_fix_badpix.main([light, mj, ft, "--deltapix", "2",
                              "-l", "ERROR"] + CPU) == 0
    _same_file(ft, fj)
    assert t_fix_badpix.main([light, str(tmp_path / "nomask.fits"), ft,
                              "-l", "CRITICAL"] + CPU) == 1


def test_cli_auto_badcol(masters, tmp_path):
    yj, yt = str(tmp_path / "j.yml"), str(tmp_path / "t.yml")
    assert j_auto_badcol.main([masters["dark"][0], "--output_yaml", yj,
                               "-l", "ERROR"]) == 0
    assert t_auto_badcol.main([masters["dark"][1], "--output_yaml", yt,
                               "-l", "ERROR"] + CPU) == 0
    with open(yj) as fj, open(yt) as ft:
        data = yaml.safe_load(ft)
        assert data == yaml.safe_load(fj)
    assert BAD_COL + 1 in data["bad_columns"]


@pytest.mark.parametrize("extra", [[], ["--no-normflat"], ["--fixcosmic"],
                                   ["--dark_debiased", "--deltapix", "1"]],
                         ids=lambda e: "_".join(e) or "default")
def test_cli_calibrate(files, masters, masks, tmp_path, extra):
    pj, pt = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    light = files["lights"][0]
    common = ["--master_flat", masters["flat"][0],
              "--master_badpix", masks[0], "-l", "ERROR"] + extra
    assert j_calibrate.main([light, masters["bias"][0], masters["dark"][0],
                             pj] + common) == 0
    assert t_calibrate.main([light, masters["bias"][0], masters["dark"][0],
                             pt] + common + CPU) == 0
    got, ghdr = read_image(pt)
    want, whdr = read_image(pj)
    if "--fixcosmic" in extra:
        assert abs(ghdr["CR_NPIX"] - whdr["CR_NPIX"]) <= 2
        ghdr["CR_NPIX"] = whdr["CR_NPIX"] = 0
        assert (np.abs(got - want) > 1e-4 * np.abs(want) + 1e-4).sum() <= 50
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    _same_cards(ghdr, whdr)
    assert ghdr["BPIXFILE"] == os.path.basename(masks[0])


def test_cli_tools_fail_without_a_card(files, masters, tmp_path):
    """The default device is the card; without one a tool exits 1 and
    writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = str(tmp_path / "out.fits")
    assert t_combine.main([str(files["root"] / "bias"), out,
                           "-l", "CRITICAL"]) == 1
    assert t_calibrate.main([files["lights"][0], masters["bias"][1],
                             masters["dark"][1], out, "-l", "CRITICAL"]) == 1
    assert not os.path.exists(out)
