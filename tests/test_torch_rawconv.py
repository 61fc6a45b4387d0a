"""Port parity: ``RawConv``, the ``api`` commands and the ``dksraw`` CLI,
both packages on the same DNG.  Output arrays agree within 1 ADU after
the uint16 cast (a value that lands on a whole number may truncate either
way), headers are equal card for card."""

import os

import numpy as np
import pytest
import torch

from astrophotography_tpu import synth
from astrophotography_tpu import api as japi
from astrophotography_tpu.cli.dksraw import main as j_dksraw
from astrophotography_tpu.core import RawConv as JRawConv
from astrophotography_tpu.io import fits as jfits
from astrophotography_tpu.io.raw import load_raw, write_dng
from astrophotography_tpu_torch import api as tapi
from astrophotography_tpu_torch.cli.dksraw import main as t_dksraw
from astrophotography_tpu_torch.core import RawConv as TRawConv
from astrophotography_tpu_torch.io import fits as tfits

torch.set_num_threads(1)

H, W = 32, 48
WB = (2.0, 1.0, 1.4, 1.0)
WB_METHODS = ["daylight", "camera", "auto", "region[4,27,4,43]",
              "user[2.0,1.0,1.5]", "user[1.8,1.0,1.3,1.1]", "user"]


@pytest.fixture(scope="module")
def dng(tmp_path_factory):
    scene = synth.make_rgb_scene((H, W), seed=7, peak=20000)
    blacks = (512, 500, 520, 508)
    mosaic = synth.mosaic_from_rgb(scene, black_levels=blacks, wb_gains=WB)
    path = str(tmp_path_factory.mktemp("raw") / "scene.dng")
    write_dng(path, mosaic, black_levels=blacks, white_level=16383,
              camera_wb=WB, compression=7,
              exif={"Model": "SynthCam", "ExposureTime": 0.01,
                    "ISOSpeedRatings": 400})
    return path


@pytest.fixture(scope="module")
def convs(dng):
    return JRawConv(dng), TRawConv(dng, device="cpu")


def _within_one(got, want):
    assert got.dtype == want.dtype == np.uint16 and got.shape == want.shape
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= 1


def _same_headers(path_j, path_t):
    hj, ht = jfits.open_fits(path_j), tfits.open_fits(path_t)
    assert len(hj) == len(ht)
    for a, b in zip(hj, ht):
        assert list(a.header._cards) == list(b.header._cards)
    return hj, ht


def test_rawconv_defaults_to_the_card(dng):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        TRawConv(dng)


def test_rawconv_holds_the_frame_on_its_device(convs):
    _, conv = convs
    assert conv._mosaic.dtype == torch.uint16
    assert conv._color_map.dtype == torch.int64
    assert conv._black_levels.dtype == torch.float32
    assert conv.shape == (H, W) and conv.exif["Model"] == "SynthCam"


@pytest.mark.parametrize("wb_method", WB_METHODS)
def test_whitebalance_methods_match(convs, wb_method):
    jconv, tconv = convs
    want = jconv.get_whitebalance(wb_method)
    got = tconv.get_whitebalance(wb_method)
    assert len(got) == 4 and all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("spec", ["bogus", "user[1,2", "user[1,2]",
                                  "region[1,2,3]", "region[a,b,c,d]",
                                  "region[1,2,(]"])
def test_malformed_whitebalance_specs_raise_alike(convs, spec):
    for conv in convs:
        with pytest.raises(RuntimeError):
            conv.get_whitebalance(spec)


@pytest.mark.parametrize("wb_method", ["camera", "auto"])
@pytest.mark.parametrize("demosaic", ["mhc", "bilinear", "ahd"])
def test_rgb_and_grey_match(convs, wb_method, demosaic):
    jconv, tconv = convs
    want, jexif = jconv.rgb(wb_method=wb_method, demosaic=demosaic)
    got, texif = tconv.rgb(wb_method=wb_method, demosaic=demosaic)
    assert got.shape == (H, W, 3) and jexif == texif
    _within_one(got, want)
    want, _ = jconv.grey(wb_method=wb_method, demosaic=demosaic)
    got, _ = tconv.grey(wb_method=wb_method, demosaic=demosaic)
    _within_one(got, want)


@pytest.mark.parametrize("kwargs", [
    dict(luminance_method="direct"),
    dict(luminance_method="direct", subtract_black=False),
    dict(subtract_black=False),
    dict(renorm=True),
    dict(print_stats=True),
    dict(renorm=True, print_stats=True),
], ids=lambda k: "-".join(f"{a}={b}" for a, b in k.items()))
def test_grey_options_match(convs, kwargs):
    jconv, tconv = convs
    want, _ = jconv.grey(wb_method="camera", **kwargs)
    got, _ = tconv.grey(wb_method="camera", **kwargs)
    if kwargs.get("renorm"):
        # the stretch multiplies a percentile-position difference of
        # 3e-5 of the range by the frame: within 3 ADU of 65535
        assert np.abs(got.astype(np.int64)
                      - want.astype(np.int64)).max() <= 3
    else:
        _within_one(got, want)


def test_grey_fetch_false_stays_on_the_device(convs):
    _, tconv = convs
    host, _ = tconv.grey(wb_method="camera")
    dev, _ = tconv.grey(wb_method="camera", fetch=False)
    assert isinstance(dev, torch.Tensor) and dev.dtype == torch.uint16
    np.testing.assert_array_equal(dev.numpy(), host)
    with pytest.raises(RuntimeError):
        tconv.grey(luminance_method="bogus")


@pytest.mark.parametrize("subtract_black", [True, False])
def test_split_matches(convs, dng, subtract_black):
    jconv, tconv = convs
    want = jconv.split(subtract_black=subtract_black)
    got = tconv.split(subtract_black=subtract_black)
    raw = load_raw(dng)
    for color, (a, b) in enumerate(zip(got[:4], want[:4])):
        np.testing.assert_array_equal(a, b)
        assert not a[raw.color_map != color].any()
    assert got[4] == want[4]


@pytest.mark.parametrize("command", ["grey", "rgb"])
def test_api_commands_write_equal_files(dng, tmp_path, command):
    pj, pt = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    getattr(japi, command)(dng, pj, wb_method="camera")
    getattr(tapi, command)(dng, pt, wb_method="camera", device="cpu")
    hj, ht = _same_headers(pj, pt)
    for a, b in zip(hj, ht):
        if a.data is not None:
            _within_one(b.data, a.data)


def test_api_split_writes_equal_files(dng, tmp_path):
    japi.split(dng, str(tmp_path / "j.fits"), extension="fits")
    tapi.split(dng, str(tmp_path / "t.fits"), extension="fits",
               device="cpu")
    for band in ("r", "g1", "b", "g2"):
        hj, ht = _same_headers(str(tmp_path / f"j_{band}.fits"),
                               str(tmp_path / f"t_{band}.fits"))
        np.testing.assert_array_equal(ht[0].data, hj[0].data)


CLI_CASES = [
    ["grey", "-w", "camera"],
    ["grey", "-w", "auto", "-m", "direct", "-b"],
    ["grey", "-w", "region[4,27,4,43]", "-d", "ahd"],
    ["grey", "-w", "user[2.0,1.0,1.5]", "-d", "bilinear", "-s"],
    ["rgb", "-w", "daylight"],
    ["rgb", "-w", "camera", "-r"],
]


@pytest.mark.parametrize("args", CLI_CASES, ids=lambda a: "_".join(a))
def test_dksraw_cli_fits_outputs_equal(dng, tmp_path, args):
    pj, pt = str(tmp_path / "j.fits"), str(tmp_path / "t.fits")
    assert j_dksraw([args[0], dng, "-o", pj] + args[1:]) == 0
    assert t_dksraw([args[0], dng, "-o", pt, "--device", "cpu"]
                    + args[1:]) == 0
    hj, ht = _same_headers(pj, pt)
    assert len(ht) == (4 if args[0] == "rgb" else 1)
    for a, b in zip(hj, ht):
        if a.data is not None:
            diff = np.abs(b.data.astype(np.int64) - a.data.astype(np.int64))
            assert diff.max() <= (3 if "-r" in args else 1)


def _read_png16(path):
    """Decode a 16-bit PNG as ``io/png16`` writes it (one IDAT chunk,
    filter 0 on every scanline)."""
    import struct
    import zlib
    with open(path, "rb") as fh:
        raw = fh.read()
    w, h, depth, color_type = struct.unpack(">IIBB", raw[16:26])
    assert depth == 16
    channels = {0: 1, 2: 3}[color_type]
    at = raw.index(b"IDAT")
    size = struct.unpack(">I", raw[at - 4:at])[0]
    lines = zlib.decompress(raw[at + 4:at + 4 + size])
    rows = np.frombuffer(lines, np.uint8).reshape(h, 1 + w * channels * 2)
    assert not rows[:, 0].any()
    out = np.ascontiguousarray(rows[:, 1:]).view(">u2").astype(np.uint16)
    return out.reshape(h, w, channels).squeeze()


@pytest.mark.parametrize("command", ["grey", "rgb"])
def test_dksraw_cli_png_outputs_equal(dng, tmp_path, command):
    pj, pt = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    assert j_dksraw([command, dng, "-o", pj, "-w", "camera"]) == 0
    assert t_dksraw([command, dng, "-o", pt, "-w", "camera",
                     "--device", "cpu"]) == 0
    got = _read_png16(pt)
    assert got.shape == ((H, W, 3) if command == "rgb" else (H, W))
    _within_one(got, _read_png16(pj))


def test_dksraw_cli_split_outputs_equal(dng, tmp_path):
    assert j_dksraw(["split", dng, "-o", str(tmp_path / "j.fits"),
                     "-e", "fits"]) == 0
    assert t_dksraw(["split", dng, "-o", str(tmp_path / "t.fits"),
                     "-e", "fits", "--device", "cpu"]) == 0
    for band in ("r", "g1", "b", "g2"):
        hj, ht = _same_headers(str(tmp_path / f"j_{band}.fits"),
                               str(tmp_path / f"t_{band}.fits"))
        np.testing.assert_array_equal(ht[0].data, hj[0].data)


def test_dksraw_cli_default_output_name(dng, tmp_path):
    local = str(tmp_path / "copy.dng")
    with open(dng, "rb") as src, open(local, "wb") as dst:
        dst.write(src.read())
    assert t_dksraw(["grey", local, "--device", "cpu"]) == 0
    assert os.path.exists(str(tmp_path / "copy.png"))


@pytest.mark.parametrize("main,extra", [(j_dksraw, []),
                                        (t_dksraw, ["--device", "cpu"])],
                         ids=["jax", "port"])
def test_dksraw_cli_failures_return_1(dng, tmp_path, main, extra):
    out = str(tmp_path / "o.fits")
    assert main(["grey", str(tmp_path / "missing.dng"), "-o", out]
                + extra) == 1
    assert main(["grey", dng, "-o", out, "-w", "user[1,2"] + extra) == 1
    assert main(["grey", dng, "-o", out, "-w", "region[1,2,3]"]
                + extra) == 1
    assert not os.path.exists(out)


def test_dksraw_cli_defaults_to_the_card(dng, tmp_path):
    """Without ``--device cpu`` and without a card the tool fails (exit
    1) and does not carry on somewhere else."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    out = str(tmp_path / "o.fits")
    assert t_dksraw(["grey", dng, "-o", out]) == 1
    assert not os.path.exists(out)


def test_dksraw_cli_reads_a_yaml_config(dng, tmp_path):
    cfg = tmp_path / "cfg.yml"
    cfg.write_text("core:\n  logging: WARNING\n")
    out = str(tmp_path / "o.fits")
    assert t_dksraw(["grey", dng, "-o", out, "-c", str(cfg),
                     "--device", "cpu"]) == 0
    assert os.path.exists(out)
