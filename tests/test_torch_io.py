"""Port parity: the file layer.  A FITS, DNG or PGM file written by one
package is read by the other to the same array and the same header
cards; the lossless-JPEG and PNG encoders produce the same bytes; and
the two places where the port's copy departs from the JAX package on
purpose (the decoder's geometry check before it allocates, the writer's
per-thread temp name) hold."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch

from astrophotography_tpu import synth as jsynth
from astrophotography_tpu.io import fits as jfits
from astrophotography_tpu.io import losslessjpeg as jlj
from astrophotography_tpu.io import png16 as jpng
from astrophotography_tpu.io import raw as jraw
from astrophotography_tpu.io import writer as jwriter
from astrophotography_tpu_torch import device as tdev
from astrophotography_tpu_torch import io as tio
from astrophotography_tpu_torch import synth as tsynth
from astrophotography_tpu_torch.io import fits as tfits
from astrophotography_tpu_torch.io import losslessjpeg as tlj
from astrophotography_tpu_torch.io import png16 as tpng
from astrophotography_tpu_torch.io import raw as traw
from astrophotography_tpu_torch.io import writer as twriter

torch.set_num_threads(1)

H, W = 48, 64
PAIRS = [pytest.param(jfits, tfits, id="jax-writes"),
         pytest.param(tfits, jfits, id="port-writes")]


def _cards(hdr):
    """Every card of a header of either package, in order."""
    return list(hdr._cards)


def _image(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "uint16":
        return rng.integers(0, 65536, (H, W)).astype(np.uint16)
    if kind == "int16":
        return rng.integers(-32768, 32768, (H, W)).astype(np.int16)
    if kind == "int32":
        return rng.integers(-2 ** 31, 2 ** 31, (H, W)).astype(np.int32)
    if kind == "uint8":
        return rng.integers(0, 256, (H, W)).astype(np.uint8)
    if kind == "float64":
        return rng.normal(0, 1e3, (H, W))
    return rng.normal(500, 90, (H, W)).astype(np.float32)


def _header(mod):
    hdr = mod.Header()
    hdr["IMAGETYP"] = ("LIGHT", "frame type")
    hdr["EXPTIME"] = (12.5, "[s] exposure")
    hdr["NFRAMES"] = 7
    hdr["COOLED"] = True
    hdr["OBJECT"] = "M 31 'core'"
    hdr.add_history("written by the file layer test")
    hdr.add_comment("a comment card")
    return hdr


@pytest.mark.parametrize("writer,reader", PAIRS)
@pytest.mark.parametrize("kind", ["uint16", "int16", "int32", "uint8",
                                  "float32", "float64"])
def test_fits_written_by_one_is_read_by_the_other(tmp_path, writer, reader,
                                                  kind):
    data = _image(kind)
    path = str(tmp_path / f"{kind}.fits")
    writer.write_image(path, data, _header(writer))
    hdus_w = writer.open_fits(path)
    hdus_r = reader.open_fits(path)
    assert len(hdus_w) == len(hdus_r) == 1
    assert hdus_r[0].data.dtype == data.dtype
    assert hdus_r[0].data.dtype.isnative
    np.testing.assert_array_equal(hdus_r[0].data, data)
    assert _cards(hdus_r[0].header) == _cards(hdus_w[0].header)
    got, hdr = reader.read_image(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, data.astype(np.float32))


def test_both_packages_write_the_same_fits_bytes(tmp_path):
    for kind in ("uint16", "int16", "float32"):
        data = _image(kind, seed=2)
        a = jfits.HDUList([jfits.ImageHDU(data, _header(jfits))]).tobytes()
        b = tfits.HDUList([tfits.ImageHDU(data, _header(tfits))]).tobytes()
        assert a == b, kind


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_pedestal_is_removed_alike(tmp_path, writer, reader):
    data = _image("uint16", seed=4)
    hdr = _header(writer)
    hdr["PEDESTAL"] = (-100, "value to add to remove the pedestal")
    path = str(tmp_path / "ped.fits")
    writer.write_image(path, data, hdr)
    got_w, hdr_w = writer.read_image(path)
    got_r, hdr_r = reader.read_image(path)
    np.testing.assert_array_equal(got_r, got_w)
    np.testing.assert_array_equal(got_r, data.astype(np.float32) - 100)
    assert _cards(hdr_r) == _cards(hdr_w) and "PEDESTAL" not in hdr_r
    raw_r, hdr_keep = reader.read_image(path, as_float32=False,
                                        remove_pedestal=False)
    assert raw_r.dtype == np.uint16 and hdr_keep["PEDESTAL"] == -100


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_gzipped_fits_and_multi_hdu_round_trip(tmp_path, writer, reader):
    rng = np.random.default_rng(5)
    cols = {"X": rng.uniform(0, 100, 9).astype(np.float32),
            "Y": rng.uniform(0, 100, 9),
            "ID": np.arange(9, dtype=np.int32),
            "OK": rng.uniform(size=9) > 0.5}
    hdus = writer.HDUList([
        writer.ImageHDU(_image("uint16", 6), _header(writer)),
        writer.ImageHDU(_image("float32", 7), name="SIGMA"),
        writer.BinTableHDU(cols, name="STARS"),
    ])
    path = str(tmp_path / "multi.fits.gz")
    hdus.writeto(path)
    back = reader.open_fits(path)
    own = writer.open_fits(path)
    assert [h.name for h in back] == ["", "SIGMA", "STARS"]
    assert "STARS" in back
    for a, b in zip(back, own):
        assert _cards(a.header) == _cards(b.header)
    np.testing.assert_array_equal(back[0].data, own[0].data)
    np.testing.assert_array_equal(back["SIGMA"].data, own["SIGMA"].data)
    for name, col in cols.items():
        np.testing.assert_array_equal(back["STARS"][name], col)
        assert back["STARS"][name].dtype == own["STARS"][name].dtype


def test_read_image_device_moves_the_native_width(tmp_path):
    data = _image("uint16", seed=8)
    hdr = _header(tfits)
    hdr["PEDESTAL"] = -100
    path = str(tmp_path / "dev.fits")
    tfits.write_image(path, data, hdr)
    want, want_hdr = jfits.read_image(path)
    got, got_hdr = tio.read_image_device(path, device="cpu")
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert _cards(got_hdr) == _cards(want_hdr)


def test_read_image_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    path = str(tmp_path / "dev.fits")
    tfits.write_image(path, _image("uint16"))
    with pytest.raises(RuntimeError, match="cuda"):
        tio.read_image_device(path)


@pytest.mark.parametrize("dtype", [">i2", ">u2", ">f4", ">i4", ">f8", "<u2"])
def test_on_device_takes_either_byte_order(dtype):
    """FITS data is big-endian and ``torch.from_numpy`` refuses an array
    that is not in native order: ``on_device`` converts."""
    arr = (np.arange(24).reshape(4, 6) * 37 % 251).astype(dtype)
    t = tdev.on_device(arr, torch.device("cpu"))
    assert t.shape == (4, 6)
    np.testing.assert_array_equal(t.numpy(), arr.astype(arr.dtype.newbyteorder("=")))
    f = tdev.to_float32(t)
    np.testing.assert_array_equal(f.numpy(), arr.astype(np.float32))
    strided = tdev.on_device(arr[:, ::2], torch.device("cpu"))
    np.testing.assert_array_equal(strided.numpy(), arr[:, ::2])


def test_to_uint16_clips_and_truncates():
    x = torch.tensor([-5.0, 0.0, 0.9, 1.5, 32767.9, 32768.0, 65534.99,
                      65535.0, 7e4])
    want = np.clip(x.numpy(), 0, 65535).astype(np.uint16)
    got = tdev.to_uint16(x)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(got.numpy(), want)


def _scene_mosaic(seed=1, shape=(H, W)):
    scene = jsynth.make_rgb_scene(shape, seed=seed, peak=12000)
    return jsynth.mosaic_from_rgb(scene, black_levels=(64, 60, 66, 62),
                                  wb_gains=(2.0, 1.0, 1.5, 1.0))


def _same_raw(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def test_synth_copies_agree():
    for seed in (0, 3):
        np.testing.assert_array_equal(
            tsynth.make_rgb_scene((H, W), seed=seed),
            jsynth.make_rgb_scene((H, W), seed=seed))
    np.testing.assert_array_equal(tsynth.bayer_color_map((H, W)),
                                  jsynth.bayer_color_map((H, W)))
    a, ta = tsynth.make_starfield((H, W), n_stars=9, seed=2)
    b, tb = jsynth.make_starfield((H, W), n_stars=9, seed=2)
    np.testing.assert_array_equal(a, b)
    assert sorted(ta) == sorted(tb)
    np.testing.assert_array_equal(tsynth.make_dark((H, W), seed=4)[0],
                                  jsynth.make_dark((H, W), seed=4)[0])


@pytest.mark.parametrize("writer,reader", [
    pytest.param(jraw, traw, id="jax-writes"),
    pytest.param(traw, jraw, id="port-writes")])
@pytest.mark.parametrize("compression", [1, 7])
def test_dng_written_by_one_is_read_by_the_other(tmp_path, writer, reader,
                                                 compression):
    mosaic = _scene_mosaic()
    path = str(tmp_path / f"c{compression}.dng")
    writer.write_dng(path, mosaic, black_levels=(64, 60, 66, 62),
                     white_level=16383, camera_wb=(2.1, 1.0, 1.4, 1.0),
                     exif={"Make": "Synth", "ISOSpeedRatings": 800,
                           "ExposureTime": 0.5},
                     compression=compression)
    own = writer.load_dng(path)
    other = reader.load_raw(path)
    np.testing.assert_array_equal(other.mosaic, mosaic)
    _same_raw(own, other)


def test_both_packages_write_the_same_dng_bytes(tmp_path):
    mosaic = _scene_mosaic(seed=2)
    for compression in (1, 7):
        pa, pb = (str(tmp_path / f"{n}{compression}.dng") for n in "ab")
        jraw.write_dng(pa, mosaic, compression=compression)
        traw.write_dng(pb, mosaic, compression=compression)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()


def test_pgm_and_fits_mosaics_load_alike(tmp_path):
    mosaic = _scene_mosaic(seed=3)
    pgm = str(tmp_path / "m.pgm")
    with open(pgm, "wb") as fh:
        fh.write(b"P5\n# dcraw -D -4\n%d %d\n65535\n" % (W, H))
        fh.write(mosaic.astype(">u2").tobytes())
    for pattern in ("RGGB", "GBRG"):
        _same_raw(jraw.load_raw(pgm, pattern=pattern),
                  traw.load_raw(pgm, pattern=pattern))
    np.testing.assert_array_equal(traw.load_pgm(pgm).mosaic, mosaic)
    fit = str(tmp_path / "m.fits")
    hdr = tfits.Header()
    hdr["BAYERPAT"] = "RGGB"
    tfits.write_image(fit, mosaic, hdr)
    _same_raw(jraw.load_fits_mosaic(fit), traw.load_fits_mosaic(fit))


@pytest.mark.parametrize("ncomp,predictor,restart", [
    (1, 1, 0), (2, 1, 0), (1, 4, 0), (1, 1, 16), (2, 6, 8)])
def test_lossless_jpeg_bytes_equal_and_decode(ncomp, predictor, restart):
    mosaic = _scene_mosaic(seed=4)
    a = jlj.encode_lossless_jpeg(mosaic, ncomp=ncomp, predictor=predictor,
                                 restart_interval=restart)
    b = tlj.encode_lossless_jpeg(mosaic, ncomp=ncomp, predictor=predictor,
                                 restart_interval=restart)
    assert a == b
    np.testing.assert_array_equal(tlj.decode_lossless_jpeg(a, H, W), mosaic)
    np.testing.assert_array_equal(jlj.decode_lossless_jpeg(b, H, W), mosaic)
    assert tlj.native_loaded()


def test_native_library_is_built_outside_the_package():
    """No binary beside the sources: the library is built into the
    checkout's build directory, named by a hash of its source."""
    tlj._load()
    so = tlj._so_path()
    assert os.path.exists(so)
    assert os.path.basename(os.path.dirname(so)) == "torch_native"
    pkg = os.path.dirname(os.path.dirname(tlj.__file__))
    assert not so.startswith(pkg + os.sep)
    assert not [f for f in os.listdir(os.path.join(pkg, "native"))
                if f.endswith(".so")]


def test_python_entropy_fallback_is_byte_identical(monkeypatch):
    mosaic = _scene_mosaic(seed=5, shape=(16, 32))
    want = tlj.encode_lossless_jpeg(mosaic)

    def no_toolchain():
        raise OSError("no compiler")
    monkeypatch.setattr(tlj, "_load", no_toolchain)
    assert tlj.encode_lossless_jpeg(mosaic) == want


def _patch_sof(payload, height, width):
    """The stream with its frame header's geometry overwritten."""
    raw = bytearray(payload)
    at = raw.index(b"\xff\xc3")
    raw[at + 5:at + 9] = bytes([height >> 8, height & 255,
                                width >> 8, width & 255])
    return bytes(raw)


def test_decoder_checks_the_geometry_before_it_allocates(monkeypatch):
    """Carried fix: the JAX package's decoder allocates height * width
    samples for any claimed geometry up to 2^31 before it has looked at
    the stream.  The port's holds the claim against the frame header and
    the payload's length first, and allocates nothing when they
    disagree."""
    payload = tlj.encode_lossless_jpeg(_scene_mosaic(seed=6))
    allocated = []
    real_zeros = np.zeros

    def watching(shape, *a, **k):
        allocated.append(int(np.prod(shape)))
        return real_zeros(shape, *a, **k)
    monkeypatch.setattr(tlj.np, "zeros", watching)
    # the container claims a huge sensor, the stream is 48 x 64
    with pytest.raises(ValueError, match="does not match"):
        tlj.decode_lossless_jpeg(payload, 40000, 50000)
    # container and frame header both claim it: the payload is too short
    with pytest.raises(ValueError, match="cannot hold"):
        tlj.decode_lossless_jpeg(_patch_sof(payload, 40000, 50000),
                                 40000, 50000)
    assert not allocated
    with pytest.raises(ValueError, match="implausible"):
        tlj.decode_lossless_jpeg(payload, 1 << 16, 1 << 16)
    # a stream without a frame header gets the native parser's verdict
    # and a token buffer
    with pytest.raises(ValueError, match="decode failed"):
        tlj.decode_lossless_jpeg(b"\xff\xd8\xff\xd9", 40000, 50000)
    assert max(allocated) <= 16
    monkeypatch.undo()
    np.testing.assert_array_equal(tlj.decode_lossless_jpeg(payload, H, W),
                                  _scene_mosaic(seed=6))
    # both packages refuse the same inputs with the same exception type
    for bad in (payload[:200], b"\xff\xd8\xff\xd9", b"junk"):
        with pytest.raises(ValueError):
            jlj.decode_lossless_jpeg(bad, H, W)
        with pytest.raises(ValueError):
            tlj.decode_lossless_jpeg(bad, H, W)


def test_writer_temp_name_is_per_thread(tmp_path, monkeypatch):
    """Carried fix: the JAX package names its temp file per process, so
    two threads publishing the same path share it.  The port's name
    carries the thread too; concurrent writers each publish a whole
    file."""
    seen = []
    real_replace = os.replace

    def watching(src, dst):
        seen.append((threading.get_ident(), src))
        return real_replace(src, dst)
    monkeypatch.setattr(tfits.os, "replace", watching)
    path = str(tmp_path / "shared.fits")
    frames = [_image("float32", seed=s) for s in range(4)]
    barrier = threading.Barrier(4)

    def work(frame):
        barrier.wait(timeout=30)
        for _ in range(5):
            tfits.write_image(path, frame)
    threads = [threading.Thread(target=work, args=(f,)) for f in frames]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    names = {}
    for ident, src in seen:
        names.setdefault(ident, set()).add(src)
    assert len(names) == 4
    all_names = [n for s in names.values() for n in s]
    assert len(set(all_names)) == 4          # one name per thread, none shared
    assert all(str(os.getpid()) in n for n in all_names)
    got, _ = tfits.read_image(path)
    assert any(np.array_equal(got, f) for f in frames)
    assert os.listdir(tmp_path) == ["shared.fits"]


@pytest.mark.parametrize("shape", [(H, W), (H, W, 3)])
def test_png16_bytes_equal(tmp_path, shape):
    data = np.random.default_rng(9).integers(0, 65536, shape) \
        .astype(np.uint16)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    jpng.write_png16(pa, data)
    tpng.write_png16(pb, data)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("name", ["grey.fits", "rgb.fits", "grey.png"])
def test_file_writer_outputs_equal(tmp_path, name):
    rng = np.random.default_rng(10)
    shape = (H, W, 3) if name.startswith("rgb") else (H, W)
    data = rng.integers(0, 65536, shape).astype(np.uint16)
    exif = {"Make": "Synth", "Model": "S1", "ISOSpeedRatings": 400,
            "ExposureTime": 0.25, "FNumber": 4.0,
            "DateTimeOriginal": "2021:03:04 05:06:07"}
    pa, pb = str(tmp_path / ("a_" + name)), str(tmp_path / ("b_" + name))
    jwriter.file_writer(pa, data, exif)
    twriter.file_writer(pb, data, exif)
    if name.endswith(".png"):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()
        return
    ha, hb = jfits.open_fits(pa), tfits.open_fits(pb)
    assert len(ha) == len(hb)
    for a, b in zip(ha, hb):
        cards_a = [c for c in _cards(a.header) if c[0] != "DATE"]
        cards_b = [c for c in _cards(b.header) if c[0] != "DATE"]
        assert cards_a == cards_b
        if a.data is not None:
            np.testing.assert_array_equal(a.data, b.data)
    assert twriter.determine_file_type("x.FIT") \
        == jwriter.determine_file_type("x.FIT")
    with pytest.raises(ValueError):
        twriter.determine_file_type("x.xyz")


# -- utils: the host foundation under every engine and tool --------------

def test_yaml_config_loads_like_the_jax_package(tmp_path):
    from astrophotography_tpu.utils.config import YamlConfig as JConfig
    from astrophotography_tpu_torch.utils.config import YamlConfig as TConfig

    a, b = tmp_path / "a.yml", tmp_path / "b.yml"
    a.write_text("core:\n  logging: INFO\n  root: /data\n"
                 "paths:\n  raw: '%core.root;/raw'\n")
    b.write_text("core:\n  logging: DEBUG\npaths:\n  out: '%paths.raw;/out'\n")
    want = JConfig().load([str(a), str(b)])
    got = TConfig().load([str(a), str(b)])
    assert got == want
    assert got.paths.out == "/data/raw/out" and got.core.logging == "DEBUG"
    bad = tmp_path / "bad.yml"
    bad.write_text("- 1\n- 2\n")
    with pytest.raises(ValueError, match="must contain a mapping"):
        TConfig().load(str(bad))


def test_logger_has_its_own_root_and_lifecycle():
    import io
    from astrophotography_tpu_torch.utils import get_logger, logger

    child = get_logger("io.test")
    assert child.name == "astrophotography_tpu_torch.io.test"
    stream = io.StringIO()
    logger.start("WARNING", stream=stream)
    try:
        assert logger.running
        child.info("quiet")
        child.warning("loud")
    finally:
        logger.stop()
    assert "loud" in stream.getvalue() and "quiet" not in stream.getvalue()
    assert not logger.running


def test_stage_timer_and_device_trace(tmp_path):
    from astrophotography_tpu_torch.utils import StageTimer, device_trace

    timer = StageTimer()
    with timer.stage("convert", pixels=10 ** 6, bytes_=2 * 10 ** 6):
        pass
    with timer.stage("write"):
        pass
    assert [r["stage"] for r in timer.records] == ["convert", "write"]
    assert "gpix_per_s" in timer.records[0] and "TOTAL" in timer.report()
    with device_trace(None):                 # no directory: nothing written
        pass
    trace_dir = tmp_path / "trace"
    with device_trace(str(trace_dir)):
        torch.ones(8).sum()
    assert (trace_dir / "trace.json").stat().st_size > 0
