"""The port's ops take numpy arrays, as the JAX package's ops do.

Each op converts a numpy argument once, at its entry
(``device.numpy_inputs``), to a tensor on the device the call's tensors
are on, or, where it gives none, on ``device.resolve_device(None)``: the
card, and without one the ``RuntimeError`` that names it.  Here, with no
card, an all-numpy call raises; with ``resolve_device`` patched to the
CPU it equals the call with tensors.  The bodies of
tests/test_properties.py run on the port's ops with numpy inputs."""

import importlib

import numpy as np
import pytest
import torch

from astrophotography_tpu_torch import device, synth
from astrophotography_tpu_torch.ops import (
    auto_badcols, background2d, calibrate_batch, calibrate_frame,
    demosaic_bilinear, extract_cutouts, find_stars, fix_bad_pixels, mad_std,
    masked_median, nearest_neighbor_dist, percentile_renorm,
    safe_subtract_black, sigma_clip_combine, sigma_clip_mask,
    sigma_clipped_stats, sigmaclip_badpix_mask, source_mask)
from astrophotography_tpu_torch.ops.clip_combine import clip_combine
from astrophotography_tpu_torch.ops.composite import stretch_channels
from astrophotography_tpu_torch.ops.photometry import aperture_photometry
from astrophotography_tpu_torch.ops.warp import warp_affine_lanczos3

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

imarith = importlib.import_module("astrophotography_tpu_torch.ops.imarith") \
    .imarith


def _inputs():
    rng = np.random.default_rng(7)
    img = rng.uniform(100, 1000, (32, 32)).astype(np.float32)
    stack = rng.normal(50, 5, (6, 32, 32)).astype(np.float32)
    yy, xx = np.mgrid[0:32, 0:32]
    field = (200 + 5000 * np.exp(-((xx - 12.3) ** 2 + (yy - 17.6) ** 2) / 4.0)
             + rng.normal(0, 3, (32, 32))).astype(np.float32)
    return {
        "img": img, "stack": stack, "field": field,
        "bias": rng.uniform(10, 20, (32, 32)).astype(np.float32),
        "dark": rng.uniform(1, 3, (32, 32)).astype(np.float32),
        "flat": rng.uniform(0.8, 1.2, (32, 32)).astype(np.float32),
        "mask": rng.uniform(size=(6, 32, 32)) > 0.2,
        "bad": rng.uniform(size=(32, 32)) > 0.97,
        "mosaic": rng.integers(0, 4000, (32, 32)).astype(np.uint16),
        "cmap": synth.bayer_color_map((32, 32)),
        # float64, as numpy makes them: the port takes them as float32,
        # as jnp.asarray does
        "blacks": np.array([1024.0, 900.0, 1100.0, 950.0]),
        "xs": np.array([12.3, 20.0, 5.5], np.float32),
        "ys": np.array([17.6, 8.0, 25.0], np.float32),
        "valid": np.array([True, True, False]),
        "mat": np.array([[1.0, 0.02, 0.5], [-0.02, 1.0, -0.25]], np.float32),
        "rgb": rng.uniform(0, 1000, (3, 32, 32)).astype(np.float32),
    }


#: (name, op, positional array arguments, keyword array arguments,
#: other arguments): one call of each op the repair covers
OPS = [
    ("calibrate_frame", calibrate_frame, ("img",),
     {"bias": "bias", "dark": "dark", "flat": "flat"}, {"exp_ratio": 2.0}),
    ("calibrate_batch", calibrate_batch, ("stack",),
     {"bias": "bias", "flat": "flat"}, {}),
    ("imarith", imarith, ("img",), {}, {"op": "SUB", "value": 3.5}),
    ("imarith array", lambda a, b: imarith(a, "DIV", b), ("img", "flat"), {},
     {}),
    ("sigma_clip_combine", sigma_clip_combine, ("stack",), {"mask": "mask"},
     {}),
    ("clip_combine", clip_combine, ("stack",), {"mask": "mask"}, {}),
    ("fix_bad_pixels", fix_bad_pixels, ("img", "bad"), {}, {}),
    ("find_stars", find_stars, ("field",), {},
     {"threshold": 50.0, "max_stars": 8}),
    ("sigma_clipped_stats", sigma_clipped_stats, ("img",), {}, {}),
    ("sigma_clip_mask", sigma_clip_mask, ("stack",), {"mask": "mask"},
     {"axis": 0}),
    ("masked_median", masked_median, ("stack", "mask"), {}, {"axis": 0}),
    ("mad_std", mad_std, ("img",), {}, {}),
    ("sigmaclip_badpix_mask", sigmaclip_badpix_mask, ("img",), {}, {}),
    ("auto_badcols", auto_badcols, ("img",), {}, {}),
    ("safe_subtract_black", safe_subtract_black,
     ("mosaic", "cmap", "blacks"), {}, {}),
    ("demosaic_bilinear", demosaic_bilinear, ("img", "cmap"), {}, {}),
    ("background2d", background2d, ("field",), {},
     {"nboxes_y": 4, "nboxes_x": 4}),
    ("source_mask", source_mask, ("field",), {}, {}),
    ("aperture_photometry", aperture_photometry,
     ("field", "xs", "ys", "valid"), {}, {"r_ap": 3, "r_out": 6}),
    ("extract_cutouts", extract_cutouts, ("field", "xs", "ys"), {},
     {"box": 8}),
    ("nearest_neighbor_dist", nearest_neighbor_dist, ("xs", "ys", "valid"),
     {}, {}),
    ("warp_affine_lanczos3", warp_affine_lanczos3, ("img", "mat"), {},
     {"out_shape": (32, 32)}),
    ("stretch_channels", stretch_channels, ("rgb",), {}, {}),
    ("percentile_renorm", percentile_renorm, ("img",), {}, {}),
]
IDS = [o[0] for o in OPS]


def _call(op, pos, kw, other, inputs, convert):
    return op(*(convert(inputs[k]) for k in pos),
              **{k: convert(inputs[v]) for k, v in kw.items()}, **other)


def _as_tensor(a):
    t = torch.from_numpy(a)
    return t.to(torch.float32) if t.dtype == torch.float64 else t


def _same(a, b):
    if isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.device == b.device and a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    else:
        assert a == b


@pytest.fixture
def on_cpu(monkeypatch):
    """``resolve_device`` sends device-less calls to the CPU."""
    monkeypatch.setattr(device, "resolve_device",
                        lambda d=None: torch.device("cpu" if d is None else d))


@pytest.mark.parametrize("name,op,pos,kw,other", OPS, ids=IDS)
def test_numpy_call_without_a_card_raises(monkeypatch, name, op, pos, kw,
                                          other):
    """An all-numpy call goes to the card; without one it raises the
    RuntimeError that names it, and never computes on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="'cuda'"):
        _call(op, pos, kw, other, _inputs(), lambda a: a)


@pytest.mark.parametrize("name,op,pos,kw,other", OPS, ids=IDS)
def test_numpy_call_equals_tensor_call(on_cpu, name, op, pos, kw, other):
    """With the default device on the CPU the numpy call is the tensor
    call (float64 arrays taken as float32, as jnp.asarray takes them)."""
    inputs = _inputs()
    _same(_call(op, pos, kw, other, inputs, lambda a: a),
          _call(op, pos, kw, other, inputs, _as_tensor))


def test_numpy_arguments_follow_the_tensors():
    """Beside a tensor, a numpy argument goes to the tensor's device
    (no patch: the CPU here because the caller put the image there)."""
    inputs = _inputs()
    img = torch.from_numpy(inputs["img"])
    got = calibrate_frame(img, bias=inputs["bias"], flat=inputs["flat"])
    want = calibrate_frame(img, bias=torch.from_numpy(inputs["bias"]),
                           flat=torch.from_numpy(inputs["flat"]))
    _same(got, want)


def test_tensors_on_two_devices_are_refused():
    """A call whose tensors disagree on the device is refused before any
    numpy argument is placed."""
    inputs = _inputs()
    meta = torch.empty((32, 32), device="meta")
    with pytest.raises(ValueError, match="meta"):
        calibrate_frame(torch.from_numpy(inputs["img"]), bias=meta,
                        flat=inputs["flat"])


def test_uint16_and_byte_order(on_cpu):
    """uint16 crosses as it is, and a big-endian array (FITS data) is
    taken in native order."""
    inputs = _inputs()
    mosaic = inputs["mosaic"]
    got = safe_subtract_black(mosaic.astype(">u2"), inputs["cmap"],
                              inputs["blacks"])
    want = safe_subtract_black(torch.from_numpy(mosaic),
                               torch.from_numpy(inputs["cmap"]),
                               torch.from_numpy(inputs["blacks"])
                               .to(torch.float32))
    _same(got, want)


# -- tests/test_properties.py's bodies on the port's ops, numpy inputs --

def test_flat_of_ones_is_identity(on_cpu):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1000, (16, 16)).astype(np.float32)
    out = np.asarray(calibrate_frame(img, flat=np.ones((16, 16), np.float32)))
    np.testing.assert_allclose(out, img, rtol=1e-6)


def test_zero_bias_dark_identity(on_cpu):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1000, (16, 16)).astype(np.float32)
    z = np.zeros((16, 16), np.float32)
    out = np.asarray(calibrate_frame(img, bias=z, dark=z, exp_ratio=7.3))
    np.testing.assert_allclose(out, img, rtol=1e-6)


def test_calibration_linearity(on_cpu):
    """calibrate(a*img) with zero dark == a * calibrate(img) + bias terms."""
    rng = np.random.default_rng(2)
    img = rng.uniform(100, 1000, (16, 16)).astype(np.float32)
    bias = rng.uniform(10, 20, (16, 16)).astype(np.float32)
    flat = rng.uniform(0.5, 1.5, (16, 16)).astype(np.float32)
    out1 = np.asarray(calibrate_frame(img, bias=bias, flat=flat))
    out2 = np.asarray(calibrate_frame(2 * img - bias, bias=bias, flat=flat))
    np.testing.assert_allclose(out2, 2 * out1, rtol=1e-5)


def test_safe_subtract_never_negative(on_cpu):
    rng = np.random.default_rng(3)
    mosaic = rng.integers(0, 2000, (32, 32)).astype(np.uint16)
    cmap = synth.bayer_color_map((32, 32))
    blacks = np.array([1024.0, 900.0, 1100.0, 950.0])
    out = np.asarray(safe_subtract_black(mosaic, cmap, blacks))
    assert (out >= 0).all()
    # values above black subtract exactly
    above = mosaic.astype(np.float64) - blacks[cmap] > 0
    np.testing.assert_allclose(out[above],
                               (mosaic.astype(np.float64)
                                - blacks[cmap])[above])


def test_combine_of_identical_frames_is_identity(on_cpu):
    rng = np.random.default_rng(4)
    frame = rng.uniform(0, 100, (24, 24)).astype(np.float32)
    stack = np.repeat(frame[None], 8, axis=0)
    out = np.asarray(sigma_clip_combine(stack))
    np.testing.assert_allclose(out, frame, rtol=1e-6)


def test_combine_permutation_invariant(on_cpu):
    rng = np.random.default_rng(5)
    stack = rng.normal(50, 5, (10, 16, 16)).astype(np.float32)
    out1 = np.asarray(sigma_clip_combine(stack))
    out2 = np.asarray(sigma_clip_combine(stack[::-1].copy()))
    np.testing.assert_allclose(out1, out2, rtol=1e-6)


def test_imarith_inverses(on_cpu):
    rng = np.random.default_rng(6)
    img = rng.uniform(1, 100, (8, 8)).astype(np.float32)
    other = rng.uniform(1, 10, (8, 8)).astype(np.float32)
    added = imarith(img, "ADD", other)
    np.testing.assert_allclose(np.asarray(imarith(added, "SUB", other)),
                               img, rtol=1e-6)
    mul = imarith(img, "MUL", other)
    np.testing.assert_allclose(np.asarray(imarith(mul, "DIV", other)),
                               img, rtol=1e-5)
