"""Calibration's kernel (``csrc/calibrate.cu``) and its twin
``ops/calibrate.calibrate_batch_plain``.

On the CPU: the dispatch (CPU tensors take the twin and return what it
returns, nothing reaches the launcher), no fallback on other devices, the
launcher's refusals, the C entry's signature against its ctypes binding,
and the kernel's per-pixel rule restated in numpy float32 (each operation
rounded on its own, a missing master skipped) against the twin bit for
bit.  The kernel itself runs on the card, in ``tests/test_torch_gpu.py``
(``-k calibrate``, marker ``gpu``).
"""

import re

import numpy as np
import pytest
import torch

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import calibrate as cb

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)


def _inputs(n, h, w, seed, dtype="uint16"):
    """numpy (raw, bias, dark, flat, ratios): raw over the uint16 range
    with 0 and 65535 in it (float32: a -0, a NaN and an inf besides), a
    flat with zeros, NaNs and negative values."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 65536, (n, h, w))
    raw.reshape(-1)[:2] = (0, 65535)
    if dtype == "uint16":
        raw = raw.astype(np.uint16)
    elif dtype == "int16":
        raw = (raw - 32768).astype(np.int16)
    else:
        raw = (raw + rng.uniform(-1.0, 1.0, raw.shape)).astype(np.float32)
        raw.reshape(-1)[2:5] = (-0.0, np.nan, np.inf)
    bias = (300.0 + rng.normal(0.0, 3.0, (h, w))).astype(np.float32)
    dark = (bias + 40.0 + rng.exponential(5.0, (h, w))).astype(np.float32)
    flat = (1.0 + rng.normal(0.0, 0.05, (h, w))).astype(np.float32)
    odd = rng.choice(h * w, size=min(h * w, 9), replace=False)
    flat.reshape(-1)[odd[:3]] = 0.0
    flat.reshape(-1)[odd[3:6]] = np.nan
    flat.reshape(-1)[odd[6:]] = -rng.uniform(0.5, 2.0, len(odd[6:]))
    ratios = rng.uniform(0.2, 2.0, n).astype(np.float32)
    return raw, bias, dark, flat, ratios


def _tensor(raw):
    if raw.dtype == np.uint16:
        return torch.from_numpy(raw.view(np.int16)).view(torch.uint16)
    return torch.from_numpy(raw)


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    gn, wn = torch.isnan(got), torch.isnan(want)
    assert torch.equal(gn, wn)
    assert torch.equal(torch.where(gn, 0.0, got).view(torch.int32),
                       torch.where(wn, 0.0, want).view(torch.int32))


CASES = {
    "uint16": dict(),
    "float32": dict(dtype="float32"),
    "int16": dict(dtype="int16"),
    "no_bias": dict(drop=("bias",)),
    "no_dark": dict(drop=("dark",)),
    "no_flat": dict(drop=("flat",)),
    "no_masters": dict(drop=("bias", "dark", "flat")),
    "dark_not_biased": dict(dark_still_biased=False),
    "no_ratios": dict(drop=("ratios",)),
}


def _case(name, n=3, h=16, w=24):
    c = dict(CASES[name])
    raw, bias, dark, flat, ratios = _inputs(n, h, w, seed=len(name),
                                            dtype=c.get("dtype", "uint16"))
    kw = dict(bias=bias, dark=dark, flat=flat, exp_ratios=ratios)
    for k in c.get("drop", ()):
        kw["exp_ratios" if k == "ratios" else k] = None
    return raw, kw, c.get("dark_still_biased", True)


@pytest.mark.parametrize("badpix", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_cpu_tensors_take_the_twin(monkeypatch, name, badpix):
    """On the CPU ``calibrate_batch`` is the twin, bit for bit, and nothing
    reaches the launcher or its count."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel launcher")

    monkeypatch.setattr(kernels, "calibrate_cuda", refuse)
    before = dict(kernels.launch_counts)
    raw, kw, dsb = _case(name)
    kw = {k: None if v is None else torch.from_numpy(v)
          for k, v in kw.items()}
    mask = (torch.from_numpy(np.random.default_rng(1).random((16, 24))
                             < 0.05) if badpix else None)
    imgs = _tensor(raw)
    got = cb.calibrate_batch(imgs, dark_still_biased=dsb, badpix_mask=mask,
                             **kw)
    want = cb.calibrate_batch_plain(imgs, dark_still_biased=dsb,
                                    badpix_mask=mask, **kw)
    _same_bits(got, want)
    assert got.dtype == torch.float32
    assert dict(kernels.launch_counts) == before


def test_cpu_float32_without_masters_is_the_stack_itself():
    """As before: a float32 stack without masters or mask comes back as
    the same tensor; with a mask, repaired in a copy."""
    raw = _inputs(2, 16, 24, seed=4, dtype="float32")[0]
    imgs = torch.from_numpy(raw)
    assert cb.calibrate_batch(imgs) is imgs
    mask = torch.zeros((16, 24), dtype=torch.bool)
    mask[3, 4] = True
    fixed = cb.calibrate_batch(imgs, badpix_mask=mask)
    assert fixed is not imgs
    _same_bits(imgs, torch.from_numpy(raw))         # left as it was


def test_numpy_inputs_reach_the_twin():
    """numpy masters on a CPU stack: the twin on tensors of them."""
    raw, kw, dsb = _case("uint16")
    got = cb.calibrate_batch(_tensor(raw), **kw)
    want = cb.calibrate_batch_plain(
        _tensor(raw), **{k: torch.from_numpy(v) for k, v in kw.items()})
    _same_bits(got, want)


def test_no_fallback_on_other_devices():
    imgs = torch.empty((2, 8, 8), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="no calibrate kernel"):
        cb.calibrate_batch(imgs, bias=torch.empty((8, 8), device="meta"))


def test_launcher_refuses_what_the_kernel_does_not_take():
    imgs = torch.zeros((3, 8, 16), dtype=torch.float32)
    m = torch.zeros((8, 16))
    r = torch.ones(3)
    with pytest.raises(ValueError, match="uint16 or float32 stack"):
        kernels.calibrate_cuda(imgs.double(), m, m, m, r, True)
    with pytest.raises(ValueError, match="uint16 or float32 stack"):
        kernels.calibrate_cuda(imgs[0], m, m, m, r, True)
    with pytest.raises(ValueError, match="bias must be float32 \\(8, 16\\)"):
        kernels.calibrate_cuda(imgs, m[:, :8], m, m, r, True)
    with pytest.raises(ValueError, match="dark must be float32"):
        kernels.calibrate_cuda(imgs, m, m[None], m, r, True)
    with pytest.raises(ValueError, match="flat must be float32"):
        kernels.calibrate_cuda(imgs, m, m, m.double(), r, True)
    with pytest.raises(ValueError, match="flat must be float32 .* on cpu"):
        kernels.calibrate_cuda(imgs, None, None, m.to("meta"), None, True)
    with pytest.raises(ValueError, match="exp_ratios must have shape"):
        kernels.calibrate_cuda(imgs, m, m, m, torch.ones(4), True)
    with pytest.raises(ValueError, match="exp_ratios is on meta"):
        kernels.calibrate_cuda(imgs, m, m, m, r.to("meta"), True)


def test_c_entry_matches_its_binding():
    """``calibrate_launch``'s C parameters against the ctypes argtypes set
    in ``kernels._load`` (which only the card's build can call)."""
    src = (kernels._SRC / kernels._SOURCES["calibrate"]).read_text()
    sig = re.search(r'extern "C" int calibrate_launch\(([^)]*)\)', src)
    params = [p.split()[-1].lstrip("*") for p in sig.group(1).split(",")]
    assert params == ["raw", "is_u16", "bias", "dark", "flat", "ratios",
                      "dark_still_biased", "n", "plane", "out", "stream"]
    text = open(kernels.__file__).read()
    bound = re.search(r'libs\["calibrate"\]\.calibrate_launch\n\s*'
                      r'fn\.argtypes = \[([^\]]*)\]', text).group(1)
    assert [a.strip() for a in bound.split(",")] == \
        ["p", "i", "p", "p", "p", "p", "i", "i", "q", "p", "p"]


def _restated(raw, bias, dark, flat, ratios, dsb):
    """The kernel's per-pixel rule (csrc/calibrate.cu, ``calib``) in numpy
    float32, one rounding an operation, each master only where given."""
    f32 = np.float32
    x = raw.astype(f32)
    d = None
    if dark is not None:
        d = dark - bias if (dsb and bias is not None) else dark
    out = np.empty(x.shape, f32)
    for n in range(x.shape[0]):
        v = x[n].copy()
        if bias is not None:
            v = (v - bias).astype(f32)
        if d is not None:
            r = f32(1.0) if ratios is None else ratios[n]
            v = (v - (r * d).astype(f32)).astype(f32)
        if flat is not None:
            with np.errstate(divide="ignore", invalid="ignore"):
                v = np.where(flat != 0, (v / flat).astype(f32), v)
        out[n] = v
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_rule_restated_equals_the_twin(name):
    raw, kw, dsb = _case(name, n=4, h=7, w=13)
    want = cb.calibrate_batch_plain(
        _tensor(raw), dark_still_biased=dsb,
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in kw.items()})
    got = _restated(raw, kw["bias"], kw["dark"], kw["flat"],
                    kw["exp_ratios"], dsb)
    _same_bits(torch.from_numpy(got), want)
