"""Port parity: ``ap_stack`` (each engine and the union canvas) and
``ap_reduce`` run on the same files and argv as their JAX twins (the
port's with ``--device cpu``), on ``tests/test_torch_reduce.py``'s
observing run.  ``ap_stack`` stacks the R group: mixed exposures (FSCALE
from EXPTIME) and small field rotations.

Stacks agree within the unfused parity rule (median |diff| < 1e-3, > 1
ADU on under 0.5 % of the pixels), weight maps within 1e-5, headers
exactly but for the HISTORY lines (they carry the run's seconds).
"""

import glob
import os

import numpy as np
import pytest
import torch

from astrophotography_tpu.cli import ap_reduce as j_reduce
from astrophotography_tpu.cli import ap_stack as j_stack
from astrophotography_tpu.io.fits import read_image
from astrophotography_tpu_torch.cli import ap_reduce as t_reduce
from astrophotography_tpu_torch.cli import ap_stack as t_stack
from tests.test_torch_reduce import _make_dataset

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
QUIET = ["-l", "ERROR"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("stack")
    return _make_dataset(root)


def _same_stack(got_path, want_path, rule=True):
    got, gh = read_image(got_path)
    want, wh = read_image(want_path)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    if rule:
        assert np.median(diff) < 1e-3
        assert (diff > 1.0).mean() < 0.005
        assert (got != 0).mean() > 0.7      # the union canvas has margins
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert [c for c in gh._cards if c[0] != "HISTORY"] == \
        [c for c in wh._cards if c[0] != "HISTORY"]
    return got, gh


@pytest.mark.parametrize("extra", [
    ["--engine", "xla"],
    ["--engine", "pallas"],
    ["--engine", "fused"],
    ["--canvas", "union", "--combine", "median"],
    ["--engine", "pallas", "--no-fscale", "--ref_frame", "1"],
], ids=["xla", "pallas", "fused", "union", "pallas-nofscale-ref1"])
def test_ap_stack(dataset, tmp_path, extra):
    datadir, _caldir = dataset
    frames = sorted(glob.glob(os.path.join(datadir, "lightR*.fits")))
    outs = {t: (str(tmp_path / f"{t}.fits"), str(tmp_path / f"{t}w.fits"))
            for t in ("j", "t")}
    argv = lambda o: frames + ["-o", o[0], "--weight_out", o[1]] + extra
    assert j_stack.main(argv(outs["j"]) + QUIET) == 0
    assert t_stack.main(argv(outs["t"]) + QUIET + CPU) == 0
    _, hdr = _same_stack(outs["t"][0], outs["j"][0])
    _same_stack(outs["t"][1], outs["j"][1], rule=False)
    assert hdr["NSTACK"] == 3
    if "--no-fscale" not in extra:
        assert hdr["EXPTOTAL"] == 300.0
    if "union" in extra:
        assert "CANVASX0" in hdr and hdr["CRPIX1"] != 64.5


def test_ap_stack_errors(dataset, tmp_path):
    datadir, caldir = dataset
    one = sorted(glob.glob(os.path.join(datadir, "lightR*.fits")))[:1]
    out = str(tmp_path / "o.fits")
    assert j_stack.main(one + ["-o", out] + QUIET) == 1
    assert t_stack.main(one + ["-o", out] + QUIET + CPU) == 1
    odd = one + [os.path.join(caldir, "master_bias.fits"),
                 str(tmp_path / "missing.fits")]
    assert j_stack.main(odd + ["-o", out] + QUIET) == 1
    assert t_stack.main(odd + ["-o", out] + QUIET + CPU) == 1
    assert not os.path.exists(out)


def test_ap_reduce(dataset, tmp_path):
    """``--astrometry --stack_engine fused`` (navigate anchored on each
    group's planted WCS, K2's stack): the same files; a second run
    (noclean) keeps every mtime; ``--profile`` writes the port's
    torch.profiler trace."""
    datadir, caldir = dataset
    outs = {t: str(tmp_path / t) for t in ("j", "t")}
    argv = lambda o: [datadir, caldir, o, "--astrometry", "--stack_engine",
                      "fused", "--no-weights"]
    trace = str(tmp_path / "trace")
    assert j_reduce.main(argv(outs["j"]) + QUIET) == 0
    assert t_reduce.main(argv(outs["t"]) + ["--profile", trace] + QUIET
                         + CPU) == 0
    assert os.path.getsize(os.path.join(trace, "trace.json")) > 0
    names = sorted(os.listdir(outs["j"]))
    assert sorted(os.listdir(outs["t"])) == names
    assert sum(n.startswith("nav-") for n in names) == 6
    assert not any(n.startswith("weight-") for n in names)
    for n in names:
        if n.startswith("stack-"):
            _same_stack(os.path.join(outs["t"], n), os.path.join(outs["j"], n))
    mtimes = {n: os.path.getmtime(os.path.join(outs["t"], n)) for n in names}
    assert t_reduce.main(argv(outs["t"]) + QUIET + CPU) == 0
    assert {n: os.path.getmtime(os.path.join(outs["t"], n))
            for n in names} == mtimes
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert j_reduce.main([empty, caldir, outs["j"]] + QUIET) == 1
    assert t_reduce.main([empty, caldir, outs["t"]] + QUIET + CPU) == 1
