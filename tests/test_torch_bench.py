"""The port's benchmark entry points, ``bench_torch.py`` and
``bench_rawgrey_torch.py``, against ``bench.py`` and ``bench_rawgrey.py``:
the configurations bench.py's own ``_attempt`` builds, CPU runs of both
twins at tiny sizes, the DNG set byte for byte, and the rules that hold
on the card (no card means no line, a failure raises, no JAX)."""

import json
import math
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

import bench_rawgrey_torch
import bench_torch
from astrophotography_tpu_torch.models import from_jax_config
from astrophotography_tpu_torch.models import pipeline as port_pipeline

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACK_KEYS = {"metric", "value", "unit", "vs_baseline", "single_run_ms",
              "runs_ms", "peak_mem_bytes", "launches", "interior_median",
              "workload_s", "device"}


def _capture_bench_config(monkeypatch, n_frames, size, impl, rotate):
    """The PipelineConfig bench.py's ``_attempt`` hands its pipeline, with
    the workload replaced by tiny arrays and both pipelines by recorders
    that return zeros (``_attempt`` imports them at call time, so nothing
    compiles)."""
    import jax.numpy as jnp

    import astrophotography_tpu.models as jax_models
    import bench
    import astrophotography_tpu.models.pipeline as jax_pipeline

    seen = []

    def recorder(frames, config=None, **kw):
        seen.append(config)
        return jnp.zeros((8, 8), jnp.float32), {}

    def tiny_workload(n, s, rotate=False):
        z = np.zeros((8, 8), np.float32)
        return np.zeros((n, 8, 8), np.uint16), z, z, z + 1, 0.5, 0.0

    monkeypatch.setattr(bench, "_make_workload", tiny_workload)
    monkeypatch.setattr(jax_models, "calibrate_register_stack", recorder)
    monkeypatch.setattr(jax_pipeline, "calibrate_register_stack_lean",
                        recorder)
    bench._attempt(n_frames, size, 1, combine_impl=impl, rotate=rotate)
    assert seen and all(c is seen[0] for c in seen)
    return seen[0]


@pytest.mark.parametrize("n_frames,size,impl,rotate,bands", [
    (100, 4096, "lean", False, None),
    (100, 4096, "lean", True, None),
    (24, 4096, "pallas", False, None),
    (24, 4096, "fused", False, None),
    (16, 2048, "xla", True, None),
    (40, 2048, "pallas", False, "4"),
])
def test_config_for_is_bench_attempts_config(monkeypatch, n_frames, size,
                                             impl, rotate, bands):
    if bands is None:
        monkeypatch.delenv("BENCH_BANDS", raising=False)
    else:
        monkeypatch.setenv("BENCH_BANDS", bands)
    jax_cfg = _capture_bench_config(monkeypatch, n_frames, size, impl, rotate)
    ours = bench_torch.config_for(impl, n_frames, size, rotate)
    assert from_jax_config(jax_cfg) == ours
    if (impl, n_frames, size, bands) == ("pallas", 24, 4096, None):
        assert ours.n_bands == 2


def test_config_for_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="impl must be one of"):
        bench_torch.config_for("ladder", 24, 4096)


@pytest.mark.parametrize("impl,rotate", [("xla", False), ("pallas", False),
                                         ("lean", False), ("lean", True)])
def test_attempt_on_the_cpu(impl, rotate):
    line = bench_torch.attempt(4, 256, 1, impl, rotate=rotate, device="cpu")
    assert set(line) == STACK_KEYS | ({"max_rotation_offset_px"} if rotate
                                      else set())
    assert line["vs_baseline"] is None
    assert line["device"] == {"name": "cpu", "power_limit_w": None,
                              "count": 1}
    assert line["unit"] == "GPix/s"
    assert f"4x256^2 {impl}" in line["metric"]
    assert "sustained over 3 back-to-back runs" in line["metric"]
    assert math.isfinite(line["value"]) and line["value"] > 0
    assert line["single_run_ms"] > 0
    runs = line["runs_ms"]
    assert 0 < runs["min"] <= runs["median"] <= runs["max"]
    assert line["value"] == pytest.approx(4 * 256 * 256 / runs["min"] / 1e6)
    # the CPU runs each kernel's plain twin: no launch is counted
    assert line["launches"] == {"detect_tiles": 0, "warp_combine": 0,
                                "clip_combine": 0, "warp_separable": 0,
                                "find_exact": 0, "calibrate": 0}
    assert abs(line["interior_median"] - bench_torch.SKY) \
        < 0.05 * bench_torch.SKY
    assert line["peak_mem_bytes"] is None


@pytest.mark.parametrize("impl,size,want", [
    ("lean", 4096, {"warp_combine": None, "detect_tiles": None}),
    ("lean", 1024, {"warp_combine": None, "detect_tiles": None}),
    ("lean", 512, {"warp_combine": None,          # too few tiles for K1
                   "calibrate": None}),
    ("pallas", 4096, {"clip_combine": 2, "warp_separable": None,
                      "calibrate": 1, "find_exact": None}),
    ("fused", 4096, {"warp_combine": None, "calibrate": 1,
                     "find_exact": None}),
    ("xla", 4096, {"clip_combine": 2, "warp_separable": None,
                   "calibrate": 1, "find_exact": None}),
])
def test_required_launches(impl, size, want):
    cfg = bench_torch.config_for(impl, 24, size)
    assert bench_torch.required_launches(impl, cfg, size, size) == want


@pytest.mark.parametrize("launches,ok", [
    ({"detect_tiles": 1, "warp_combine": 1, "clip_combine": 0}, True),
    ({"detect_tiles": 0, "warp_combine": 1, "clip_combine": 0}, False),
    ({"detect_tiles": 1, "warp_combine": 1, "clip_combine": 1}, False),
])
def test_check_launches(launches, ok):
    req = {"warp_combine": None, "detect_tiles": None}
    if ok:
        bench_torch.check_launches("lean", launches, req)
    else:
        with pytest.raises(RuntimeError, match="check failed: lean: kernel"):
            bench_torch.check_launches("lean", launches, req)


@pytest.mark.parametrize("value,ok", [(800.0, True), (835.0, True),
                                      (845.0, False), (float("nan"), False)])
def test_check_stack(value, ok):
    stack = torch.full((64, 64), value)
    if ok:
        assert bench_torch.check_stack("s", stack) == value
    else:
        with pytest.raises(RuntimeError, match="check failed: s:"):
            bench_torch.check_stack("s", stack)


@pytest.mark.parametrize("script", ["bench_torch.py",
                                    "bench_rawgrey_torch.py"])
def test_no_card_no_line(script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", BENCH_FRAMES="2",
               BENCH_SIZE="160", BENCH_RAW_FRAMES="2", BENCH_RAW_SIZE="64")
    proc = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in proc.stderr
    for text in proc.stdout.splitlines():
        assert not (text.startswith("{") and "value" in json.loads(text))


def _on_cpu(monkeypatch):
    """Let ``main`` run on the CPU, as it would on the card, at a tiny
    size."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(bench_torch, "resolve_device", lambda d=None: cpu)
    for name, value in (("BENCH_FRAMES", "2"), ("BENCH_SIZE", "160"),
                        ("BENCH_REPEATS", "1")):
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("impl,entry", [
    ("lean", "calibrate_register_stack_lean"),
    ("pallas", "calibrate_register_stack")])
def test_a_failing_pipeline_is_not_stepped_down(monkeypatch, capsys, impl,
                                                entry):
    """bench.py tries smaller configurations after a failure; the port
    runs the one it was given, and its failure ends the script."""
    _on_cpu(monkeypatch)
    monkeypatch.setenv("BENCH_IMPL", impl)
    calls = []

    def fails(frames, config=None, **kw):
        calls.append(tuple(frames.shape))
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr(port_pipeline, entry, fails)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        bench_torch.main()
    assert calls == [(2, 160, 160)]
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("failing", ["rawgrey", "rotation"])
def test_a_failing_later_line_is_not_swallowed(monkeypatch, capsys, failing):
    _on_cpu(monkeypatch)
    monkeypatch.delenv("BENCH_IMPL", raising=False)

    def attempt(n, size, repeats, impl, rotate=False, device=None):
        if rotate and failing == "rotation":
            raise RuntimeError("rotation line failed")
        return {"metric": f"line rotate={rotate}", "value": 1.0}

    def raw_run(**kw):
        if failing == "rawgrey":
            raise RuntimeError("rawgrey line failed")
        return {"metric": "raw", "value": 1.0}

    monkeypatch.setattr(bench_torch, "attempt", attempt)
    monkeypatch.setattr(bench_rawgrey_torch, "run", raw_run)
    with pytest.raises(RuntimeError, match=f"{failing} line failed"):
        bench_torch.main()
    printed = [json.loads(t) for t in capsys.readouterr().out.splitlines()]
    assert printed[0]["metric"] == "line rotate=False"
    assert len(printed) == (1 if failing == "rawgrey" else 2)


def test_smoke_bench_phase_checks_the_lines(monkeypatch, capsys):
    """chip_smoke's bench phase takes the default run's lines as main
    prints them (here on the CPU, with the launches the card's lean path
    makes written in), and refuses them out of order, with a value that
    is not finite, on another device or with a kernel not launched."""
    import chip_smoke

    _on_cpu(monkeypatch)
    for name, value in (("BENCH_FRAMES", "4"), ("BENCH_SIZE", "256"),
                        ("BENCH_RAW_FRAMES", "2"), ("BENCH_RAW_SIZE", "64")):
        monkeypatch.setenv(name, value)
    monkeypatch.delenv("BENCH_IMPL", raising=False)
    card = {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0,
            "count": 1}
    monkeypatch.setattr(bench_torch, "device_info", lambda dev: card)
    monkeypatch.setattr(bench_rawgrey_torch, "device_info", lambda dev: card)
    assert bench_torch.main() == 0
    lines = [json.loads(t) for t in capsys.readouterr().out.splitlines()]
    assert [ln["unit"] for ln in lines] == ["GPix/s", "frames/s", "GPix/s"]
    for i in (0, 2):
        lines[i]["launches"].update(detect_tiles=1, warp_combine=1)
    label, _env, want = chip_smoke.BENCH_RUNS[0]
    smoke = {"snap": {"single_run_ms": 2.0, "sustained_ms": 4.0}}
    dev = {"name": card["name"], "count": 1}

    def check(lns):
        return chip_smoke.bench_lines(
            label, "\n".join(json.dumps(ln) for ln in lns), want, dev, smoke)

    got, vs_smoke = check(lines)
    assert got == lines
    assert vs_smoke == {"1": {
        "single_run": lines[0]["single_run_ms"] / 2.0,
        "sustained": lines[0]["runs_ms"]["min"] / 4.0}}
    bad = [
        (lines[2], lines[1], lines[0]),
        lines[:2],
        [lines[0], dict(lines[1], value=float("nan")), lines[2]],
        [lines[0], lines[1], dict(lines[2], device=dict(card, name="cpu"))],
        [lines[0], lines[1], dict(lines[2], launches=dict(
            lines[2]["launches"], detect_tiles=0))],
        [dict(lines[0], vs_baseline=4.0), lines[1], lines[2]],
    ]
    for lns in bad:
        with pytest.raises(RuntimeError, match="check failed: bench default"):
            check(lns)


def test_bad_bench_impl_raises(monkeypatch):
    _on_cpu(monkeypatch)
    monkeypatch.setenv("BENCH_IMPL", "fallback")
    with pytest.raises(ValueError, match="BENCH_IMPL must be one of"):
        bench_torch.main()


@pytest.mark.parametrize("compression", [7, 1])
def test_dng_set_is_bench_rawgreys(tmp_path, compression):
    """bench_rawgrey.py's recipe through the JAX package's writer and
    encoder, file for file, byte for byte."""
    from astrophotography_tpu.io.losslessjpeg import encode_lossless_jpeg
    from astrophotography_tpu.io.raw import write_dng

    ours_dir, ref_dir = tmp_path / "ours", tmp_path / "ref"
    ours_dir.mkdir()
    ref_dir.mkdir()
    base, paths = bench_rawgrey_torch.write_dngs(str(ours_dir), 2, 64,
                                                 compression)
    rng = np.random.default_rng(0)
    ref_base = np.clip(rng.normal(900.0, 35.0, (64, 64)),
                       0, 65535).astype(np.uint16)
    np.testing.assert_array_equal(base, ref_base)
    payload = encode_lossless_jpeg(ref_base) if compression == 7 else None
    assert [os.path.basename(p) for p in paths] == ["f000.dng", "f001.dng"]
    for p in paths:
        ref = str(ref_dir / os.path.basename(p))
        write_dng(ref, ref_base, black_levels=(128, 128, 128, 128),
                  compression=compression, strip_payload=payload)
        with open(p, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()


def test_rawgrey_run_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    line = bench_rawgrey_torch.run(2, 64, 1, device="cpu")
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "method",
                         "spread", "decode_s_per_frame", "device"}
    assert line["metric"] == \
        "RAW->grey FITS frames/s (2x0.0Mpix lossless-JPEG DNG)"
    assert line["value"] > 0 and line["unit"] == "frames/s"
    assert line["vs_baseline"] is None
    assert line["method"] == "median of 3 repeats"
    assert line["spread"]["min"] <= line["value"] <= line["spread"]["max"]
    assert line["decode_s_per_frame"] > 0
    assert line["device"]["name"] == "cpu"
    assert os.listdir(tmp_path) == []


def test_rawgrey_decode_failure_raises(tmp_path, monkeypatch):
    """A decode that fails in the decode thread ends the run with its
    error (bench_rawgrey.py's loop would wait for the next frame for
    ever), and the temp directory goes."""
    from astrophotography_tpu_torch.io import raw as raw_io

    real = raw_io.load_raw

    def load_raw(path, *a, **kw):
        if path.endswith("f001.dng"):
            raise OSError(f"cannot decode {path}")
        return real(path, *a, **kw)

    monkeypatch.setattr(raw_io, "load_raw", load_raw)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    with pytest.raises(OSError, match="f001.dng"):
        bench_rawgrey_torch.run(3, 64, 1, device="cpu")
    assert os.listdir(tmp_path) == []


def test_bench_twins_never_import_jax():
    """Both twins, imported and run on their CPU paths in a fresh
    interpreter, leave JAX, the JAX package, bench.py, bench_rawgrey.py
    and chip_smoke.py unimported."""
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        import bench_rawgrey_torch
        import bench_torch
        for impl in ("lean", "pallas"):
            line = bench_torch.attempt(4, 256, 1, impl, device="cpu")
            assert line["value"] > 0, line
        assert bench_rawgrey_torch.run(2, 64, 1, device="cpu")["value"] > 0
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "astrophotography_tpu",
                                            "bench", "bench_rawgrey",
                                            "chip_smoke"))
        assert not bad, bad
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("body", ["exact", "lowrank"])
def test_wide_bound_counts_the_mid_rows_the_pixels_read(body):
    """chip_smoke's bound of K2's 'wide' route counts the work this run's
    frames need: the samples the twin covers, and per tile column the
    source rows their vertical taps reach (within one row a column of
    the rows a brute-force count finds), not the tile's th + span."""
    import chip_smoke
    from astrophotography_tpu_torch.ops import warp_combine as wc

    n, size, span, th, tw = 4, 192, 40, 64, 96
    frames, _b, _d, _f, er, _off, mats = chip_smoke.make_field_rotation(
        n, size, 12.0, seed=3)
    cal = torch.from_numpy(frames).to(torch.float32)
    m = torch.from_numpy(mats.astype(np.float32))
    taps = "lowrank" if body == "lowrank" else "exact"
    if body == "lowrank":
        m[1:, 0, 1], m[1:, 1, 0] = -4e-4, 4e-4
        m[1:, 0, 0] = m[1:, 1, 1] = 1.0
    plan = wc.plan_warp_combine(cal.shape, m, span=span, tile=(th, tw),
                                dither_budget=32, general_taps=taps)
    got = chip_smoke._k2_wide_bound(cal, None, plan, body)
    want = slack = 0.0
    ys, xs = np.mgrid[0:size, 0:size]
    for f in range(n):
        cov = (wc._warp_frame_plain(cal[f], f, plan, taps) < 1e38).numpy()
        t = plan.table[f].numpy()
        v = (t[3] * xs.astype(np.float32) + t[4] * ys.astype(np.float32)
             + t[5])
        tap = 25 if body == "exact" and t[8] <= 0.5 else 2
        rows = set()
        for y, x in zip(*np.nonzero(cov)):
            lo = math.floor(v[y, x] - 3.0) + 1
            rows.update((y // th, x, q) for q in range(lo, lo + 6)
                        if abs(v[y, x] - q) < 3.0)
        columns = len({(y // th, x) for y, x in zip(*np.nonzero(cov))})
        want += (int(cov.sum()) * (6 * tap + 1 + math.log2(n))
                 + len(rows) * (6 * tap + 1))
        slack += columns * (6 * tap + 1)
    assert want > 0
    assert abs(got["bound_ops"] - want) <= slack
    assert got["bound_bytes"] == cal.numel() * 4 + size * size * 4
