"""The port's spans and counters (``utils.timing``): the span tree of each
stacking entry under ``torch.profiler``, nothing recorded without it,
records on the profiler's host clock, K2's frame-tile counter against
its plain twin, the host reads at the points where the card's sync
debug mode reports a synchronization, one increment path for launches,
the stage spans, and a traced benchmark run that reads the three
metrics built on them."""

import inspect
import json
import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.core import reduce as tred
from astrophotography_tpu_torch.models import pipeline as pl
from astrophotography_tpu_torch.ops import warp_combine as wc
from astrophotography_tpu_torch.utils import timing

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

#: a night small enough for the CPU twins that still takes the lean
#: path's fused detection (16 tiles of 64 x 256 for 16 stars)
SMALL = {"frames": 6, "height": 256, "width": 1024}
SMALL_STARS = 16
SEED = 2**31 + 19
CELLS = {"lean": "lean-rot-16mpix-n100.rotate",
         "unfused": "unfused-16mpix-n24.dither"}

LEAN_TREE = [
    ("apt.detect.planes", "apt.detect"), ("apt.detect.noise", "apt.detect"),
    ("apt.detect.planes", "apt.detect"), ("apt.detect.k1", "apt.detect"),
    ("apt.detect.select", "apt.detect"), ("apt.detect", "apt.stack"),
    ("apt.register.match", "apt.register"),
    ("apt.register.refine", "apt.register"), ("apt.register", "apt.stack"),
    ("apt.masters", "apt.stack"),
    ("apt.warp_combine.plan", "apt.warp_combine"),
    ("apt.warp_combine.k2", "apt.warp_combine"),
    ("apt.warp_combine", "apt.stack"), ("apt.stack", None)]
UNFUSED_TREE = [
    ("apt.calibrate", "apt.stack"), ("apt.detect.noise", "apt.detect"),
    ("apt.detect.find", "apt.detect"), ("apt.detect", "apt.stack"),
    ("apt.register.match", "apt.register"),
    ("apt.register.refine", "apt.register"), ("apt.register", "apt.stack"),
    ("apt.warp", "apt.stack"), ("apt.combine", "apt.stack"),
    ("apt.warp", "apt.stack"), ("apt.combine", "apt.stack"),
    ("apt.stack", None)]


def _profiler():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def nights():
    """{path: (entry, observation, config)}: each cell's configuration
    at :data:`SMALL`, its night made on the CPU from :data:`SEED`."""
    from stackbench.registry import Registry
    from stackbench.run import pipeline_config

    reg = Registry.load()
    out = {}
    for path, name in CELLS.items():
        cell = reg.cell(name)
        config = dict(reg.config(cell["config"]), **SMALL)
        config["pipeline"] = dict(config["pipeline"], max_stars=SMALL_STARS)
        mix = reg.traffic(cell["traffic"])
        obs = reg.generator(mix["generator"]).inputs(config, mix, SEED,
                                                     torch.device("cpu"))
        out[path] = (getattr(pl, config["entry"]), obs,
                     pipeline_config(config))
    return out


def _stack(night):
    entry, obs, cfg = night
    return entry(obs.frames, bias=obs.bias, dark=obs.dark, flat=obs.flat,
                 exp_ratios=obs.exp_ratios, config=cfg)


def _traced(fn, *args):
    """(fn's result, the records it closed) under the profiler."""
    timing.clear_records()
    with _profiler() as prof:
        out = fn(*args)
    return out, timing.records(), prof


@pytest.mark.parametrize("path,tree", [("lean", LEAN_TREE),
                                       ("unfused", UNFUSED_TREE)])
def test_span_tree_of_each_entry(nights, path, tree):
    """Two calls: each request's spans, in the order they close, carry
    the names and parents of ``tree``, one ``request`` id (its root's),
    and the two requests differ."""
    _out, recs, _prof = _traced(lambda: [_stack(nights[path])
                                         for _ in range(2)])
    by_id = {r["id"]: r for r in recs}
    requests = sorted({r["request"] for r in recs})
    assert len(requests) == 2
    for rid in requests:
        mine = [r for r in recs if r["request"] == rid]
        got = [(r["name"], by_id[r["parent"]]["name"]
                if r["parent"] is not None else None) for r in mine]
        assert got == tree
        root = mine[-1]
        assert root["id"] == rid and root["attrs"] == {"entry": path}
        assert all(r["t0"] <= r["t1"] for r in mine)
        assert all(by_id[r["parent"]]["request"] == rid
                   for r in mine if r["parent"] is not None)
    counters = {k for r in recs for k in r["counters"]}
    assert {"detect.stars", "register.inliers"} <= counters
    for r in recs:
        if r["name"] == "apt.detect":
            assert 0 < r["counters"]["detect.stars"] <= SMALL_STARS
        if r["name"] == "apt.register":
            assert 0 < r["counters"]["register.inliers"] <= SMALL_STARS


def test_nothing_recorded_without_the_profiler(nights, monkeypatch):
    """With no profiler recording, a span is its flag check: neither
    entry opens a profiler range, a record or a counter."""
    def refuse(*_a, **_k):
        raise AssertionError("recorded without a profiler")

    timing.clear_records()
    monkeypatch.setattr(timing, "_range", refuse)
    monkeypatch.setattr(timing._TRACER, "open", refuse)
    monkeypatch.setattr(timing._TRACER, "count", refuse)
    monkeypatch.setattr(timing, "_on_host", lambda _where: False)
    for night in nights.values():
        _stack(night)
    timer = timing.StageTimer()
    with timer.stage("write", "x.fits"):
        pass
    assert timing.records() == []
    assert timer.records[0]["stage"] == "write x.fits"


def test_records_hold_their_profiler_events(nights):
    """Each record's host interval holds its profiler range, whose start
    lies within 1 ms of the record's: the records are stamped on the
    profiler's host clock."""
    _out, recs, prof = _traced(lambda: [_stack(n) for n in nights.values()])
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("apt."):
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    names = {r["name"] for r in recs}
    assert names == set(events)
    for name in names:
        mine = sorted((r["t0"], r["t1"]) for r in recs if r["name"] == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (t0, t1), (s, e) in zip(mine, theirs):
            assert t0 <= s <= e <= t1, name
            assert s - t0 < 1_000_000, name


def _turned(n: int, h: int, w: int):
    """(N, 2, 3) maps: the reference, small dithers, a turn K2's lowrank
    gate takes, one it refuses, and a dither past some windows' reach."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    moves = [(0.0, 0.0, 0.0), (1.5, -2.0, 0.0), (0.5, 0.5, 0.2),
             (0.0, 1.0, 2.5), (0.0, -70.0, 0.0), (3.0, 2.0, -0.1)][:n]
    mats = torch.zeros((n, 2, 3), dtype=torch.float32)
    for i, (dx, dy, deg) in enumerate(moves):
        t = math.radians(deg)
        c, s = math.cos(t), math.sin(t)
        mats[i] = torch.tensor([[c, -s, cx + dx - c * cx + s * cy],
                                [s, c, cy + dy - s * cx - c * cy]])
    return mats


def test_frame_tiles_used_is_the_twins_count():
    """On a turned stack that drops frames and tiles, the kernel's rule
    (``frame_tiles_used``) counts exactly the (frame, tile) pairs in which
    the plain twin combines a sample, and the span counter reads it.  The
    twin runs with its source-row bounds opened, so that only the rule,
    and not the image's edge, decides whether a tile gets a sample."""
    n, h, w = 6, 256, 1024
    g = torch.Generator().manual_seed(7)
    cal = 800.0 + 8.0 * torch.randn((n, h, w), generator=g)
    mats = _turned(n, h, w)
    kw = dict(tile=(64, 256), span=12, apron=True, dither_budget=8,
              general_taps="lowrank")
    plan = wc.plan_warp_combine(cal.shape, mats, **kw)
    table = plan.table.clone()
    table[:, 9], table[:, 10] = -1e9, 1e9
    opened = plan._replace(table=table)
    twin = 0
    for f in range(n):
        warped = wc._warp_frame_plain(cal[f], f, opened, "lowrank")
        covered = (warped < wc._BIG * 0.5).reshape(
            h // plan.th, plan.th, w // plan.tw, plan.tw)
        twin += int(covered.any(dim=3).any(dim=1).sum())
    total = n * plan.n_ti * plan.n_tj
    used = int(wc.frame_tiles_used(plan))
    assert 0 < used < total - plan.n_ti * plan.n_tj
    assert used == twin
    _out, recs, _prof = _traced(lambda: wc.warp_combine(cal, mats, **kw))
    (rec,) = [r for r in recs if r["name"] == "apt.warp_combine"]
    assert rec["counters"] == {"warp_combine.frame_tiles": total,
                               "warp_combine.frame_tiles_used": used}


def test_host_reads_at_the_sync_points(nights, monkeypatch):
    """Counted as if the tensors were on the card: the lean path waits
    for the device where the card's sync debug mode reports it (the
    master densities' four constants twice, the solve's one read of
    whether the vote turns a frame past 2 deg), and the unfused path at
    its ``nonzero`` and at each warp chunk's two row bounds besides.  K1's twin, which computes on the
    host what the card's kernel computes on the card, is left out."""
    monkeypatch.setattr(timing, "_on_host", lambda _where: False)
    reads = {}
    for path, night in nights.items():
        _out, recs, _prof = _traced(_stack, night)
        by_name = {}
        for r in recs:
            if "host_reads" in r["counters"]:
                by_name[r["name"]] = by_name.get(r["name"], 0) \
                    + r["counters"]["host_reads"]
                assert r["counters"]["host_read_wait_ns"] >= 0
        reads[path] = by_name
    reads["lean"].pop("apt.detect.k1")
    assert reads["lean"] == {"apt.detect.planes": 8, "apt.register": 1}
    unfused = reads["unfused"]
    assert unfused.pop("apt.register") == 1
    assert unfused.pop("apt.detect.find") == 1
    assert unfused.pop("apt.warp") >= 4 and unfused == {}


def test_no_host_read_counted_on_the_cpu(nights):
    _out, recs, _prof = _traced(lambda: [_stack(n) for n in nights.values()])
    assert not any("host_reads" in r["counters"] for r in recs)


def test_launches_counted_once_through_one_path(monkeypatch):
    """Every launcher raises its kernel's counts through ``_launched``
    once, and ``_launched`` raises the process totals and the innermost
    span's counters together."""
    src = inspect.getsource(kernels)
    assert src.count("launch_counts[") == 1      # in _launched
    assert src.count("route_counts[kernel]") == 1
    assert "warp_route_counts[" not in src
    assert "warp_separable_route_counts[" not in src
    for name in ("detect_tiles_cuda", "warp_combine_cuda",
                 "clip_combine_cuda", "warp_separable_cuda",
                 "find_exact_cuda", "calibrate_cuda"):
        assert inspect.getsource(getattr(kernels, name)).count(
            "_launched(") == 1, name
    monkeypatch.setattr(kernels, "launch_counts", dict(kernels.launch_counts))
    monkeypatch.setattr(kernels, "route_counts",
                        {k: dict(v) for k, v in kernels.route_counts.items()})
    routes = kernels.route_counts
    before = dict(kernels.launch_counts), dict(routes["warp_combine"]), \
        dict(routes["warp_separable"])

    def launches():
        with timing.span("apt.test"):
            kernels._launched("warp_combine", "cols")
            kernels._launched("clip_combine")
            kernels._launched("warp_separable", "smem")

    _out, recs, _prof = _traced(launches)
    assert recs[0]["counters"] == {"launch.warp_combine": 1,
                                   "launch.warp_combine.cols": 1,
                                   "launch.clip_combine": 1,
                                   "launch.warp_separable": 1,
                                   "launch.warp_separable.smem": 1}
    assert kernels.launch_counts["warp_combine"] == \
        before[0]["warp_combine"] + 1
    assert kernels.launch_counts["clip_combine"] == \
        before[0]["clip_combine"] + 1
    assert routes["warp_combine"] == dict(before[1],
                                          cols=before[1]["cols"] + 1)
    assert routes["warp_separable"] == dict(
        before[2], smem=before[2]["smem"] + 1)
    with pytest.raises(KeyError):
        kernels._launched("clip_combine", "cols")


def test_stage_spans(nights):
    """``StageTimer.stage`` is the span ``apt.stage.<kind>`` with the file
    or group in ``attrs`` and keeps its log record; ``add`` logs only.
    ``register_and_stack``'s stages hold the stacking spans."""
    _entry, obs, cfg = nights["unfused"]
    cal = pl.calibrate_batch(obs.frames, obs.bias, obs.dark, obs.flat,
                             obs.exp_ratios)
    timer = timing.StageTimer()

    def run():
        with timer.stage("weight map", "w.fits"):
            pass
        timer.add("read s.fits", 0.5)
        return tred.register_and_stack(cal, None, cfg, timer, "s.fits")

    _out, recs, _prof = _traced(run)
    roots = [r for r in recs if r["parent"] is None]
    assert [(r["name"], r["attrs"]) for r in roots] == [
        ("apt.stage.weight map", {"of": "w.fits"}),
        ("apt.stage.register", {"of": "s.fits"}),
        ("apt.stage.combine", {"of": "xla s.fits"}),
        ("apt.stage.download", {"of": "s.fits"})]
    under = {r["name"]: r["parent"] for r in recs}
    assert under["apt.detect"] == roots[1]["id"]
    assert under["apt.register"] == roots[1]["id"]
    assert under["apt.combine"] == roots[2]["id"]
    assert [r["stage"] for r in timer.records] == [
        "weight map w.fits", "read s.fits", "register s.fits",
        "combine xla s.fits", "download s.fits"]


def test_entry_roots(tmp_path):
    """``ap_reduce`` and ``ap_stack`` open their root spans."""
    from astrophotography_tpu_torch.cli import ap_stack

    def failing(call, name):
        # arguments that make the entry fail at once: the span closes on
        # the way out
        with pytest.raises((RuntimeError, AttributeError)):
            call()

    for call, name in (
            (lambda: tred.reduce_all("/nonexistent", "", str(tmp_path),
                                     device="cpu"),
             "apt.reduce"),
            (lambda: ap_stack.run(None), "apt.ap_stack")):
        _out, recs, _prof = _traced(failing, call, name)
        assert [r["name"] for r in recs] == [name]


def test_device_trace_writes_spans_beside_the_trace(tmp_path):
    with timing.device_trace(str(tmp_path)):
        with timing.span("apt.test", of="x"):
            timing.count("n", 2)
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert (tmp_path / "trace.json").is_file()
    assert [(s["name"], s["attrs"], s["counters"]) for s in spans] == [
        ("apt.test", {"of": "x"}, {"n": 2})]


def test_traced_cell_reads_the_three_metrics(tmp_path):
    """``stackbench.run.run_cell`` traced on the CPU, on the rotated lean
    cell cut to :data:`SMALL`, reports the three metrics that read the
    program's records; on the CPU the host reads nothing from a card."""
    from stackbench import run
    from stackbench.registry import BENCHMARK, HERE, Registry

    (tmp_path / "configs").mkdir()
    name = "lean-rot-16mpix-n100"
    config = json.loads((HERE / "configs" / f"{name}.json").read_text())
    config.update(SMALL)
    config["pipeline"] = dict(config["pipeline"], max_stars=SMALL_STARS)
    (tmp_path / "configs" / f"{name}.json").write_text(json.dumps(config))
    reg = Registry(json.loads(BENCHMARK.read_text()), roots=[tmp_path, HERE])
    timing.clear_records()
    res = run.run_cell(reg, CELLS["lean"], SEED, 0.5, True, "cpu")
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert 0.0 < got["stack_host_ms"]
    assert got["host_syncs_per_stack"] == 0.0
    assert 0.0 < got["warp_combine_frames_pct"] <= 100.0
    assert res["metrics"]["stack_host_ms"]["unit"] == "ms"
