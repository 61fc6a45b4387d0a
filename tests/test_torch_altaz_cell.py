"""The alt-az session on the lean path (the benchmark's
``lean-wide-4mpix-n360.altaz`` cell): the lean entry at the cell's
settings scaled down, against the plain reference; K2's plan at the
cell's own shape, every (frame, tile) pair used on the 'wide' route;
the mix's stars inside every turned frame; the span attributes that say
which route ran; and the two per-layer metrics' readers."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.models import pipeline as pl
from astrophotography_tpu_torch.models.config import PipelineConfig
from astrophotography_tpu_torch.ops.detect import Stars
from astrophotography_tpu_torch.ops import register as rg
from astrophotography_tpu_torch.ops import warp_combine as wc
from astrophotography_tpu_torch.utils import timing
from stackbench import counts, counts_wide, run, tracing
from stackbench.reference import stack as ref
from stackbench.registry import BENCHMARK, Registry
from stackbench.workload import geometry, make_observation

# one intra-op thread: the suite runs in parallel worker processes
torch.set_num_threads(1)

CELL = "lean-wide-4mpix-n360.altaz"
SEEDS = (2**31 + 41, 3000002102, 7)
COMBINE = {"method": "average", "sigma_lower": 5.0, "sigma_upper": 5.0}

#: the cell scaled down for the CPU twins: 6 frames of 512^2 turned 5-15
#: deg either way; span 196, past 192, where K2 takes its 'wide' route
#: and the exact body's gate is the one the cell's frames pass (at 15
#: deg 73 of the 189 px it allows); tiles of 264 rows, the fewest rows
#: that cut the frame into two, so the twin computes the fewest mid
#: rows; 16 stars for K1's 16 tiles of 64 x 256, and 12 stars in the
#: field so that few tiles hold two
SMALL = {"frames": 6, "height": 512, "width": 512}
SMALL_PIPELINE = {"warp_span": 196, "fused_tile": [264, 256],
                  "max_stars": 16}
SMALL_MIX = {"rotation_deg": [5.0, 15.0], "stars": 12}
SMALL_SEED = 2**31 + 23
#: limits of the scaled-down run, each between its readings on the CPU:
#: the program read a sky rms of 0.14-0.18 ADU (seeds 21, 22) against
#: the bfloat16 reference's 3.0-3.2, so 0.6 leaves 3x of room above the
#: one and 5x below the other; its worst frame corner 0.016 px against
#: the ~1 px of a frame a pixel off, so 0.25 px.  The widest sky gap
#: (5-9 ADU, where a clip bound falls between the two arithmetics with
#: six frames) lies within 2x of the control's 16-18 and is not compared.
SKY_RMS_ADU, CORNER_PX = 0.6, 0.25


def _registry():
    return Registry.load()


def _cell():
    reg = _registry()
    cell = reg.cell(CELL)
    return reg.config(cell["config"]), reg.traffic(cell["traffic"])


def star_edge(size: int, mix: dict, half: int) -> float:
    """The least distance from a square frame's edge at which the mix
    may draw a star so that, turned by the mix's largest angle about the
    centre and dithered, its drawn patch (``half`` px about it) stays in
    the frame: a star at (c - e, c - e) from the centre c reaches
    c - (c - e) (cos t + sin t) - dither."""
    c = (size - 1) / 2.0
    t = math.radians(mix["rotation_deg"][1])
    return c - (c - half - mix["dither_px"] - 1) / (math.cos(t) + math.sin(t))


def _small():
    config, mix = _cell()
    config = dict(config, **SMALL)
    config["pipeline"] = dict(config["pipeline"], **SMALL_PIPELINE)
    mix = dict(mix, **SMALL_MIX)
    mix["star_edge_px"] = math.ceil(star_edge(SMALL["width"], mix, 12))
    return config, mix


@pytest.fixture(scope="module")
def small_run():
    """The lean entry at the cell's settings scaled down (:data:`SMALL`),
    once, under the profiler: (observation, image, diagnostics, span
    records)."""
    config, mix = _small()
    obs = make_observation(SMALL["frames"], SMALL["height"], SMALL["width"],
                           config["sensor"], mix, SMALL_SEED, "cpu")
    timing.clear_records()
    with profile(activities=[ProfilerActivity.CPU]):
        image, diag = pl.calibrate_register_stack_lean(
            obs.frames, bias=obs.bias, dark=obs.dark, flat=obs.flat,
            exp_ratios=obs.exp_ratios, config=run.pipeline_config(config))
    return obs, image, diag, timing.records()


@pytest.fixture(scope="module")
def small_reference(small_run):
    obs = small_run[0]
    return ref.reference_stack(obs, COMBINE)


def test_small_run_takes_the_cells_path(small_run):
    """K1 detection (the cell's detector) and exact taps past span 192,
    with the apron the tile's two columns need."""
    config, _mix = _small()
    cfg = run.pipeline_config(config)
    h, w = SMALL["height"], SMALL["width"]
    assert pl.lean_detect_fused(cfg, h, w)
    kw = pl.lean_kernel_kwargs(cfg, h, w)
    assert kw["span"] > 192 and kw["general_taps"] == "exact"
    assert kw["apron"] and not cfg.fused_apron
    _obs, _image, diag, _recs = small_run
    assert int(diag["n_inliers"].min()) >= run.MIN_INLIERS


def test_small_run_registers_every_frame(small_run):
    obs, _image, diag, _recs = small_run
    turns = np.degrees(np.abs(np.arctan2(obs.matrices[1:, 1, 0],
                                         obs.matrices[1:, 0, 0])))
    assert turns.min() >= 5.0 - 1e-9 and turns.max() > 10.0
    solved = {k: diag[k].double().numpy()
              for k in ("scale", "theta", "tx", "ty")}
    errs = ref.corner_errors(ref.maps_of(solved), obs.matrices,
                             SMALL["height"], SMALL["width"])
    assert errs.max() <= CORNER_PX, errs


def test_small_run_matches_the_reference(small_run, small_reference):
    _obs, image, _diag, _recs = small_run
    r, compared = small_reference
    assert int(compared["sky"].sum()) > 0.5 * SMALL["height"] * SMALL["width"]
    gap = ref.gaps(image, r, compared)
    assert gap["sky_rms_adu"] <= SKY_RMS_ADU, gap


def test_bfloat16_reference_fails_the_small_limit(small_run, small_reference):
    obs = small_run[0]
    r, compared = small_reference
    low, _ = ref.reference_stack(obs, COMBINE, dtype=torch.bfloat16)
    assert ref.gaps(low, r, compared)["sky_rms_adu"] > SKY_RMS_ADU


def test_k2_span_says_what_ran(small_run):
    recs = small_run[3]
    k2 = [r for r in recs if r["name"] == "apt.warp_combine.k2"]
    assert len(k2) == 1
    assert k2[0]["attrs"] == {"route": "plain", "span": 196,
                              "taps": "exact"}
    others = {r["name"]: r["attrs"] for r in recs if r is not k2[0]}
    assert others["apt.stack"] == {"entry": "lean"}
    assert others["apt.warp_combine"] == {}


def test_the_refit_is_a_span_of_the_solve(small_run):
    recs = small_run[3]
    by_id = {r["id"]: r for r in recs}
    (refit,) = [r for r in recs if r["name"] == "apt.register.refit"]
    assert by_id[refit["parent"]]["name"] == "apt.register"


def test_annotate_records_only_under_the_profiler():
    timing.clear_records()
    with timing.span("apt.test", kind="a"):
        timing.annotate(route="x")
    assert timing.records() == []
    with profile(activities=[ProfilerActivity.CPU]):
        with timing.span("apt.test", kind="a"):
            timing.annotate(route="x")
            timing.annotate(route="y", span=3)
        timing.annotate(route="z")              # no span open: dropped
    (rec,) = timing.records()
    assert rec["attrs"] == {"kind": "a", "route": "y", "span": 3}


@pytest.mark.parametrize("seed", SEEDS)
def test_plan_at_the_cells_shape_uses_every_frame_tile(seed):
    """K2's plan of the cell's own 360 x 2048^2 stack from the mix's
    true matrices: the 'wide' route, the apron (two tile columns), and
    every (frame, tile) pair inside its tile's window and through the
    exact body's gate."""
    config, mix = _cell()
    n, h, w = config["frames"], config["height"], config["width"]
    geo = geometry(n, h, w, config["sensor"], mix, seed)
    cfg = run.pipeline_config(config)
    kw = pl.lean_kernel_kwargs(cfg, h, w)
    assert kw["apron"] and kw["span"] == 288 and kw["tile"] == (320, 1024)
    assert kernels._warp_route(n, kw["span"]) == "wide"
    plan = wc.plan_warp_combine(
        (n, h, w), torch.from_numpy(geo["mats"]).to(torch.float32),
        tile=kw["tile"], span=kw["span"], apron=kw["apron"],
        dither_budget=kw["dither_budget"], general_taps=kw["general_taps"])
    assert (plan.n_ti, plan.n_tj) == (7, 2)
    assert bool((plan.table[1:, 14] > 0.5).all())
    assert bool((plan.tiles[..., 2] != 0).all())
    assert int(wc.frame_tiles_used(plan)) == n * plan.n_ti * plan.n_tj


def test_apron_free_cannot_take_the_cells_tile():
    """Two tile columns: the apron-free window placement raises, so the
    lean entry keeps the apron there."""
    config, _mix = _cell()
    n, h, w = config["frames"], config["height"], config["width"]
    mats = torch.eye(2, 3).expand(n, 2, 3)
    with pytest.raises(ValueError, match="apron-free"):
        wc.plan_warp_combine((n, h, w), mats, tile=(320, 1024), span=288,
                             apron=False, dither_budget=256)


def test_the_lean_cells_keep_their_apron_rule():
    """The auto tile's rule is unchanged: the 4096^2 lean cell runs
    apron-free, small frames keep the apron."""
    reg = _registry()
    cfg = run.pipeline_config(reg.config("lean-rot-16mpix-n100"))
    assert not pl.lean_kernel_kwargs(cfg, 4096, 4096)["apron"]
    assert pl.lean_kernel_kwargs(cfg, 64, 4096)["apron"]
    assert pl.lean_kernel_kwargs(cfg, 4096, 512)["apron"]
    # a given tile: the reference's rule on the frame, and the apron
    # where the tile leaves fewer than 3 blocks on an axis
    tiled = dataclasses.replace(cfg, fused_tile=(32, 128))
    assert pl.lean_kernel_kwargs(tiled, 256, 512)["apron"]
    assert not pl.lean_kernel_kwargs(tiled, 256, 768)["apron"]
    wide = dataclasses.replace(cfg, fused_tile=(320, 1024))
    assert pl.lean_kernel_kwargs(wide, 2048, 2048)["apron"]
    assert not pl.lean_kernel_kwargs(wide, 2048, 3072)["apron"]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_star_stays_inside_every_turned_frame(seed):
    config, mix = _cell()
    n, h, w = config["frames"], config["height"], config["width"]
    geo = geometry(n, h, w, config["sensor"], mix, seed)
    half = 12
    for px, size in ((geo["px"], w), (geo["py"], h)):
        lo = np.floor(px).astype(int) - half
        hi = np.floor(px).astype(int) + half
        assert lo.min() >= 0 and hi.max() <= size - 1
    assert mix["star_edge_px"] >= star_edge(w, mix, half)
    theta = np.degrees(np.abs(np.arctan2(geo["mats"][1:, 1, 0],
                                         geo["mats"][1:, 0, 0])))
    assert theta.max() <= 15.0 + 1e-9 and theta.max() > 14.0


def _ctx(trace, config=None, mix=None):
    c, m = _cell()
    window = run.Window(latencies_s=[0.1], completed=1, failed=0,
                        window_s=1.0, setup_s=1.0, peak_bytes=0)
    return run.Context({"name": CELL}, config or c, mix or m, window, trace)


def test_wide_roofline_reads_the_warp_combine_span():
    read = _registry().reader("wide_roofline").read
    assert read(_ctx(None)) is None
    assert read(_ctx(tracing.Trace())) is None
    work = counts_wide.wide_exact(360, 2048, 2048, 320, [0.0, 15.0], 4.0)
    tr = tracing.Trace(span_device_s={"warp_combine": 2 * 0.099},
                       span_calls={"warp_combine": 2})
    want = 100.0 * counts.bound_s(*work) / 0.099
    assert abs(read(_ctx(tr)) - want) < 1e-9 * want
    assert 6.7 < want < 6.8


def test_wide_frames_pct_reads_the_programs_counters(monkeypatch,
                                                     small_run):
    read = _registry().reader("wide_frames_pct").read
    assert read(_ctx(None)) is None
    recs = small_run[3]
    monkeypatch.setattr(timing, "records", lambda: recs)
    assert read(_ctx(tracing.Trace())) == 100.0
    # a stack call whose K2 combined a third of the pairs it was given
    fake = [{"id": 1, "request": 1, "name": "apt.stack", "counters": {}},
            {"id": 2, "request": 1, "name": "apt.warp_combine",
             "counters": {"warp_combine.frame_tiles": 30,
                          "warp_combine.frame_tiles_used": 10}}]
    monkeypatch.setattr(timing, "records", lambda: fake)
    assert abs(read(_ctx(tracing.Trace())) - 100.0 / 3) < 1e-12
    monkeypatch.setattr(timing, "records", lambda: [])
    assert read(_ctx(tracing.Trace())) is None


def test_wide_count_at_the_cells_shape():
    """Every byte once: the raw stack, three planes, the image; the
    operations per frame and pixel ~297, the bound ~6.70 ms, set by the
    operations, as ``chip_smoke._k2_wide_bound`` read it at this shape
    from the covered pixels of its own frames (6.70 ms).  Counting every
    frame as covering every pixel would read 7.11 ms."""
    n, h, w = 360, 2048, 2048
    b, ops = counts_wide.wide_exact(n, h, w, 320, [0.0, 15.0], 4.0)
    assert b == n * h * w * 2 + 16 * h * w
    assert 290 < ops / (n * h * w) < 305
    assert ops / counts.PEAK_F32_S > b / counts.PEAK_BYTES_S
    assert abs(counts.bound_s(b, ops) - 6.70e-3) < 0.01e-3
    # no turn and no dither: every frame covers [2, W - 4] x [2, H - 4]
    px, cols = counts_wide.cover(h, w, 320, 0.0, 0.0, 0.0)
    assert (px, cols) == ((h - 5) * (w - 5), 7 * (w - 5))
    assert counts_wide.mean_cover(h, w, 320, None, 0.0) == (
        px, cols, px - cols)


@pytest.mark.parametrize("theta,dx,dy,tile", [
    (0.2, 1.3, -2.2, 40), (-0.26, 4.0, 0.5, 64), (0.0, -3.5, 2.0, 100),
    (1e-4, 0.0, 0.0, 256)])
def test_wide_cover_counts_what_the_kernel_covers(theta, dx, dy, tile):
    """:func:`counts_wide.cover` against K2's coverage rule on every
    pixel of a 256 x 192 frame."""
    h, w = 256, 192
    cx, cy = (w - 1) / 2, (h - 1) / 2
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    c, s = math.cos(theta), math.sin(theta)
    sx = c * (xs - cx) - s * (ys - cy) + cx + dx
    sy = s * (xs - cx) + c * (ys - cy) + cy + dy
    cov = (sx >= 2) & (sx <= w - 4) & (sy >= 2) & (sy <= h - 4)
    cols = sum(int(cov[r:r + tile].any(0).sum()) for r in range(0, h, tile))
    assert counts_wide.cover(h, w, tile, theta, dx, dy) == (cov.sum(), cols)


def test_the_cell_is_registered_with_its_metrics():
    reg = _registry()
    config, mix = _cell()
    assert config["entry"] == "calibrate_register_stack_lean"
    assert config["reduced"] == [] and config["frames"] == 360
    assert mix["rotation_deg"] == [0.0, 15.0] and mix["star_edge_px"] == 224
    names = {m["name"] for m in reg.metrics("per_layer", CELL)}
    assert {"wide_roofline", "wide_frames_pct", "launches_per_stack",
            "device_idle_pct"} <= names
    assert "warp_combine_frames_pct" not in names
    e2e = {m["name"] for m in reg.metrics("end_to_end", CELL)}
    assert e2e == {"stack_gpix_s", "peak_mem_gb", "setup_s"}
    bench = json.loads(BENCHMARK.read_text())
    assert [c["chips"] for c in bench["workloads"]
            if c["name"] == CELL] == [1]


def _star_tables(seed, frames=8, stars=40, size=2048.0, sigma_px=0.01,
                 turn=(5, 15)):
    """Reference star tables (S,) and target tables (B, S) of frames
    turned ``turn`` deg (5-15) about the centre and shifted, each position with
    Gaussian centroid noise, two spurious detections a frame, and the
    true reference -> frame maps (B, 2, 3)."""
    g = np.random.default_rng(seed)
    c0 = (size - 1) / 2
    x, y = g.uniform(200, size - 200, (2, stars))
    flux = g.uniform(1000, 6000, stars)
    theta = g.choice([-1, 1], frames) * np.radians(g.uniform(*turn, frames))
    theta[0] = 0.0
    shift = g.uniform(-4, 4, (frames, 2))
    shift[0] = 0.0
    c, s = np.cos(theta)[:, None], np.sin(theta)[:, None]
    tx = c * (x - c0) - s * (y - c0) + c0 + shift[:, :1]
    ty = s * (x - c0) + c * (y - c0) + c0 + shift[:, 1:]
    tx, ty = (t + g.normal(0, sigma_px, t.shape) for t in (tx, ty))
    junk = g.uniform(0, size, (2, frames, 2))
    mats = np.zeros((frames, 2, 3))
    mats[:, 0, :2] = np.stack([c[:, 0], -s[:, 0]], 1)
    mats[:, 1, :2] = np.stack([s[:, 0], c[:, 0]], 1)
    mats[:, 0, 2] = c0 + shift[:, 0] - c[:, 0] * c0 + s[:, 0] * c0
    mats[:, 1, 2] = c0 + shift[:, 1] - s[:, 0] * c0 - c[:, 0] * c0

    def t(a):
        return torch.tensor(np.asarray(a), dtype=torch.float32)

    tgt = (t(np.concatenate([tx, junk[0]], 1)),
           t(np.concatenate([ty, junk[1]], 1)),
           t(np.concatenate([np.tile(flux, (frames, 1)),
                             np.full((frames, 2), 900.0)], 1)))
    ref_tab = (t(np.concatenate([x, [17.0, 2011.0]])),
               t(np.concatenate([y, [1900.0, 23.0]])),
               t(np.concatenate([flux, [900.0, 900.0]])))
    return ref_tab, tgt, mats


def _corners(sims, mats):
    solved = {k: getattr(sims, k).double().numpy()
              for k in ("scale", "theta", "tx", "ty")}
    return ref.corner_errors(ref.maps_of(solved), mats, 2048, 2048)


def _solve(ref_tab, tgt, k=10, candidates=1):
    rv = torch.ones_like(ref_tab[0], dtype=torch.bool)
    tv = torch.ones_like(tgt[0], dtype=torch.bool)
    sims = rg.estimate_similarity(*ref_tab, rv, *tgt, tv, k=k,
                                  candidates=candidates)
    return sims, rv, tv


def test_the_vote_returns_its_best_candidates():
    """``candidates`` M: (B, M) solves, the vote's own best first (its
    solve with one candidate), each refined."""
    ref_tab, tgt, mats = _star_tables(17)
    one, _, _ = _solve(ref_tab, tgt)
    many, _, _ = _solve(ref_tab, tgt, candidates=5)
    for field in one._fields:
        got, want = getattr(many, field), getattr(one, field)
        assert got.shape == (8, 5)
        torch.testing.assert_close(got[:, 0], want, rtol=1e-6, atol=1e-4)
    assert _corners(one, mats)[1:].max() < 0.3


def test_the_refit_keeps_the_candidate_with_most_pairs():
    """Of a frame's candidates, the refit keeps the one that pairs the
    most stars: a chance match first (the true solve 30 px off) gives
    way to the true one, and the true one first stays."""
    ref_tab, tgt, mats = _star_tables(19)
    sims, rv, tv = _solve(ref_tab, tgt)
    off = sims._replace(tx=sims.tx + 30.0)
    for order in ((off, sims), (sims, off)):
        pair = rg.Similarity(*(torch.stack(f, dim=1)
                               for f in zip(*order)))
        out = rg.refit_similarity(pair, ref_tab[0], ref_tab[1], rv, tgt[0],
                                  tgt[1], tv)
        assert _corners(out, mats)[1:].max() < 0.03
        assert (out.n_inliers == 40).all()


@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_refit_takes_out_a_blend_among_the_brightest(seed):
    """The second brightest reference star is a blend, 0.5 px off: the
    vote's fit to the 10 brightest carries it into every frame; the
    refit to all stars, the blend clipped, does not."""
    ref_tab, tgt, mats = _star_tables(seed)
    second = int(torch.argsort(ref_tab[2], descending=True)[1])
    ref_tab[0][second] += 0.5
    sims, rv, tv = _solve(ref_tab, tgt)
    vote = _corners(sims, mats)[1:]
    refit = rg.refit_similarity(sims, ref_tab[0], ref_tab[1], rv, tgt[0],
                                tgt[1], tv)
    after = _corners(refit, mats)[1:]
    assert vote.max() > 0.1 and after.max() < 0.03, (vote, after)
    assert (refit.n_inliers[1:] == 39).all()       # 40 stars, the blend out
    assert float(refit.rms[1:].max()) < 0.05


def test_refit_keeps_rejected_and_thin_solves():
    ref_tab, tgt, mats = _star_tables(11, frames=3)
    sims, rv, tv = _solve(ref_tab, tgt)
    tx = sims.tx.clone()
    tx[1] = rg.REJECTED_TRANSLATION
    rejected = sims._replace(tx=tx)
    out = rg.refit_similarity(rejected, ref_tab[0], ref_tab[1], rv, tgt[0],
                              tgt[1], tv)
    assert float(out.tx[1]) == rg.REJECTED_TRANSLATION
    assert int(out.n_inliers[1]) == int(sims.n_inliers[1])
    assert int(out.n_inliers[2]) > int(sims.n_inliers[2])
    # two stars in common: fewer than the refit's three, the vote's fit
    thin = tv.clone()
    thin[2, 2:40] = False
    out = rg.refit_similarity(sims, ref_tab[0], ref_tab[1], rv, tgt[0],
                              tgt[1], thin)
    for field in sims._fields:
        assert torch.equal(getattr(out, field)[2], getattr(sims, field)[2])


def _stars_of(ref_tab, tgt):
    """Stars tables (N, S): the reference tables as frame 0, then the
    target tables of frames 1..."""
    frames = [torch.cat([r[None], t[1:]]) for r, t in zip(ref_tab, tgt)]
    zeros = torch.zeros_like(frames[0])
    return Stars(*frames, zeros, zeros, zeros,
                 torch.ones_like(frames[0], dtype=torch.bool))


def test_only_a_turned_batch_is_solved_again():
    """A batch the vote turns no frame of past 2 deg keeps the vote's
    solves bit for bit (the reference's solve); one frame past it, and
    the whole batch is solved by ``solve_turned``."""
    # one reference: the tables of a seed differ only in the turns
    ref_tab, small, _ = _star_tables(13, turn=(0.0, 1.99))
    _, large, _ = _star_tables(13, turn=(2.05, 4.0))
    cfg = PipelineConfig(max_stars=42, match_k=10)
    for tgt, turned in ((small, False), (tuple(torch.cat([a[:7], b[7:]])
                                               for a, b in zip(small, large)),
                                         True)):
        sims, _m, _i = pl._solve_frame_similarities(_stars_of(ref_tab, tgt),
                                                    8, cfg)
        vote, rv, tv = _solve(ref_tab, tgt)
        assert bool(rg.turned_past(vote)) == turned
        want = rg.solve_turned(*ref_tab, rv, *tgt, tv, k=10) if turned \
            else vote
        for field in sims._fields:
            assert torch.equal(getattr(sims, field)[1:],
                               getattr(want, field)[1:].to(
                                   getattr(sims, field).dtype)), field
    assert (sims.n_inliers[1:] == 40).all()


def test_the_widened_vote_solves_shuffled_brightest():
    """A turned frame whose 10 brightest stars share 1 with the
    reference's 10 brightest: the reference's vote cannot find it (a
    candidate needs a pair in common), the widened vote (the reference's
    6 brightest against the frame's 24) and its refit do."""
    ref_tab, tgt, mats = _star_tables(23, frames=3)
    order = torch.argsort(ref_tab[2][:40], descending=True)
    flux = tgt[2].clone()
    # frame 2: the reference's brightest stays brightest, its next 9
    # drop to ranks 11-19, and its 11th-19th take their places
    new = ref_tab[2][:40].clone()
    new[order[1:10]], new[order[10:19]] = (ref_tab[2][order[10:19]],
                                           ref_tab[2][order[1:10]])
    flux[2, :40] = new
    tgt = (tgt[0], tgt[1], flux)
    vote, rv, tv = _solve(ref_tab, tgt)
    assert _corners(vote, mats)[2] > 1.0
    sims = rg.solve_turned(*ref_tab, rv, *tgt, tv, k=10)
    assert _corners(sims, mats)[1:].max() < 0.03
    assert (sims.n_inliers[1:] == 40).all()


def test_refit_pairs_are_mutual():
    """Two reference stars near one target star: only the nearer pairs."""
    fit = (torch.ones(1), torch.zeros(1), torch.zeros(1), torch.zeros(1))
    rx, ry = torch.tensor([[10.0, 11.0, 50.0]]), torch.tensor([[10.0] * 3])
    tx_, ty_ = torch.tensor([[10.2, 50.0]]), torch.tensor([[10.0, 10.0]])
    rv, tv = torch.ones_like(rx, dtype=torch.bool), torch.ones_like(
        tx_, dtype=torch.bool)
    nn, keep = rg._pairs(fit, rx, ry, rv, tx_, ty_, tv, 4.0)
    assert nn.tolist() == [[0, 0, 1]]
    assert keep.tolist() == [[True, False, True]]
