"""Port parity: the fused calibrate + warp + sigma-clip combine (K2),
host prep and values, against the JAX package's Pallas kernel (interpret
mode on the CPU backend)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis.strategies import data as st_data

import jax
import jax.numpy as jnp

from astrophotography_tpu import synth
from astrophotography_tpu.ops import pallas_warp_combine as pwc
from astrophotography_tpu_torch.ops import warp_combine as twc

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)


def _scene(n, h, w, seed, ty_range=(-5.0, 5.0)):
    """Calibrated frames of one scene plus masters and the raw uint16
    frames they calibrate back to; frame 0 identity (shifted down to
    ty_range[0] when that is positive), frame 2 a pure sub-pixel
    translation (both take the snapped path), the rest small rotations
    (the general tap bodies)."""
    rng = np.random.default_rng(seed)
    base = np.asarray(synth.make_rgb_scene((h, w), seed=seed,
                                           peak=5000)[..., 0], np.float32)
    base += synth.gaussian_star((h, w), w * 0.3, h * 0.4, 40000.0,
                                3.0).astype(np.float32)
    cal = np.stack([base + rng.normal(0, 3, (h, w)).astype(np.float32)
                    for _ in range(n)])
    mats = []
    for f in range(n):
        theta = 0.0 if f in (0, 2) else \
            rng.choice([-1, 1]) * rng.uniform(0.002, 0.004)
        tx, ty = (0.0, max(ty_range[0], 0.0)) if f == 0 else \
            (rng.uniform(-5, 5), rng.uniform(*ty_range))
        c, s = np.cos(theta), np.sin(theta)
        mats.append([[c, -s, tx], [s, c, ty]])
    mats = np.asarray(mats, np.float32)
    flat = (1.0 + 0.05 * np.cos(np.arange(w) * 0.05)[None, :]
            * np.ones((h, 1))).astype(np.float32)
    bias = (300.0 + rng.normal(0, 2, (h, w))).astype(np.float32)
    dark = np.abs(rng.normal(20.0, 3.0, (h, w))).astype(np.float32)
    er = rng.uniform(0.5, 1.5, n).astype(np.float32)
    fs = rng.uniform(0.8, 1.25, n).astype(np.float32)
    raw = np.clip(np.rint(cal * flat + bias + er[:, None, None] * dark),
                  0, 65535).astype(np.uint16)
    masters = np.stack([1.0 / flat, bias / flat, dark / flat]) \
        .astype(np.float32)
    return cal, raw, masters, mats, er, fs


def _capture_jax_prep(monkeypatch, frames, mats, **kw):
    """Run the JAX wrapper eagerly with pl.pallas_call replaced by a
    recorder: returns the kernel's operands and grid geometry exactly as
    the JAX host prep produced them."""
    seen = {}

    def fake_pallas_call(kernel, out_shape, grid_spec, **_unused):
        def call(mats_t, byp, bxp, *_ops):
            seen.update(mats=np.asarray(mats_t), byp=np.asarray(byp),
                        bxp=np.asarray(bxp), grid=tuple(grid_spec.grid),
                        n_specs=len(grid_spec.in_specs),
                        block=tuple(grid_spec.in_specs[0].block_shape),
                        scratch=[tuple(s.shape)
                                 for s in grid_spec.scratch_shapes])
            return jnp.zeros(out_shape.shape, out_shape.dtype)
        return call

    monkeypatch.setattr(pwc.pl, "pallas_call", fake_pallas_call)
    with jax.disable_jit():
        pwc.pallas_warp_combine(jnp.asarray(frames), jnp.asarray(mats), **kw)
    return seen


PREP_CASES = [
    # (n, h, w, kwargs)
    (5, 64, 128, dict(tile=(32, 64))),
    (5, 96, 192, dict(tile=(32, 64), apron=False, general_taps="lowrank")),
    (4, 192, 3072, dict(apron=False, span=8, dither_budget=8,
                        general_taps="lowrank")),
    (4, 96, 1536, dict(dither_budget=32)),
    (40, 64, 256, dict(span=10)),
]


@pytest.mark.parametrize("n,h,w,kw", PREP_CASES)
def test_host_prep_matches_jax_exactly(monkeypatch, n, h, w, kw):
    _cal, raw, masters, mats, er, fs = _scene(n, h, w, seed=n + h)
    mats[n - 1, 0, 2] = 1e9                    # a rejected registration
    seen = _capture_jax_prep(
        monkeypatch, raw, mats, masters=jnp.asarray(masters),
        exp_ratios=jnp.asarray(er), flux_scales=jnp.asarray(fs), **kw)
    kw = dict(kw)
    span = kw.get("span", 12)
    plan = twc.plan_warp_combine(
        (n, h, w), torch.from_numpy(mats), torch.from_numpy(er),
        torch.from_numpy(fs), tile=kw.get("tile"), span=span,
        apron=kw.get("apron", True), dither_budget=kw.get("dither_budget", 64),
        general_taps=kw.get("general_taps", "exact"))
    # tile, delivery blocks, window extents, grid
    assert seen["scratch"][0][1:] == (plan.th, plan.tw)
    assert seen["block"][1:] == (plan.bh, plan.bw)
    assert seen["scratch"][1] == (plan.vb * plan.bh, plan.hb * plan.bw)
    assert seen["n_specs"] == 2 * plan.vb * plan.hb
    assert seen["grid"][:2] == (plan.n_ti, plan.n_tj)
    # window origins and the snapped (N, 11) per-frame table, exactly
    np.testing.assert_array_equal(plan.byp.numpy(), seen["byp"])
    np.testing.assert_array_equal(plan.bxp.numpy(), seen["bxp"])
    np.testing.assert_array_equal(plan.table[:, :11].numpy(), seen["mats"])
    # per-(frame, tile) bases against the kernel's own scalar formula,
    # and base_ok from the captured window origins
    apron = kw.get("apron", True)
    oy = (2 * plan.th) // plan.bh if apron else 0
    ox = plan.tw // plan.bw if apron else 0
    tiles = plan.tiles.numpy().reshape(n, plan.n_ti, plan.n_tj, 3)
    m = jnp.asarray(seen["mats"])
    for f in range(n):
        for i in range(plan.n_ti):
            for j in range(plan.n_tj):
                vb_, ub_ = (int(v) for v in pwc._frame_bases(
                    m, f, i, j, plan.th, plan.tw, span))
                wy0 = (int(seen["byp"][i, j]) - oy) * plan.bh
                wx0 = (int(seen["bxp"][i, j]) - ox) * plan.bw
                ok = (wy0 <= max(vb_, 0)
                      and min(vb_ + plan.th + span, h) <= wy0
                      + plan.vb * plan.bh
                      and wx0 <= max(ub_, 0)
                      and min(ub_ + plan.tw + span, w) <= wx0
                      + plan.hb * plan.bw)
                assert tuple(tiles[f, i, j]) == (vb_, ub_, int(ok)), (f, i, j)


def _compare(got, ref):
    """Zero coverage equal; values within rtol 2e-4 (the reference's snap
    path rides the MXU as a bf16 hi/lo split) and atol 0.5, except for
    sigma-clip tie flips: a sample within float rounding of a clip bound
    (seen: 7e-7 relative) may be kept on one side and dropped on the
    other, on at most 1e-4 of the pixels."""
    np.testing.assert_array_equal(got == 0, ref == 0)
    off = np.abs(got - ref) > 0.5 + 2e-4 * np.abs(ref)
    assert off.mean() <= 1e-4, (off.sum(), np.argwhere(off)[:5])


@pytest.mark.parametrize("combine", ["average", "median", "sum", "mean"])
@pytest.mark.parametrize("taps", ["exact", "lowrank"])
@pytest.mark.parametrize("source", ["calibrated", "raw_masters"])
def test_warp_combine_matches_pallas(combine, taps, source):
    cal, raw, masters, mats, er, fs = _scene(5, 64, 128, seed=7)
    if source == "calibrated":
        jargs, targs = (jnp.asarray(cal),), (torch.from_numpy(cal),)
        jkw, tkw = {}, {}
    else:
        jargs, targs = (jnp.asarray(raw),), (torch.from_numpy(raw),)
        jkw = dict(masters=jnp.asarray(masters), exp_ratios=jnp.asarray(er),
                   flux_scales=jnp.asarray(fs))
        tkw = dict(masters=torch.from_numpy(masters),
                   exp_ratios=torch.from_numpy(er),
                   flux_scales=torch.from_numpy(fs))
    ref = np.asarray(pwc.pallas_warp_combine(
        *jargs, jnp.asarray(mats), tile=(32, 64), combine=combine,
        general_taps=taps, **jkw))
    got = twc.warp_combine(*targs, torch.from_numpy(mats), tile=(32, 64),
                           combine=combine, general_taps=taps, **tkw).numpy()
    assert got.dtype == np.float32 and got.shape == (64, 128)
    assert (got != 0).mean() > 0.8
    _compare(got, ref)


@pytest.mark.parametrize("combine,taps", [("average", "exact"),
                                          ("median", "lowrank")])
def test_warp_combine_apron_free_matches_pallas(combine, taps):
    # every frame shifted down >= 4 px, so the top tiles' taps start
    # inside the image: the TPU kernel rotates a negative tap offset into
    # window rows it never assembled, which its interpret mode fills
    # with NaN (on the chip they are stale finite values under zero
    # weight), poisoning those pixels in the reference only
    _cal, raw, masters, mats, er, fs = _scene(5, 96, 192, seed=11,
                                              ty_range=(4.0, 6.0))
    ref = np.asarray(pwc.pallas_warp_combine(
        jnp.asarray(raw), jnp.asarray(mats), masters=jnp.asarray(masters),
        exp_ratios=jnp.asarray(er), flux_scales=jnp.asarray(fs),
        tile=(32, 64), apron=False, combine=combine, general_taps=taps))
    got = twc.warp_combine(
        torch.from_numpy(raw), torch.from_numpy(mats),
        masters=torch.from_numpy(masters), exp_ratios=torch.from_numpy(er),
        flux_scales=torch.from_numpy(fs), tile=(32, 64), apron=False,
        combine=combine, general_taps=taps).numpy()
    assert (got == 0).any()          # the apron-free border ring
    _compare(got, ref)


def test_rejected_frame_is_excluded_everywhere():
    cal, _raw, _m, mats, _er, _fs = _scene(5, 64, 128, seed=3)
    keep = twc.warp_combine(torch.from_numpy(cal[:4]),
                            torch.from_numpy(mats[:4]), tile=(32, 64),
                            combine="mean")
    bad = mats.copy()
    bad[4, :, 2] = 1e9                       # REJECTED_TRANSLATION
    cal[4] = 1e6                             # would dominate any mean
    got = twc.warp_combine(torch.from_numpy(cal), torch.from_numpy(bad),
                           tile=(32, 64), combine="mean")
    # same frames contribute, though the window geometry sees 5 frames
    assert torch.isfinite(got).all()
    assert got.max() < 1e5
    both = (keep != 0) & (got != 0)
    assert both.float().mean() > 0.8
    torch.testing.assert_close(got[both], keep[both], rtol=1e-5, atol=1e-3)


def test_wrapper_equals_plain_on_cpu():
    cal, _raw, _m, mats, _er, _fs = _scene(4, 64, 128, seed=5)
    args = (torch.from_numpy(cal), torch.from_numpy(mats))
    a = twc.warp_combine(*args, tile=(32, 64), combine="median")
    b = twc.warp_combine_plain(*args, tile=(32, 64), combine="median")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rejects_bad_arguments():
    cal, _raw, _m, mats, _er, _fs = _scene(3, 64, 128, seed=1)
    c, m = torch.from_numpy(cal), torch.from_numpy(mats)
    with pytest.raises(ValueError, match="apron-free"):
        twc.warp_combine(c, m, tile=(32, 64), apron=False)
    with pytest.raises(ValueError, match="snap_tol"):
        twc.warp_combine(c, m, tile=(32, 64), snap_tol=0.0,
                         general_taps="lowrank")
    with pytest.raises(ValueError, match="combine"):
        twc.warp_combine(c, m, tile=(32, 64), combine="max")
    with pytest.raises(ValueError, match="exceed span"):
        twc.warp_combine(c, m, tile=(8, 64))


@pytest.mark.parametrize("span", [4, 6, 7])
def test_lowrank_needs_span_above_7(span):
    """The lowrank body's gate su_lr <= min(span, 9) - 7 cannot hold at
    span <= 7, where the reference silently excludes every frame that is
    not a pure translation: the port refuses the configuration.  At span
    8 the gate admits a small rotation."""
    cal, _raw, _m, _mats, _er, _fs = _scene(3, 64, 128, seed=1)
    th = 0.002
    rot = np.array([[[1, 0, 0], [0, 1, 0]],
                    [[np.cos(th), -np.sin(th), 1.5],
                     [np.sin(th), np.cos(th), -0.5]],
                    [[1, 0, 0.25], [0, 1, 0.5]]], np.float32)
    c, m = torch.from_numpy(cal), torch.from_numpy(rot)
    with pytest.raises(ValueError, match=r"needs span > 7, got "
                                         f"{span}.*cannot hold"):
        twc.plan_warp_combine(c.shape, m, tile=(32, 64), span=span,
                              general_taps="lowrank")
    twc.plan_warp_combine(c.shape, m, tile=(32, 64), span=span,
                          general_taps="exact")
    plan = twc.plan_warp_combine(c.shape, m, tile=(32, 64), span=8,
                                 general_taps="lowrank")
    assert plan.table[1, 8] == 0.0 and plan.table[1, 14] == 1.0


def test_kernel_frame_limit_message():
    """K2 has no frame limit of its own: below the crossing of the route
    sweep (150 frames), where a shared block keeps all 8 rows, its
    N-sample columns stay in shared memory ('smem'); from the crossing on
    (and wherever a window leaves a shared block no room for them) they
    take the 'cols' route, whose columns past its reach are sorted in runs
    and merged, and no frame count is refused before the card."""
    from astrophotography_tpu_torch import kernels

    assert not hasattr(kernels, "_MAX_FRAMES")
    assert kernels._WARP_SMEM_ROWS == 8
    assert kernels._WARP_COLS_FRAMES == 150
    for span in (8, 12):
        assert kernels._warp_route(149, span) == "smem"
        assert kernels._warp_smem_rows(149, span) == 8
        assert kernels._warp_route(150, span) == "cols"
    # a wider window loses the eighth shared row below 150 frames
    assert kernels._warp_smem_rows(137, 100) == 8
    assert kernels._warp_route(137, 100) == "smem"
    assert kernels._warp_route(138, 100) == "cols"
    assert kernels._warp_route(100, 12) == "smem"
    for n in (909, 1200, 7232, 7233, 10 ** 6):
        assert kernels._warp_route(n, 12) == "cols"
        assert kernels._warp_block_rows(n, 12) == 8
    # the reach: 8 warps' columns in 227 KB
    assert kernels._warp_cols_run(8, 12) == 7232
    assert kernels._warp_cols_run(8, 8) == 7232
    assert kernels._warp_cols_run(1, 190) == 58112
    assert kernels._warp_cols_smem_bytes(10 ** 6, 8, 12, 7232) <= \
        kernels._SMEM_MAX
    # a window that leaves no shared block takes 'cols' below the crossing
    assert kernels._warp_smem_rows(100, 190) == 0
    assert kernels._warp_route(100, 190) == "cols"


@pytest.mark.parametrize("n,span,rows", [
    (909, 8, 8), (909, 12, 8), (1200, 12, 8), (5000, 100, 8), (1200, 190, 4),
    (908, 150, 8), (500, 192, 1), (150, 187, 8), (150, 188, 7),
    (1, 191, 2), (100, 192, 1)])
def test_kernel_global_route(n, span, rows):
    """Past the crossing, and below where the columns and the window of a
    shared block outgrow shared memory, K2's 'cols' block
    keeps 8 rows of 32 pixels (a very wide span still costs rows), its
    combine tile of one column per warp over the window's words, and its
    scratch is an N-sample column and two words per pixel of each
    resident block: 264 blocks of 256 threads take ~325 MB at 1200
    frames."""
    from astrophotography_tpu_torch import kernels

    assert kernels._warp_route(n, span) == "cols"
    assert kernels._warp_block_rows(n, span) == rows
    run = kernels._warp_cols_run(rows, span)
    smem = kernels._warp_cols_smem_bytes(n, rows, span, run)
    assert smem <= kernels._SMEM_MAX
    assert smem >= kernels._warp_smem_bytes(0, rows, span)
    assert smem >= 4 * rows * min(n, run)
    if rows < 8:
        assert kernels._warp_smem_bytes(0, rows + 1, span) > kernels._SMEM_MAX
    assert kernels._warp_scratch_bytes(n, rows, 264) == \
        4 * (n + 2) * 32 * rows * 264
    assert kernels._warp_scratch_bytes(1200, 8, 264) == 324943872


@pytest.mark.parametrize("n,span,rows", [
    (1, 12, 8), (100, 8, 8), (100, 12, 8), (216, 8, 8), (216, 12, 7),
    (400, 12, 4), (908, 100, 1), (1, 186, 8), (149, 90, 8), (150, 91, 7),
    (148, 91, 8), (137, 100, 8)])
def test_kernel_block_rows(n, span, rows):
    """A K2 'smem' block keeps 8 rows of 32 pixels while its N-sample
    columns and window fit; where they would leave fewer rows (``rows``
    below 8) the route sweep measured 'cols' faster, so 'smem' refuses
    the smaller block and 'cols' (8 rows at these spans) takes the
    count, as it does from 150 frames on."""
    from astrophotography_tpu_torch import kernels

    assert kernels._warp_smem_rows(n, span) == rows
    assert kernels._warp_smem_bytes(n, rows, span) <= kernels._SMEM_MAX
    if rows < 8:
        assert kernels._warp_smem_bytes(n, rows + 1, span) > kernels._SMEM_MAX
        assert kernels._warp_route(n, span) == "cols"
        with pytest.raises(ValueError, match="'smem' route"):
            kernels._warp_block_rows(n, span, "smem")
    else:
        assert kernels._warp_route(n, span) == ("smem" if n < 150 else "cols")
        assert kernels._warp_block_rows(n, span, "smem") == 8
    assert kernels._warp_block_rows(n, span, "cols") == 8


def test_kernel_main_shape_fits_two_blocks_per_sm():
    """At the main path's 100 frames two 256-thread blocks share an SM
    (233472 B of shared memory, 1 KB of it reserved per block)."""
    from astrophotography_tpu_torch import kernels

    for span in (8, 12):
        assert 2 * (kernels._warp_smem_bytes(100, 8, span) + 1024) <= 233472


def test_kernel_rejects_span_beyond_shared_memory():
    """K2 takes every span up to the 'wide' route's reach: past 192 one
    row's window outgrows a shared block and 'wide' takes the span (its
    mid rows in shared memory); past 1436 one output row's mid rows and
    the 8 warps' window rows outgrew the route's first layout, and the
    kernel raises, naming the limit (its present layout keeps 8 rows
    there).  The shared routes forced past 192 still refuse."""
    from astrophotography_tpu_torch import kernels

    assert kernels._WARP_WIDE_MAX_SPAN == 1436
    assert kernels._warp_block_rows(908, 192) == 1
    for n in (1, 908, 1200):
        assert kernels._warp_block_rows(n, 193) == 32
        assert kernels._warp_block_rows(n, 200) == 32
        assert kernels._warp_block_rows(n, 1436) == 8
        with pytest.raises(ValueError, match=r"shared memory .*one output "
                                             r"row's mid rows; the 'wide' "
                                             r"route takes spans up to 1436"):
            kernels._warp_block_rows(n, 1437)
    for route in ("smem", "cols"):
        with pytest.raises(ValueError, match=f"'{route}' route: a window of "
                                             f"span 193 needs more than "
                                             f"232448 B"):
            kernels._warp_block_rows(100, 193, route)


#: K2's route table before the 'wide' route, for every span <= 192: the
#: first frame count on 'cols' (spans 1-90: 150; 91-192: below) and the
#: rows of a 'cols' block (8 to span 187; 188-192: below); a 'smem'
#: block keeps 8 rows
_OLD_CROSSING = dict(zip(range(91, 193), (
    149, 147, 146, 145, 144, 143, 142, 140, 139, 138, 137, 135, 134, 133,
    132, 130, 129, 128, 127, 125, 124, 123, 121, 120, 119, 117, 116, 115,
    113, 112, 111, 109, 108, 106, 105, 104, 102, 101, 99, 98, 96, 95, 93,
    92, 90, 89, 87, 86, 84, 83, 81, 80, 78, 77, 75, 73, 72, 70, 69, 67, 65,
    64, 62, 61, 59, 57, 56, 54, 52, 51, 49, 47, 45, 44, 42, 40, 38, 37, 35,
    33, 31, 30, 28, 26, 24, 22, 21, 19, 17, 15, 13, 11, 10, 8, 6, 4, 2, 1,
    1, 1, 1, 1)))
_OLD_COLS_ROWS = {188: 7, 189: 5, 190: 4, 191: 2, 192: 1}


def test_kernel_routes_up_to_span_192_are_unchanged():
    """For every span <= 192, :func:`kernels._warp_route` and
    :func:`kernels._warp_block_rows` give the table they gave before the
    'wide' route (around each crossing and at the frame counts the paths
    use); 'wide' starts at 193 for every frame count."""
    from astrophotography_tpu_torch import kernels

    for span in range(1, 193):
        cross = _OLD_CROSSING.get(span, 150)
        rows = _OLD_COLS_ROWS.get(span, 8)
        for n in {1, 2, 100, 149, 150, 151, 908, 1200, 7233,
                  *range(max(cross - 2, 1), cross + 3)}:
            want = ("smem", 8) if n < cross else ("cols", rows)
            got = (kernels._warp_route(n, span),
                   kernels._warp_block_rows(n, span))
            assert got == want, (span, n)
    for span in (193, 194, 256, 1000, 1436):
        for n in (1, 100, 150, 1200):
            assert kernels._warp_route(n, span) == "wide"


@pytest.mark.parametrize("span,rows", [(193, 32), (256, 32), (1000, 32),
                                       (1411, 32), (1417, 32), (1418, 16),
                                       (1430, 16), (1431, 8), (1436, 8)])
def test_kernel_wide_route_arithmetic(span, rows):
    """A 'wide' block keeps the most of 32, 16, ..., 1 output rows whose
    mid rows ((rows + span) x 32 floats), one window row per warp (8 x
    (32 + span)), two frames' snap weights and mid-row ranges and a ring
    of 4 frames' parameters fit 227 KB.  Over the same words the combine
    takes nothing up to 32 frames (registers), each warp's n x 32 columns
    up to 112, else the 'cols' tile of one column per warp (its reach the
    'cols' route's, 7232 samples).  An SM keeps 3 blocks where their
    shared memory fits it, else 2.  Its scratch is the 'cols' route's per
    pixel, and the grid stops at 1 GiB of it: 218 blocks of 32 rows at
    1200 frames."""
    from astrophotography_tpu_torch import kernels

    assert kernels._warp_wide_rows(span) == rows
    smem = kernels._warp_wide_smem_bytes(rows, span)
    assert smem == 4 * ((rows + span) * 32 + 8 * (32 + span) + 2 * 16
                        + 4 * 20 + 2 * 2)
    assert smem <= kernels._SMEM_MAX
    if rows < 32:
        assert kernels._warp_wide_smem_bytes(2 * rows, span) > \
            kernels._SMEM_MAX
    run = kernels._warp_cols_run(kernels._WARP_WIDE_WARPS, span)
    assert run == 7232
    for n in (3, 24, 32, 33, 100, 112, 113, 160, 1200, 7232, 10 ** 5):
        total = kernels._warp_wide_smem_total(n, rows, span, run)
        combine = (0 if n <= 32 else 4 * 8 * n * 32 if n <= 112
                   else 4 * 8 * kernels._cols_stride(min(n, run), 8))
        assert max(smem, combine) == total <= kernels._SMEM_MAX
        blocks = kernels._warp_wide_min_blocks(n, rows, span, run)
        assert blocks == (3 if 3 * (total + 1024) <= 233472 else 2)
    assert kernels._warp_wide_smem_total(24, 32, 256, run) == 46544
    assert [kernels._warp_wide_min_blocks(n, kernels._warp_wide_rows(s), s,
                                          run)
            for n, s in ((24, 256), (100, 256), (360, 288), (6, 1436))] == \
        [3, 2, 3, 2]
    for n, grid in ((24, 264), (1200, 218), (5000, 52)):
        got = kernels._warp_wide_grid(n, 32, 10 ** 6, 264)
        assert got == grid
        assert kernels._warp_scratch_bytes(n, 32, got) <= \
            kernels._WARP_WIDE_SCRATCH_MAX
    assert kernels._warp_wide_grid(10 ** 7, 32, 10 ** 6, 264) == 1
    assert kernels._warp_wide_grid(24, 32, 100, 264) == 100


@pytest.mark.parametrize("taps", ["exact", "lowrank"])
def test_warp_combine_span_200_matches_pallas(taps):
    """At span 200 (past 192: the CUDA kernel's 'wide' route) with a tile
    taller than the span, the twin against the JAX kernel in interpret
    mode, by ``_compare``'s rule."""
    cal, _raw, _m, mats, _er, _fs = _scene(3, 64, 128, seed=7)
    kw = dict(tile=(208, 128), span=200, general_taps=taps)
    ref = np.asarray(pwc.pallas_warp_combine(jnp.asarray(cal),
                                             jnp.asarray(mats), **kw))
    got = twc.warp_combine(torch.from_numpy(cal), torch.from_numpy(mats),
                           **kw).numpy()
    assert (got != 0).mean() > 0.9
    _compare(got, ref)


@settings(max_examples=80, deadline=None)
@given(data=st_data())
def test_combine_by_runs_is_the_twin(data):
    """Past the 'cols' reach K2 combines a column from sorted runs:
    bisected ranks, and the kept samples summed in ascending chunks below
    a bisected key, then the ties at it.  The plain statement of that rule
    is the twin's combine bit for bit on random, tied, +-0, mostly
    uncovered and single-covered columns, at run lengths down to 2."""
    from hypothesis import strategies as st

    n = data.draw(st.integers(1, 60))
    kind = data.draw(st.sampled_from(["random", "tied", "zeros", "single"]))
    if kind == "random":
        vals = data.draw(st.lists(st.floats(-1e5, 1e5, width=32), min_size=n,
                                  max_size=n))
    else:
        pool = {"tied": [3.0, 7.5, 7.5, 100.0, 1e4],
                "zeros": [0.0, -0.0, 1.0, -1.0, 2.0],
                "single": [42.0]}[kind]
        vals = data.draw(st.lists(st.sampled_from(pool), min_size=n,
                                  max_size=n))
    col = np.asarray(vals, np.float32)
    uncovered = data.draw(st.lists(st.booleans(), min_size=n, max_size=n))
    col[np.asarray(uncovered)] = twc._BIG
    if kind == "single":
        col[:] = twc._BIG
        col[data.draw(st.integers(0, n - 1))] = 42.0
    if not (col < twc._BIG).any():
        col[0] = vals[0]
    run = data.draw(st.integers(2, 16))
    sl, su = data.draw(st.sampled_from([(1.0, 1.0), (1.5, 2.0), (5.0, 5.0)]))
    t = torch.from_numpy(col)
    for combine in ("average", "median", "sum"):
        want = twc._combine_plain(t[:, None, None], combine, sl, su)[0, 0]
        got = twc.combine_by_runs(t, combine, sl, su, run)
        assert torch.equal(got, want), (combine, run)


@pytest.mark.parametrize("combine", ["average", "median", "sum", "mean"])
def test_plain_combine_in_row_bands_is_the_whole(monkeypatch, combine):
    """The plain twin combines a deep stack in bands of rows, so that its
    sorts fit the card; each pixel's result is its own, so bands of 5 rows
    give the one-band result bit for bit."""
    cal, raw, masters, mats, er, fs = _scene(6, 48, 64, 9)
    args = dict(masters=torch.from_numpy(masters),
                exp_ratios=torch.from_numpy(er),
                flux_scales=torch.from_numpy(fs), tile=(16, 64), span=8,
                combine=combine, sigma_lower=1.5, sigma_upper=1.5)
    raw_t, mats_t = torch.from_numpy(raw), torch.from_numpy(mats)
    whole = twc.warp_combine_plain(raw_t, mats_t, **args)
    monkeypatch.setattr(twc, "_PLAIN_BAND_BYTES", 4 * 6 * 64 * 5)
    banded = twc.warp_combine_plain(raw_t, mats_t, **args)
    assert torch.equal(banded, whole)
    assert (whole != 0).float().mean() > 0.5
