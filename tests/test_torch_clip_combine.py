"""Port parity: the sigma-clip combines.  K3's plain twin
(ops/clip_combine, what a CPU tensor runs) against the JAX package's
Pallas kernel in interpret mode, on the cases of
tests/test_pallas_combine.py and the edge cases; ``sigma_clip_combine``
(ops/stack) against the JAX function for every method."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis.strategies import data as st_data

import jax.numpy as jnp

from astrophotography_tpu.ops.pallas_combine import pallas_sigma_clip_combine
from astrophotography_tpu.ops.stack import sigma_clip_combine as jax_combine
from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops.clip_combine import (
    _BIG, clip_combine, clip_combine_plain, float_keys, float_of_keys,
    mad_ranks_by_merging, mad_ranks_by_search, pair_by_radix,
    rank_by_bisection)
from astrophotography_tpu_torch.ops.stack import sigma_clip_combine

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)


def _k3_case(name):
    """(stack, mask or None, sigma): the three cases of
    tests/test_pallas_combine.py and the edge cases."""
    if name == "outliers":
        rng = np.random.default_rng(0)
        stack = rng.normal(100, 5, (8, 96, 80)).astype(np.float32)
        stack[2, 10, 10] = 50000.0
        stack[5, 40, 60] = -40000.0
        return stack, None, 5.0
    if name == "masked":
        rng = np.random.default_rng(1)
        stack = rng.normal(50, 3, (6, 64, 64)).astype(np.float32)
        mask = rng.uniform(size=stack.shape) > 0.2
        mask[:, 5, 5] = False                    # fully invalid pixel
        return stack, mask, 5.0
    if name == "non_tile_divisible":
        rng = np.random.default_rng(2)
        return rng.normal(10, 1, (4, 50, 70)).astype(np.float32), None, 4.0
    if name == "single_frame":
        rng = np.random.default_rng(3)
        stack = rng.normal(20, 2, (1, 40, 48)).astype(np.float32)
        mask = rng.uniform(size=stack.shape) > 0.3
        return stack, mask, 5.0
    # masked non-finite samples: the reference's x * keep compiles to a
    # select, so they add 0 instead of poisoning the pixel
    rng = np.random.default_rng(4)
    stack = rng.normal(300, 10, (7, 40, 40)).astype(np.float32)
    mask = rng.uniform(size=stack.shape) > 0.2
    mask[:, 9, 9] = False
    stack[3, 7, 7], mask[3, 7, 7] = np.inf, False
    stack[1, 20, 21], mask[1, 20, 21] = np.nan, False
    stack[4, 30, 30], mask[4, 30, 30] = -1e30, True     # a valid outlier
    return stack, mask, 3.0


K3_CASES = ["outliers", "masked", "non_tile_divisible", "single_frame",
            "masked_non_finite"]


@pytest.mark.parametrize("name", K3_CASES)
def test_clip_combine_plain_matches_pallas(name):
    stack, mask, sigma = _k3_case(name)
    want = np.asarray(pallas_sigma_clip_combine(
        jnp.asarray(stack), mask=None if mask is None else jnp.asarray(mask),
        sigma_lower=sigma, sigma_upper=sigma, tile=(32, 32), interpret=True))
    mask_t = None if mask is None else torch.from_numpy(mask)
    got = clip_combine(torch.from_numpy(stack), mask=mask_t,
                       sigma_lower=sigma, sigma_upper=sigma).numpy()
    assert got.shape == stack.shape[1:]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3,
                               equal_nan=True)
    if mask is not None:
        # a float mask (> 0.5 valid), as the JAX API passes it, is the same
        fmask = torch.from_numpy(mask.astype(np.float32) * 0.9)
        np.testing.assert_array_equal(
            clip_combine_plain(torch.from_numpy(stack), fmask, sigma,
                               sigma).numpy(), got)
    if name == "masked":
        assert np.isnan(got[5, 5])
    if name == "masked_non_finite":
        assert np.isfinite(got[7, 7]) and np.isfinite(got[20, 21])
        assert np.isnan(got[9, 9]) and np.isfinite(got[30, 30])


def test_clip_combine_rejects_bad_shapes():
    with pytest.raises(ValueError, match="N, H, W"):
        clip_combine(torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="mask"):
        clip_combine(torch.zeros((2, 4, 4)), torch.ones((2, 4, 5), dtype=bool))


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 16, 17, 24, 33])
def test_mad_ranks_by_merging_equal_sorted_deviations(n):
    """The rule K3 uses in place of a second sort: on samples with ties
    and every valid count from 0 to N, merging the two runs of deviations
    around the median gives the ranks of the sorted deviations, bit for
    bit."""
    rng = np.random.default_rng(n)
    pix = 40 * (n + 1)
    stack = np.round(rng.normal(100, 3, (n, pix))).astype(np.float32)
    stack[:, ::3] += rng.normal(0, 1, (n, len(range(0, pix, 3)))) \
        .astype(np.float32)
    count = np.arange(pix) % (n + 1)              # every count, 0 .. n
    valid = np.stack([rng.permutation(n) < c for c in count], axis=1)
    st, va = torch.from_numpy(stack), torch.from_numpy(valid)
    cnt = va.sum(dim=0)
    lo_i = torch.clamp((cnt - 1) // 2, min=0)[None]
    hi_i = (cnt // 2)[None]
    srt = torch.sort(torch.where(va, st, _BIG), dim=0).values
    med = (0.5 * (srt.gather(0, lo_i) + srt.gather(0, hi_i)))[0]
    dsrt = torch.sort(torch.where(va, (st - med).abs(), _BIG), dim=0).values
    d_lo, d_hi = mad_ranks_by_merging(srt, cnt, med)
    assert torch.equal(d_lo, dsrt.gather(0, lo_i)[0])
    assert torch.equal(d_hi, dsrt.gather(0, hi_i)[0])
    assert set(count.tolist()) == set(range(n + 1))


def test_clip_kernel_block_shapes():
    """Every frame count gets a route and a block whose shared memory fits
    the 232,448 bytes a block may use: the register networks to 32
    frames, 'smem' (a thread per pixel in blocks of 128) below the
    crossing of the route sweep (192 frames), then 'cols' with the most
    warps (8, 4, 2, 1) whose two columns per pixel fit, up to its reach
    (29024 frames), then 'select' (a radix select over the stack, no
    scratch)."""
    reach = kernels._CLIP_COLS_REACH
    assert reach == 29024
    assert kernels._CLIP_COLS_FRAMES == 192
    assert [kernels._clip_route(n) for n in (1, 8, 9, 16, 17, 24, 25, 32, 33,
                                             191, 192, reach, reach + 1,
                                             100000)] == \
        ["regs8", "regs8", "regs16", "regs16", "regs24", "regs24", "regs32",
         "regs32", "smem", "smem", "cols", "cols", "select", "select"]
    for n in list(range(33, 4000)) + list(range(4000, reach + 1, 97)) + [reach]:
        warps = kernels._clip_cols_warps(n)
        assert warps in (8, 4, 2, 1)
        assert kernels._clip_cols_smem_bytes(n, warps) <= 232448
        # the widest block that fits
        assert warps == 8 or \
            kernels._clip_cols_smem_bytes(n, 2 * warps) > 232448
    assert [kernels._clip_cols_warps(n) for n in
            (3616, 3617, 7232, 7233, 14496, 14497, reach, reach + 1)] == \
        [8, 4, 4, 2, 2, 1, 1, 0]
    # two columns of n rounded up to 32 (+ a bank pad) per pixel, a count
    # per warp and pixel, two clip bounds per pixel
    assert kernels._clip_cols_smem_bytes(100, 8) == \
        4 * (2 * 8 * 132 + 64 + 16)
    assert kernels._clip_cols_smem_bytes(1200, 8) == 78400
    # 'smem': two columns of n per thread of 128, up to 227 frames
    assert kernels._CLIP_SMEM_FRAMES == 227
    for n in (33, 191, 227):
        assert kernels._clip_smem_threads(n) == 128
        assert 2 * 4 * n * 128 <= 232448
    with pytest.raises(ValueError, match="227"):
        kernels._clip_smem_threads(228)
    with pytest.raises(ValueError, match="at least 1"):
        kernels._clip_route(0)


def _rank_columns(draw, n, kind):
    """A (n,) float32 column of one kind: random, tied (few values),
    +-0 among small integers, all +3.4e38, one valid sample."""
    from hypothesis import strategies as st

    if kind == "big":
        return np.full(n, _BIG, np.float32)
    if kind == "zeros":
        vals = draw(st.lists(st.sampled_from([0.0, -0.0, 1.0, -1.0, 2.0]),
                             min_size=n, max_size=n))
    elif kind == "tied":
        vals = draw(st.lists(st.sampled_from([3.0, 7.5, 7.5, 100.0]),
                             min_size=n, max_size=n))
    else:
        vals = draw(st.lists(st.floats(-1e6, 1e6, width=32), min_size=n,
                             max_size=n))
    col = np.asarray(vals, np.float32)
    if kind == "single":
        col[:] = _BIG
        col[draw(st.integers(0, n - 1))] = vals[0]
    return col


@settings(max_examples=60, deadline=None)
@given(data=st_data())
def test_rank_by_bisection_is_the_sort(data):
    """K2's runs past the 'cols' reach take a rank as the smallest
    monotone key with more than k samples at or below it:
    the sorted column's value at k, on random, tied, +-0, all-+3.4e38 and
    single-valid columns (a zero comes back +0, equal to either)."""
    from hypothesis import strategies as st

    n = data.draw(st.integers(1, 40))
    kind = data.draw(st.sampled_from(["random", "tied", "zeros", "big",
                                      "single"]))
    col = torch.from_numpy(_rank_columns(data.draw, n, kind))
    keys = float_keys(col)
    assert torch.equal(float_of_keys(keys), torch.where(col == 0, 0.0, col))
    order = torch.argsort(keys)
    assert torch.equal(torch.sort(col).values, col[order])   # keys are monotone
    ks = torch.arange(n)
    got = rank_by_bisection(col[:, None].expand(n, n), ks)
    assert torch.equal(got, torch.sort(col).values)


@pytest.mark.parametrize("h,w,grid", [(480, 640, (20, 480)),
                                      (256, 512, (16, 256)),
                                      (8, 44, (2, 8)), (70000, 33, (2, 65535))])
def test_kernel_select_route_arithmetic(h, w, grid):
    """K3's 'select' route: a block of 8 warps owns 32 neighbouring pixels
    of a row (one 128 B line of each frame row); its shared memory is the
    digit histograms [256][32] (the clip pass's two chunks of 64 x 32
    floats over the same words), six words of a rank pair's state and
    four more per pixel: 34,048 B, room for 6 blocks an SM.  Nine passes over
    the stack whatever the data: four 8-bit digits for the median's pair
    of ranks, four for the MAD's, one clip pass.  The grid: a block per 32
    columns, a row of blocks per image row up to 65535.  The route starts
    past the 'cols' reach (29024 frames), unchanged."""
    assert kernels._CLIP_SELECT_PIXELS == 32
    assert kernels._CLIP_SELECT_WARPS == 8
    assert kernels._clip_select_smem_bytes() == 4 * (256 * 32 + 10 * 32) \
        == 34048
    assert max(256 * 32, 2 * kernels._CLIP_SELECT_CHUNK * 32) == 256 * 32
    assert 6 * (kernels._clip_select_smem_bytes() + 1024) <= 233472 < \
        7 * (kernels._clip_select_smem_bytes() + 1024)
    assert kernels._CLIP_SELECT_PASSES == 9 == 2 * 32 // 8 + 1
    assert kernels._clip_select_grid(h, w) == grid
    assert kernels._CLIP_COLS_REACH == 29024
    assert kernels._clip_route(29024) == "cols"
    assert kernels._clip_route(29025) == kernels._clip_route(10 ** 6) \
        == "select"


@settings(max_examples=80, deadline=None)
@given(data=st_data())
def test_pair_by_radix_is_the_sort(data):
    """K3's 'select' route takes the median's two ranks (and the MAD's)
    by an MSB-first radix select over the monotone keys, hi sharing lo's
    walk until it leaves lo's bucket and then taken as the least key with
    its prefix: the sorted column's values at lo and hi = lo or lo + 1,
    on random, tied, +-0, all-+3.4e38 and single-valid columns, for every
    count of valid samples (a zero comes back +0, equal to either)."""
    from hypothesis import strategies as st

    n = data.draw(st.integers(1, 40))
    kind = data.draw(st.sampled_from(["random", "tied", "zeros", "big",
                                      "single"]))
    col = torch.from_numpy(_rank_columns(data.draw, n, kind))
    srt = torch.sort(col).values
    counts = torch.arange(n + 1)
    lo = torch.clamp(torch.div(counts - 1, 2, rounding_mode="floor"), min=0)
    hi = torch.clamp(torch.div(counts, 2, rounding_mode="floor"), min=0)
    hi = torch.minimum(hi, torch.full_like(hi, n - 1))
    a, b = pair_by_radix(col[:, None].expand(n, n + 1), lo, hi)
    assert torch.equal(a, srt[lo]) and torch.equal(b, srt[hi])


@settings(max_examples=60, deadline=None)
@given(data=st_data())
def test_mad_ranks_by_search_is_the_sort(data):
    """The 'cols' routes take the MAD's ranks by bisecting the two runs of
    deviations around the median (kth_dev): the ranks of the sorted
    deviations, over the valid samples (K3) or all N (K2)."""
    from hypothesis import strategies as st

    n = data.draw(st.integers(1, 40))
    kind = data.draw(st.sampled_from(["random", "tied", "zeros", "single"]))
    col = torch.from_numpy(_rank_columns(data.draw, n, kind))
    valid = col < _BIG
    if kind != "single":
        valid = torch.tensor(data.draw(st.lists(st.booleans(), min_size=n,
                                                max_size=n)))
    if not bool(valid.any()):
        valid[data.draw(st.integers(0, n - 1))] = True
    st_, va = col[:, None], valid[:, None]
    cnt = va.sum(dim=0)
    lo_i = torch.clamp((cnt - 1) // 2, min=0)[None]
    hi_i = (cnt // 2)[None]
    srt = torch.sort(torch.where(va, st_, _BIG), dim=0).values
    med = (0.5 * (srt.gather(0, lo_i) + srt.gather(0, hi_i)))[0]
    dsrt = torch.sort(torch.where(va, (st_ - med).abs(), _BIG), dim=0).values
    d_lo, d_hi = mad_ranks_by_search(srt, cnt, med)
    assert torch.equal(d_lo, dsrt.gather(0, lo_i)[0])
    assert torch.equal(d_hi, dsrt.gather(0, hi_i)[0])
    dall = torch.sort((srt - med).abs(), dim=0).values
    a_lo, a_hi = mad_ranks_by_search(srt, cnt, med, end=torch.full_like(cnt, n))
    assert torch.equal(a_lo, dall.gather(0, lo_i)[0])
    assert torch.equal(a_hi, dall.gather(0, hi_i)[0])


def _stack_case(seed=5):
    rng = np.random.default_rng(seed)
    stack = rng.normal(100, 4, (9, 33, 41)).astype(np.float32)
    stack[rng.uniform(size=stack.shape) < 0.04] = 3000.0
    stack[2, :, 3] = -2000.0
    mask = rng.uniform(size=stack.shape) > 0.15
    mask[:, 4, 4] = False
    stack[5, 6, 7], mask[5, 6, 7] = np.inf, False     # clipped when valid
    weights = np.linspace(0.5, 1.5, 9).astype(np.float32)
    return stack, mask, weights


@pytest.mark.parametrize("maxiters", [1, 3])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method,weighted", [("average", False),
                                             ("average", True),
                                             ("median", False),
                                             ("sum", False)])
def test_sigma_clip_combine_matches_jax(method, weighted, masked, maxiters):
    stack, mask, weights = _stack_case()
    kw = dict(method=method, sigma_lower=3.0, sigma_upper=4.0,
              maxiters=maxiters)
    want = np.asarray(jax_combine(
        jnp.asarray(stack), mask=jnp.asarray(mask) if masked else None,
        weights=jnp.asarray(weights) if weighted else None, **kw))
    got = sigma_clip_combine(
        torch.from_numpy(stack), mask=torch.from_numpy(mask) if masked else None,
        weights=torch.from_numpy(weights) if weighted else None, **kw).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3,
                               equal_nan=True)
    with pytest.raises(ValueError, match="method"):
        sigma_clip_combine(torch.from_numpy(stack), method="mode")
