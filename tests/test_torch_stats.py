"""Port parity: masked and sigma-clipped statistics (ops/stats) and the
per-frame noise statistics against the JAX package, on the same numpy
inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu.models import pipeline as jpipe
from astrophotography_tpu.ops import stats as jstats
from astrophotography_tpu_torch.models import pipeline as tpipe
from astrophotography_tpu_torch.ops import stats as tstats

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

RTOL = 1e-6


def _data(seed=0, shape=(7, 40, 33)):
    """Normal samples with outliers, a random ~25% invalid mask, and one
    column (axis 0) with no valid entry at all."""
    rng = np.random.default_rng(seed)
    x = rng.normal(100.0, 5.0, shape).astype(np.float32)
    x[rng.uniform(size=shape) < 0.03] = 4000.0
    mask = rng.uniform(size=shape) > 0.25
    if len(shape) == 3:
        mask[:, 3, 4] = False
    mask[2, ..., 5] = False
    return x, mask


def _both(fn_name, x, mask, **kw):
    want = getattr(jstats, fn_name)(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask), **kw)
    got = getattr(tstats, fn_name)(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
        **kw)
    return got, want


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=RTOL, equal_nan=True)


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_median_matches_jax(axis, masked):
    x, mask = _data()
    if not masked:
        mask = np.ones_like(mask)
    got, want = _both("masked_median", x, mask, axis=axis)
    _close(got, want)
    if masked and axis == 0:
        assert np.isnan(got.numpy()[3, 4])          # empty column -> NaN


@pytest.mark.parametrize("axis", [None, 0, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_mean_std_matches_jax(axis, masked):
    x, mask = _data(1)
    if not masked:
        mask = np.ones_like(mask)
    (gm, gs), (wm, ws) = _both("masked_mean_std", x, mask, axis=axis)
    _close(gm, wm)
    _close(gs, ws)
    if masked and axis == 0:
        assert np.isnan(gm.numpy()[3, 4]) and np.isnan(gs.numpy()[3, 4])


@pytest.mark.parametrize("axis", [None, 0])
@pytest.mark.parametrize("masked", [False, True])
def test_mad_std_matches_jax(axis, masked):
    x, mask = _data(2)
    got, want = _both("mad_std", x, mask if masked else None, axis=axis)
    _close(got, want)


@pytest.mark.parametrize("cenfunc,stdfunc", [("median", "std"),
                                             ("median", "mad_std"),
                                             ("mean", "std")])
@pytest.mark.parametrize("masked", [False, True])
def test_sigma_clip_mask_matches_jax(cenfunc, stdfunc, masked):
    x, mask = _data(3)
    kw = dict(sigma_lower=2.5, sigma_upper=3.0, maxiters=4, axis=0,
              cenfunc=cenfunc, stdfunc=stdfunc)
    got, want = _both("sigma_clip_mask", x, mask if masked else None, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if masked:
        # the clip mask only shrinks: nothing invalid comes back
        assert not (got.numpy() & ~mask).any()
    if cenfunc == "median":
        # the 4000 outliers are clipped (a mean/std clip of 7 samples
        # cannot reach z = 2.5)
        assert got.numpy().sum() < (mask if masked
                                    else np.ones_like(mask)).sum()


@pytest.mark.parametrize("axis", [None, 1])
@pytest.mark.parametrize("stdfunc", ["std", "mad_std"])
@pytest.mark.parametrize("masked", [False, True])
def test_sigma_clipped_stats_matches_jax(axis, stdfunc, masked):
    x, mask = _data(4, shape=(5, 300))
    got, want = _both("sigma_clipped_stats", x, mask if masked else None,
                      sigma=3.0, maxiters=3, axis=axis, stdfunc=stdfunc)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("m", [1, 5, 64, 1000, 4096])
def test_row_sums_fold_each_row_alone(m):
    """``_row_sums`` (the noise statistics' sums) is each row's sum to
    float32 rounding, and a row's sum is the same bit for bit whether it
    is summed alone or in a batch."""
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.normal(800.0, 8.0, (7, m)).astype(np.float32))
    got = tpipe._row_sums(x)
    np.testing.assert_allclose(got.numpy(), x.double().sum(dim=1).numpy(),
                               rtol=1e-6)
    alone = torch.cat([tpipe._row_sums(x[i:i + 1]) for i in range(7)])
    assert torch.equal(got, alone)
    assert torch.equal(torch.cat([tpipe._row_sums(x[:3]),
                                  tpipe._row_sums(x[3:])]), got)


@pytest.mark.parametrize("center", ["mean", "median"])
def test_frame_noise_stats_matches_jax(center):
    rng = np.random.default_rng(5)
    frames = rng.normal(800.0, 8.0, (3, 256, 192)).astype(np.float32)
    frames[:, 40:44, 50:54] += 30000.0                # a star-like blob
    frames[1] += 25.0
    want = jpipe.frame_noise_stats(jnp.asarray(frames), center=center)
    got = tpipe.frame_noise_stats(torch.from_numpy(frames), center=center)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)


def test_median_noise_stats_fold_their_sums():
    """The 'median' noise statistics (``sigma_clipped_stats(sigma=3,
    maxiters=3, axis=1)``'s median and std) with the std's sums folded by
    ``_row_sums``: JAX's within the parity tolerance above, the port's
    own ``sigma_clipped_stats`` within float32 rounding, and the same
    bits for every frame whatever frames are beside it."""
    from astrophotography_tpu.ops.stats import \
        sigma_clipped_stats as jax_clipped
    from astrophotography_tpu_torch.ops.stats import sigma_clipped_stats

    rng = np.random.default_rng(11)
    sub = rng.normal(800.0, 8.0, (7, 3000)).astype(np.float32)
    sub[:, :40] += rng.uniform(1e3, 3e4, (7, 40)).astype(np.float32)
    sub[2] = 512.0                                     # no spread at all
    sub[4, ::3] = -200.0                               # a third low
    x = torch.from_numpy(sub)
    med, std = tpipe._noise_stats_from_sub(x, "median")
    _mean, jmed, jstd = jax_clipped(jnp.asarray(sub), sigma=3.0, maxiters=3,
                                    axis=1)
    np.testing.assert_allclose(med.numpy(), np.asarray(jmed), rtol=1e-5)
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-5)
    _m, pmed, pstd = sigma_clipped_stats(x, sigma=3.0, maxiters=3, axis=1)
    assert torch.equal(med, pmed)
    np.testing.assert_allclose(std.numpy(), pstd.numpy(), rtol=1e-6)
    assert float(std[2]) == 0.0 and float(med[2]) == 512.0
    for parts in ([3, 4], [1] * 7, [6, 1]):
        got = [tpipe._noise_stats_from_sub(p, "median")
               for p in torch.split(x, parts)]
        assert torch.equal(torch.cat([g[0] for g in got]), med)
        assert torch.equal(torch.cat([g[1] for g in got]), std)
