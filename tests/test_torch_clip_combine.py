"""Port parity: the sigma-clip combines.  K3's plain twin
(ops/clip_combine, what a CPU tensor runs) against the JAX package's
Pallas kernel in interpret mode, on the cases of
tests/test_pallas_combine.py and the edge cases; ``sigma_clip_combine``
(ops/stack) against the JAX function for every method."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from astrophotography_tpu.ops.pallas_combine import pallas_sigma_clip_combine
from astrophotography_tpu.ops.stack import sigma_clip_combine as jax_combine
from astrophotography_tpu_torch.ops.clip_combine import (clip_combine,
                                                         clip_combine_plain)
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
