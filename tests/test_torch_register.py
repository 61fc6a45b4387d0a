"""Port parity: star-pattern registration (ops/register) against the JAX
package on the same star tables."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from astrophotography_tpu.ops import register as jreg
from astrophotography_tpu_torch.models.config import similarity_to_numpy
from astrophotography_tpu_torch.ops import register as treg

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

CAP = 48


def _apply_sim(x, y, scale, theta, tx, ty):
    c, s = scale * np.cos(theta), scale * np.sin(theta)
    return c * x - s * y + tx, s * x + c * y + ty


def _table(x, y, flux, rng=None, jitter=0.0):
    n = len(x)
    if rng is not None:
        x = x + rng.normal(0, jitter, n)
        y = y + rng.normal(0, jitter, n)
    pad = CAP - n
    return (np.pad(x, (0, pad)).astype(np.float32),
            np.pad(y, (0, pad)).astype(np.float32),
            np.pad(flux, (0, pad)).astype(np.float32),
            np.pad(np.ones(n, bool), (0, pad)))


def _frames(n_frames=6, seed=1):
    """A reference table and n_frames target tables: shuffled, with
    dropped and spurious stars and 0.05 px centroid noise; the last
    target is a 1-star frame (a rejected solve)."""
    rng = np.random.default_rng(seed)
    n = 30
    rx, ry = rng.uniform(20, 1000, n), rng.uniform(20, 1000, n)
    flux = rng.uniform(1000, 50000, n)
    ref = _table(rx, ry, flux)
    tgts = []
    for i in range(n_frames - 1):
        theta = rng.uniform(-0.01, 0.01) if i else 0.0
        txy = rng.uniform(-8, 8, 2)
        sx, sy = _apply_sim(rx, ry, 1.0, theta, *txy)
        keep = rng.permutation(n)[:n - 4]
        x = np.concatenate([sx[keep], rng.uniform(0, 1000, 4)])
        y = np.concatenate([sy[keep], rng.uniform(0, 1000, 4)])
        f = np.concatenate([flux[keep], rng.uniform(1000, 50000, 4)])
        tgts.append(_table(x, y, f, rng, 0.05))
    tgts.append(_table(np.array([500.0]), np.array([500.0]),
                       np.array([1e4])))
    return ref, tgts


@pytest.mark.parametrize("k", [10, 12])
def test_estimate_similarity_matches_jax_batched(k):
    ref, tgts = _frames()
    stacked = [np.stack([t[i] for t in tgts]) for i in range(4)]
    jsim = jax.vmap(lambda x, y, f, v: jreg.estimate_similarity(
        *(jnp.asarray(a) for a in ref), x, y, f, v, k=k))(
        *(jnp.asarray(a) for a in stacked))
    tsim = treg.estimate_similarity(
        *(torch.from_numpy(a) for a in ref),
        *(torch.from_numpy(a) for a in stacked), k=k)
    got = similarity_to_numpy(tsim)
    want = {f: np.asarray(getattr(jsim, f)) for f in jsim._fields}
    np.testing.assert_array_equal(got["n_inliers"], want["n_inliers"])
    np.testing.assert_allclose(got["tx"], want["tx"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["ty"], want["ty"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["theta"], want["theta"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["scale"], want["scale"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["rms"], want["rms"], rtol=0, atol=1e-3)
    assert got["n_inliers"][:-1].min() >= 5
    assert got["tx"][-1] == treg.REJECTED_TRANSLATION


def test_estimate_similarity_unbatched_matches_jax():
    ref, tgts = _frames(n_frames=3, seed=4)
    jsim = jreg.estimate_similarity(*(jnp.asarray(a) for a in ref),
                                    *(jnp.asarray(a) for a in tgts[1]), k=12)
    tsim = treg.estimate_similarity(*(torch.from_numpy(a) for a in ref),
                                    *(torch.from_numpy(a) for a in tgts[1]),
                                    k=12)
    assert tsim.tx.dim() == 0
    assert int(tsim.n_inliers) == int(jsim.n_inliers)
    assert float(tsim.tx) == pytest.approx(float(jsim.tx), abs=1e-3)
    assert float(tsim.theta) == pytest.approx(float(jsim.theta), abs=1e-5)


def test_solve_similarity_and_matrix_match_jax():
    rng = np.random.default_rng(0)
    src = rng.uniform(0, 100, (20, 2)).astype(np.float32)
    dx, dy = _apply_sim(src[:, 0], src[:, 1], 1.02, 0.05, 5.0, -3.0)
    dst = np.stack([dx, dy], axis=1).astype(np.float32)
    w = (rng.uniform(size=20) > 0.2).astype(np.float32)
    want = jreg.solve_similarity(jnp.asarray(src), jnp.asarray(dst),
                                 jnp.asarray(w))
    got = treg.solve_similarity(torch.from_numpy(src), torch.from_numpy(dst),
                                torch.from_numpy(w))
    np.testing.assert_allclose([float(v) for v in got],
                               [float(v) for v in want], rtol=1e-5, atol=1e-4)
    sim = treg.Similarity(*(torch.tensor([v], dtype=torch.float32)
                            for v in (1.01, 0.02, 3.0, -4.0, 9, 0.1)))
    jm = jreg.Similarity(*(jnp.float32(v)
                           for v in (1.01, 0.02, 3.0, -4.0, 9, 0.1))).matrix()
    np.testing.assert_allclose(sim.matrix()[0].numpy(), np.asarray(jm),
                               rtol=1e-6, atol=1e-6)
