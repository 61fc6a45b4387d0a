"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``: these skip without a CUDA device.  They import no JAX, so
on a machine without it run them without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import clip_combine as cc
from astrophotography_tpu_torch.ops import detect_tiles as dt
from astrophotography_tpu_torch.ops import warp_combine as wc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _starfield(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((n, h, w), 500.0)
    for f in range(n):
        for x0, y0, a in zip(rng.uniform(20, w - 20, 24),
                             rng.uniform(20, h - 20, 24),
                             rng.uniform(1e3, 3e4, 24)):
            img[f] += a * np.exp(-0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2)
                                 / 1.6)
    img += rng.normal(0, 4, img.shape)
    return np.clip(img, 0, 65535).astype(np.uint16)


@pytest.mark.parametrize("masters", [False, True])
def test_detect_kernel_matches_plain(cuda, masters):
    n, h, w = 3, 256, 512
    fr = torch.from_numpy(_starfield(n, h, w, 0)).to(cuda)
    thr = torch.full((n,), 60.0, device=cuda)
    args = {}
    if masters:
        rng = np.random.default_rng(1)
        bias = torch.from_numpy((250 + rng.normal(0, 2, (h, w)))
                                .astype(np.float32)).to(cuda)
        dark = torch.full((h, w), 3.0, device=cuda)
        flat = 1.0 + 0.1 * torch.sin(torch.arange(h, device=cuda) * 0.7)[:, None] \
            * torch.ones((1, w), device=cuda)
        args = dict(mf_bc=dt.master_densities(bias, dark, flat),
                    a_plane=1.0 / flat,
                    exp_ratios=torch.full((n,), 2.0, device=cuda))
    before = kernels.launch_counts["detect_tiles"]
    got = dt.detect_tiles(fr, thr, **args)
    assert kernels.launch_counts["detect_tiles"] == before + 1
    want = dt.detect_tiles_plain(fr, thr, **args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-2)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-4)


def _warp_mats(n, seed, rotate=True):
    """Frame 0 identity, frame 2 a pure translation (both snapped), the
    rest translations of up to 5 px with, under ``rotate``, rotations of
    0.002-0.004 rad (the general tap bodies)."""
    rng = np.random.default_rng(seed)
    mats = []
    for f in range(n):
        th = 0.0 if f in (0, 2) or not rotate else \
            rng.choice([-1, 1]) * rng.uniform(0.002, 0.004)
        tx, ty = (0.0, 0.0) if f == 0 else rng.uniform(-5, 5, 2)
        c, s = np.cos(th), np.sin(th)
        mats.append([[c, -s, tx], [s, c, ty]])
    return np.asarray(mats, np.float32)


def _warp_check(raw, mats, masters, **kw):
    """K2 against its twin: bit for bit, one launch, >80% covered."""
    n = raw.shape[0]
    dev = raw.device
    mats = torch.tensor(mats, device=dev)
    args = dict(masters=masters, exp_ratios=torch.full((n,), 0.5, device=dev),
                flux_scales=torch.linspace(0.9, 1.1, n, device=dev), **kw)
    before = kernels.launch_counts["warp_combine"]
    got = wc.warp_combine(raw, mats, **args)
    assert kernels.launch_counts["warp_combine"] == before + 1
    want = wc.warp_combine_plain(raw, mats, **args)
    assert torch.equal(got, want)
    assert (got != 0).float().mean() > 0.8


def _warp_masters(h, w, dev):
    return torch.stack([torch.full((h, w), 1.02), torch.full((h, w), 300.0),
                        torch.full((h, w), 20.0)]).to(dev)


@pytest.mark.parametrize("combine", ["average", "median", "sum", "mean"])
@pytest.mark.parametrize("taps", ["exact", "lowrank"])
def test_warp_combine_kernel_equals_plain(cuda, combine, taps):
    """The kernel rounds every value operation as its twin does, so the
    two agree bit for bit."""
    n, h, w = 6, 128, 256
    raw = torch.from_numpy(_starfield(n, h, w, 3)).to(cuda)
    _warp_check(raw, _warp_mats(n, 2), _warp_masters(h, w, cuda),
                tile=(32, 128), combine=combine, general_taps=taps)


@pytest.mark.parametrize("combine", ["average", "median", "sum", "mean"])
@pytest.mark.parametrize("taps", ["exact", "lowrank"])
@pytest.mark.parametrize("tile", [(24, 384), (20, 256), (20, 176)])
def test_warp_combine_kernel_ragged_blocks(cuda, tile, taps, combine):
    """Tiles whose height (20) or width (176) the kernel's 8 x 32 block
    does not divide, on an image the tiles do not divide: the last block
    of a tile is clipped and still bit-identical, in every body."""
    n, h, w = 6, 256, 768
    raw = torch.from_numpy(_starfield(n, h, w, 3)).to(cuda)
    _warp_check(raw, _warp_mats(n, 2), _warp_masters(h, w, cuda),
                tile=tile, combine=combine, general_taps=taps)


@pytest.mark.parametrize("n,dtype,combine", [
    (240, torch.uint16, "median"), (908, torch.float32, "average")])
def test_warp_combine_kernel_many_frames(cuda, n, dtype, combine):
    """Above the frame counts where the block loses rows (7 rows at 240
    frames, 1 row at the 908-frame limit, where the window no longer fits
    the registers it is staged in), uint16 with masters and float32
    without, snapped translations."""
    assert kernels._warp_block_rows(n, 12) < 8
    h, w = 64, 256
    frames = torch.from_numpy(_starfield(n, h, w, 4)).to(cuda)
    masters = _warp_masters(h, w, cuda)
    if dtype == torch.float32:       # pre-calibrated input, no masters
        frames, masters = frames.to(torch.float32) * 1.02 - 300.0, None
    _warp_check(frames, _warp_mats(n, 5, rotate=False), masters,
                combine=combine)


def _clip_stack(n, h, w, seed):
    """Normal samples with outliers, ~20% masked samples and a fully
    masked pixel column."""
    rng = np.random.default_rng(seed)
    stack = rng.normal(800.0, 8.0, (n, h, w)).astype(np.float32)
    stack[rng.uniform(size=stack.shape) < 0.02] = 40000.0
    mask = rng.uniform(size=stack.shape) > 0.2
    mask[:, 3, 5] = False
    return stack, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 2, 24, 100])
def test_clip_combine_kernel_equals_plain(cuda, n, masked):
    """K3 rounds every value operation as its twin does, so the two agree
    bit for bit, NaN where nothing is kept included."""
    stack, mask = _clip_stack(n, 96, 300, n)
    st = torch.from_numpy(stack).to(cuda)
    mk = torch.from_numpy(mask).to(cuda) if masked else None
    before = kernels.launch_counts["clip_combine"]
    got = cc.clip_combine(st, mk, sigma_lower=3.0, sigma_upper=4.0)
    assert kernels.launch_counts["clip_combine"] == before + 1
    want = cc.clip_combine_plain(st, mk, sigma_lower=3.0, sigma_upper=4.0)
    torch.cuda.synchronize()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(got[ok], want[ok])
    assert bool(torch.isnan(got[3, 5])) == masked
    if masked:
        # a float mask (> 0.5 valid) is the same as the bool one
        fm = mk.to(torch.float32) * 0.75
        assert torch.equal(torch.nan_to_num(cc.clip_combine(st, fm, 3.0, 4.0)),
                           torch.nan_to_num(got))


def test_kernel_wrapper_rejects_bad_input(cuda):
    fr = torch.zeros((2, 128, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint16 or float32"):
        dt.detect_tiles(fr, torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="thresholds"):
        dt.detect_tiles(fr.to(torch.float32), torch.ones(3, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        cc.clip_combine(fr, None)
    with pytest.raises(ValueError, match="frames"):
        cc.clip_combine(torch.zeros((kernels._CLIP_MAX_FRAMES + 1, 2, 2),
                                    device=cuda))
