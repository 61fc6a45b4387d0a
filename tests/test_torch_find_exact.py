"""Exact detection's kernel (``csrc/find_exact.cu``) and its twin
``ops/detect.find_stars_plain``.

On the CPU: the route rule (which calls the kernel takes and which keep
the composed twin), the launcher's refusals, the dispatch (CPU tensors
take the twin), and the kernel's selection restated in numpy (tiles of 32
x 126, each keeping its best peaks by the 64-bit key, then a radix select
over the frame's candidates) against the twin's tables bit for bit.

On the card (marker ``gpu``; these import no JAX, so run them without the
suite's conftest):

    python -m pytest --noconftest -m gpu tests/test_torch_find_exact.py -q

the kernel path of ``find_stars`` against ``find_stars_plain`` on the same
CUDA tensors, bit for bit in every ``Stars`` field (a NaN only has to be
a NaN).
"""

import re

import numpy as np
import pytest
import torch

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import detect as dt

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)

_MASK64 = (1 << 64) - 1


def _starfield(n, h, w, seed, stars=12, noise=4.0, device="cpu"):
    """(N, H, W) float32 frames about 0: Gaussian stars of FWHM ~3 px and
    read noise, from numpy's generator (the same values on any device)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = rng.normal(0.0, noise, (n, h, w))
    for f in range(n):
        for x0, y0, a in zip(rng.uniform(3, w - 3, stars),
                             rng.uniform(3, h - 3, stars),
                             rng.uniform(200.0, 5000.0, stars)):
            img[f] += a * np.exp(-0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2)
                                 / 1.6)
    return torch.from_numpy(img.astype(np.float32)).to(device)


def _same_stars(got, want, what=""):
    """Every Stars field equal bit for bit (signed zeros included; a NaN
    only has to be a NaN)."""
    for name, g, x in zip(dt.Stars._fields, got, want):
        assert g.shape == x.shape and g.dtype == x.dtype, (what, name)
        if g.dtype == torch.bool:
            assert torch.equal(g, x), (what, name)
            continue
        nan_g, nan_x = torch.isnan(g), torch.isnan(x)
        assert torch.equal(nan_g, nan_x), (what, name, "NaN")
        gb = torch.where(nan_g, 0.0, g).view(torch.int32)
        xb = torch.where(nan_x, 0.0, x).view(torch.int32)
        assert torch.equal(gb, xb), (what, name,
                                     int((gb != xb).sum()), g.numel())


# --- the route rule -----------------------------------------------------

def _route(shape, max_stars=48, topk_mode="global", mode="exact", fwhm=3.0):
    kernel, foot, r = dt.daofind_kernel(fwhm)
    return dt._find_route(shape, max_stars, topk_mode, mode, kernel, foot, r)


@pytest.mark.parametrize("shape,kw,want", [
    ((24, 4096, 4096), {}, "kernel"),                # the unfused cell
    ((4096, 4096), {}, "kernel"),                    # one frame
    ((3, 37, 53), {}, "kernel"),                     # odd, ragged
    ((2, 4096, 4096), {"max_stars": 1024}, "kernel"),
    ((2, 4096, 4096), {"max_stars": 2048}, "kernel"),
    ((2, 4096, 4096), {"max_stars": 2049}, "max_stars"),
    ((2, 4, 8), {"max_stars": 16}, "kernel"),        # 2 x 8 pair maxima
    ((2, 4, 8), {"max_stars": 17}, "max_stars"),     # the twin's top-k raises
    ((2, 3, 5), {"max_stars": 15}, "kernel"),
    ((2, 3, 5), {"max_stars": 16}, "max_stars"),
    ((2, 4096, 4096), {"mode": "fast"}, "fast"),
    ((2, 4096, 4096), {"topk_mode": "tile"}, "tile"),
    # too few whole tiles: the twin ranks every pair maximum, as the kernel
    ((2, 4096, 4096), {"topk_mode": "tile", "max_stars": 1025}, "kernel"),
    ((2, 1000, 1000), {"topk_mode": "tile"}, "kernel"),
    ((2, 4096, 4096), {"fwhm": 11.3}, "kernel"),     # radius 8
    ((2, 4096, 4096), {"fwhm": 11.34}, "radius"),    # radius 9
    ((2, 4096, 4096), {"fwhm": 2.0}, "kernel"),      # radius 2 (the least)
])
def test_route_rule(shape, kw, want):
    assert _route(shape, **kw) == want


def test_radius_limit_is_the_sources():
    """The radii with an instance are those of the source's switch, and
    its constants are the launcher's mirror."""
    src = (kernels._SRC / kernels._SOURCES["find_exact"]).read_text()
    cases = [int(v) for v in re.findall(r"TILES_CASE\((\d+)\)", src)
             if v != "R"]
    assert sorted(set(cases)) == list(kernels._FIND_RADII)
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["TH"]) == kernels._FIND_TH
    assert int(consts["TW"]) == kernels._FIND_TW
    assert int(consts["KMAX"]) == kernels._FIND_MAX_STARS
    assert int(consts["RMIN"]) == kernels._FIND_RADII[0]
    assert int(consts["RMAX"]) == kernels._FIND_RADII[-1]
    assert [dt._kernel_radius(f) for f in (11.33, 11.34)] == [8, 9]


def test_a_zero_tap_in_the_footprint_takes_the_twin():
    kernel, foot, r = dt.daofind_kernel(3.0)
    assert _route((2, 64, 64)) == "kernel"
    doctored = kernel.copy()
    doctored[r, r + 1] = 0.0
    assert dt._find_route((2, 64, 64), 48, "global", "exact", doctored,
                          foot, r) == "taps"


def test_candidate_slots():
    """A frame's buffer holds each tile's peaks, or its k best: 128 x 33
    tiles of 32 x 126 at 4096^2."""
    assert kernels._FIND_TILE_PEAKS == 16 * 63
    assert kernels._find_exact_cap(4096, 4096, 48) == 128 * 33 * 48
    assert kernels._find_exact_cap(4096, 4096, 2048) == 128 * 33 * 1008
    assert kernels._find_exact_cap(37, 53, 5) == 2 * 1 * 5


def test_cpu_tensors_take_the_twin(monkeypatch):
    """On the CPU ``find_stars`` is the twin, bit for bit, and nothing
    reaches the launcher or its count."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel launcher")

    monkeypatch.setattr(kernels, "find_exact_cuda", refuse)
    before = dict(kernels.launch_counts)
    data = _starfield(2, 40, 64, seed=3)
    thr = torch.tensor([30.0, 40.0])
    kw = dict(fwhm=3.0, threshold=thr, max_stars=8, stats=True)
    _same_stars(dt.find_stars(data, **kw), dt.find_stars_plain(data, **kw))
    one = dt.find_stars(data[1], **dict(kw, threshold=40.0))
    _same_stars(one, dt.find_stars_plain(data[1],
                                         **dict(kw, threshold=40.0)))
    assert dict(kernels.launch_counts) == before


def test_no_fallback_on_other_devices():
    data = torch.empty((2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no find_exact kernel"):
        dt.find_stars(data, threshold=1.0)


def test_launcher_refuses_what_the_kernel_does_not_take():
    kernel, _foot, r = dt.daofind_kernel(3.0)
    data = torch.zeros((2, 16, 16))
    thr = torch.zeros(2)
    args = (kernel, r, thr, None, 8, 2, False)
    with pytest.raises(ValueError, match="float32"):
        kernels.find_exact_cuda(data.double(), *args)
    with pytest.raises(ValueError, match="radii 2 to 8"):
        big, _f, rb = dt.daofind_kernel(12.0)
        kernels.find_exact_cuda(data, big, rb, thr, None, 8, 2, False)
    with pytest.raises(ValueError, match="stars"):
        kernels.find_exact_cuda(data, kernel, r, thr, None, 4096, 2, False)
    with pytest.raises(ValueError, match="taps must be"):
        kernels.find_exact_cuda(data, kernel[1:, 1:], r, thr, None, 8, 2,
                                False)
    with pytest.raises(ValueError, match="mask must be bool"):
        kernels.find_exact_cuda(data, kernel, r, thr,
                                torch.zeros((16, 16), dtype=torch.uint8), 8,
                                2, False)
    with pytest.raises(ValueError, match="mask must be"):
        kernels.find_exact_cuda(data, kernel, r, thr,
                                torch.zeros((3, 16, 16), dtype=torch.bool),
                                8, 2, False)


# --- the kernel's selection restated ------------------------------------

def _order_key(vals: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``order_key`` of the source: the value's order bits (-0 as +0) and
    the complement of the index, as uint64."""
    u = vals.astype(np.float32).view(np.uint32).copy()
    u[(u & np.uint32(0x7FFFFFFF)) == 0] = 0
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return (u.astype(np.uint64) << np.uint64(32)) | \
        (np.uint64(0xFFFFFFFF) - idx.astype(np.uint64))


def _radix_kth(keys: np.ndarray, k: int) -> int:
    """The k-th largest of distinct uint64 ``keys``: 8 passes of 8 bits
    from the top, as ``find_merge_kernel`` runs them."""
    prefix, need = 0, k
    for shift in range(56, -1, -8):
        high = 0 if shift == 56 else (_MASK64 << (shift + 8)) & _MASK64
        match = keys[(keys & np.uint64(high)) == np.uint64(prefix)]
        hist = np.bincount(((match >> np.uint64(shift)) & np.uint64(255))
                           .astype(np.int64), minlength=256)
        run = 0
        for digit in range(255, -1, -1):
            if run + hist[digit] >= need:
                need -= run
                prefix |= digit << shift
                break
            run += hist[digit]
    return prefix


def _kernel_tables(data, fwhm, thr, k, mask=None, border=2, stats=False,
                   floor=0.0):
    """The kernel's (values, rows, columns) restated from the twin's
    density: the 8-neighbour comparisons, each tile of 32 x 126 keeping
    its k best keys, the frame's k best by the radix select; then the
    twin's own measuring, so the result is comparable field by field."""
    single, data, floor_f = dt._frames(data, floor)
    n, h, w = data.shape
    kernel, foot, r = dt.daofind_kernel(fwhm)
    dens = dt._conv2d_same(data, kernel)
    if mask is not None:
        dens = torch.where(mask, -torch.inf, dens)
    d = np.pad(dens.numpy(), ((0, 0), (1, 1), (1, 1)),
               constant_values=-np.inf)
    c = d[:, 1:-1, 1:-1]
    with np.errstate(invalid="ignore"):
        peak = np.ones_like(c, dtype=bool)
        for dy, dx in ((0, 0), (0, 1), (0, 2), (1, 0)):
            peak &= c > d[:, dy:dy + h, dx:dx + w]
        for dy, dx in ((1, 2), (2, 0), (2, 1), (2, 2)):
            peak &= c >= d[:, dy:dy + h, dx:dx + w]
        peak &= c > np.asarray(thr, np.float32).reshape(-1, 1, 1)
    edge = border + r
    peak[:, :edge] = peak[:, h - edge:] = False
    peak[:, :, :edge] = peak[:, :, w - edge:] = False
    vals = np.full((n, k), -np.inf, np.float32)
    py = np.zeros((n, k), np.int64)
    px = np.zeros((n, k), np.int64)
    for f in range(n):
        ys, xs = np.nonzero(peak[f])
        v = c[f, ys, xs]
        idx = (ys // 2) * w + xs if h % 2 == 0 else ys * w + xs
        keys = _order_key(v, idx)
        assert len(np.unique(keys)) == len(keys)
        tile = (ys // kernels._FIND_TH) * 10**6 + xs // kernels._FIND_TW
        kept = []
        for t in np.unique(tile):
            sel = np.nonzero(tile == t)[0]
            kept.extend(sel[np.argsort(keys[sel])[::-1][:k]])
        kept = np.asarray(kept, np.int64)
        if len(kept) > k:
            kth = _radix_kth(keys[kept], k)
            kept = kept[keys[kept] >= np.uint64(kth)]
            assert len(kept) == k
        order = kept[np.argsort(keys[kept])[::-1]]
        m = len(order)
        vals[f, :m], py[f, :m], px[f, :m] = v[order], ys[order], xs[order]
    return dt._measure(data, torch.from_numpy(vals), torch.from_numpy(py),
                       torch.from_numpy(px), dens, foot, r, 1, stats,
                       floor_f, single)


@pytest.mark.parametrize("h,w", [(64, 256), (65, 256), (37, 53), (96, 300)])
@pytest.mark.parametrize("stats", [False, True])
def test_selection_restated_equals_the_twin(h, w, stats):
    data = _starfield(3, h, w, seed=h + w, stars=10)
    thr = torch.tensor([20.0, 40.0, 30.0])
    kw = dict(fwhm=3.0, threshold=thr, max_stars=6, stats=stats,
              floor=torch.tensor([0.5, -1.0, 0.0]))
    _same_stars(_kernel_tables(data, 3.0, thr, 6, stats=stats,
                               floor=kw["floor"]),
                dt.find_stars_plain(data, **kw))


def test_selection_equal_peaks_in_a_row_pair():
    """Equal peaks in rows 2k and 2k + 1 rank by column (the pair
    index), not by raster index; on an odd height by raster index."""
    for h in (32, 33):
        data = torch.zeros((1, h, 64))
        for y, x in ((10, 40), (11, 20), (14, 30), (15, 30 + 6)):
            data[0, y, x] = 100.0
        thr = torch.tensor([1.0])
        got = _kernel_tables(data, 3.0, thr, 4)
        want = dt.find_stars_plain(data, threshold=thr, max_stars=4,
                                   stats=False)
        _same_stars(got, want, f"h={h}")
        # (10, 40) and (11, 20): one row pair, so column 20 first
        assert round(float(want.x[0, 0])) == (20 if h % 2 == 0 else 40)


@pytest.mark.parametrize("k", [3, 40])
def test_selection_noise_at_no_threshold(k):
    """Pure noise with the threshold at -inf: hundreds of peaks a tile,
    more than k, trimmed by rank in the tiles and selected over the
    frame."""
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.normal(0, 1, (2, 70, 260)).astype(
        np.float32))
    thr = torch.full((2,), -torch.inf)
    _same_stars(_kernel_tables(data, 3.0, thr, k),
                dt.find_stars_plain(data, threshold=thr, max_stars=k,
                                    stats=False))


def test_selection_non_finite_pixels_and_a_mask():
    data = _starfield(2, 64, 130, seed=9, stars=14)
    data[0, 20, 30] = float("nan")
    data[0, 40, 100] = float("inf")
    data[1, 10, 10] = -float("inf")
    data[1, 33, 64] = float("inf")
    mask = torch.zeros((64, 130), dtype=torch.bool)
    mask[30:40, 50:90] = True
    thr = torch.tensor([25.0, 25.0])
    for m in (None, mask):
        got = _kernel_tables(data, 3.0, thr, 20, mask=m, stats=True)
        want = dt.find_stars_plain(data, threshold=thr, max_stars=20,
                                   mask=m, stats=True)
        _same_stars(got, want, f"mask {m is not None}")


def test_radix_select_restated():
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 2**63, 5000, dtype=np.int64)
                     .astype(np.uint64) * np.uint64(2))
    for k in (1, 7, 48, 2048, len(keys)):
        assert _radix_kth(keys, k) == int(np.sort(keys)[::-1][k - 1])


# --- on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _check(data, **kw):
    """find_stars (the kernel, one launch) against find_stars_plain on
    the same tensors."""
    kernel, foot, r = dt.daofind_kernel(kw.get("fwhm", 3.0))
    assert dt._find_route(data.shape, kw.get("max_stars", 1024),
                          kw.get("topk_mode", "global"), "exact", kernel,
                          foot, r) == "kernel"
    before = kernels.launch_counts["find_exact"]
    got = dt.find_stars(data, **kw)
    assert kernels.launch_counts["find_exact"] == before + 1
    want = dt.find_stars_plain(data, **kw)
    torch.cuda.synchronize()
    _same_stars(got, want)
    return got


@pytest.mark.gpu
def test_the_cells_frames(cuda):
    """24 x 4096^2 as the unfused cell detects them: stats off, 48 stars,
    per-frame thresholds and floors."""
    g = torch.Generator(device=cuda).manual_seed(11)
    data = 800.0 + 8.0 * torch.randn((24, 4096, 4096), generator=g,
                                     device=cuda)
    ys = torch.randint(8, 4088, (24, 400), generator=g, device=cuda)
    xs = torch.randint(8, 4088, (24, 400), generator=g, device=cuda)
    amp = 300.0 + 3000.0 * torch.rand((24, 400), generator=g, device=cuda)
    f = torch.arange(24, device=cuda)[:, None].expand_as(ys)
    data[f, ys, xs] += amp                         # cosmic-ray hits
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            data[f[:, :40], ys[:, :40] + dy, xs[:, :40] + dx] += \
                5e3 * (0.5 if dy or dx else 1.0)   # stars
    center = data.mean(dim=(1, 2))
    std = data.std(dim=(1, 2))
    _check(data, fwhm=3.0, threshold=7.0 * std, max_stars=48, stats=False,
           floor=center)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 257, 512), (2, 64, 300), (3, 37, 53),
                                   (1, 9, 130)])
@pytest.mark.parametrize("stats", [False, True])
def test_shapes(cuda, shape, stats):
    """Odd heights, widths that are no multiple of 4 (scalar staging) or
    of the tile, frames smaller than a tile."""
    n, h, w = shape
    data = _starfield(n, h, w, seed=h * w, stars=8, device=cuda)
    thr = torch.linspace(15.0, 40.0, n, device=cuda)
    _check(data, threshold=thr, max_stars=min(12, (h // 2) * w), stats=stats,
           floor=torch.linspace(-2.0, 2.0, n, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("stats", [False, True])
def test_single_frame_and_masks(cuda, stats):
    data = _starfield(3, 300, 640, seed=4, stars=30, device=cuda)
    mask = torch.zeros((300, 640), dtype=torch.bool, device=cuda)
    mask[100:180, 200:420] = True
    _check(data[1], threshold=30.0, max_stars=64, stats=stats, mask=mask)
    _check(data, threshold=30.0, max_stars=64, stats=stats, mask=mask)
    per = torch.rand((3, 300, 640), device=cuda) < 0.05
    _check(data, threshold=30.0, max_stars=64, stats=stats, mask=per)
    _check(data, threshold=30.0, max_stars=64, stats=stats, mask=per[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("fwhm", [2.0, 3.0, 4.0, 5.5, 7.0, 8.5, 9.3, 11.3])
def test_every_radius(cuda, fwhm):
    """Radius 2 (FWHM 3) to 8, the largest the kernel takes."""
    data = _starfield(2, 200, 380, seed=int(fwhm * 10), stars=10,
                      device=cuda)
    _check(data, fwhm=fwhm, threshold=20.0, max_stars=16, stats=True)


@pytest.mark.gpu
def test_non_finite_pixels(cuda):
    data = _starfield(2, 128, 256, seed=8, stars=16, device=cuda)
    data[0, 20, 30] = float("nan")
    data[0, 60, 100] = float("inf")
    data[0, 61, 180] = -float("inf")
    data[1, 10:13, 40] = float("inf")
    data[1, 90, 200] = float("nan")
    for stats in (False, True):
        _check(data, threshold=25.0, max_stars=24, stats=stats)
    _check(data, threshold=float("nan"), max_stars=24, stats=False)


@pytest.mark.gpu
def test_equal_peaks_in_a_row_pair(cuda):
    """Equal peaks in rows 2k and 2k + 1 (the pair index orders them by
    column), and equal peaks across tiles and frames."""
    for h in (96, 97):
        data = torch.zeros((2, h, 400), device=cuda)
        for y, x in ((10, 300), (11, 20), (40, 130), (41, 120),
                     (70, 250), (70, 100), (71, 180)):
            data[:, y, x] = 100.0
        _check(data, threshold=1.0, max_stars=4, stats=False)
        _check(data, threshold=1.0, max_stars=16, stats=True)


@pytest.mark.gpu
def test_fewer_peaks_than_stars(cuda):
    data = _starfield(2, 128, 256, seed=2, stars=3, device=cuda)
    got = _check(data, threshold=50.0, max_stars=200, stats=True)
    assert 0 < int(got.valid.sum()) < 200
    _check(torch.zeros((2, 64, 64), device=cuda), threshold=0.0,
           max_stars=10, stats=False)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [5, 48, 1008, 2048])
def test_noise_at_no_threshold(cuda, k):
    """Pure noise with the threshold at -inf: ~450 peaks a tile, more
    than max_stars in every tile at 5 and 48 (the tile's rank trim), more
    candidates a frame than the merge caches (2048) at 48 and past."""
    g = torch.Generator(device=cuda).manual_seed(k)
    data = torch.randn((2, 256, 1024), generator=g, device=cuda)
    thr = torch.full((2,), -float("inf"), device=cuda)
    _check(data, threshold=thr, max_stars=k, stats=False)
