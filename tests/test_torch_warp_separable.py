"""The separable warp's kernel rules on the CPU (``ops/warp``,
``kernels``): the window bases from four corners against the twin's
full grid, the kernel's arithmetic restated in PyTorch against the twin
bit for bit, the route and tile-width rule against the shared memory a
block has, and the dispatch (CPU tensors take the twin, the launcher
refuses what the kernel does not take).  The kernel itself runs in
tests/test_torch_gpu.py."""

import math
import re

import numpy as np
import pytest
import torch

from astrophotography_tpu_torch import kernels
from astrophotography_tpu_torch.ops import warp as w
from astrophotography_tpu_torch.ops.register import REJECTED_TRANSLATION

# one intra-op thread: the suite runs in parallel worker processes, whose
# OpenMP threads would oversubscribe the cores (~6x slower under -n 6)
torch.set_num_threads(1)


def _similarities(n, seed, max_deg=17.0, far=True):
    """``n`` random similarity matrices: rotations to +-max_deg, scales
    within 0.5 %, translations to +-10 px; with ``far`` every 7th frame
    rejected (+1e9), every 11th at -1e9 and every 13th thousands of
    pixels off."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(rng.uniform(-max_deg, max_deg, n))
    sc = rng.uniform(0.995, 1.005, n)
    t = rng.uniform(-10.0, 10.0, (n, 2))
    if far:
        t[::7] = REJECTED_TRANSLATION
        t[3::11] = -1e9
        t[5::13] = rng.uniform(-6000.0, 6000.0, (len(t[5::13]), 2))
    c, s = sc * np.cos(th), sc * np.sin(th)
    mats = np.stack([np.stack([c, -s, t[:, 0]], 1),
                     np.stack([s, c, t[:, 1]], 1)], 1)
    return torch.from_numpy(mats.astype(np.float32))


def _twin_windows(mats, in_shape, out_shape, band, span, budget):
    """The twin's window bases and starts from its full grids
    (``_separable_chunk``'s expressions, every source band)."""
    h_in, w_in = in_shape
    h_out, w_out = out_shape
    band, pad, pad_t = w._separable_geometry(h_in, out_shape, band, span,
                                             budget)
    _a, _b, _c, m10, m11, m12, gx, gy, g0 = w._separable_coeffs(mats)
    xs = torch.arange(w_out, dtype=torch.float32)
    n_b2 = -(-h_out // band)
    rows2 = torch.arange(n_b2 * band, dtype=torch.float32).reshape(
        n_b2, band, 1)
    v = m10 * xs + m11 * rows2 + m12
    base2 = w._clipped_base(v, -pad_t, h_in + 3)
    start2 = w._slice_start(base2, pad_t, pad_t + h_in + band + span + 4,
                            band + span)
    n_b1 = -(-h_in // band)
    rows1 = torch.arange(n_b1 * band, dtype=torch.float32).reshape(
        n_b1, band, 1)
    u = gx * xs + gy * rows1 + g0
    base1 = w._clipped_base(u, -pad, w_in + 3)
    start1 = w._slice_start(base1, pad, w_in + 2 * pad, w_out + span)
    return (base2, start2), (base1, start1)


def _window_starts(matrices: torch.Tensor, in_shape, out_shape,
                   band: int = 64, span: int = 24,
                   translation_budget: "int | None" = None):
    """The separable warp kernel's windows, each from the four corners of
    its band (``band_window`` / ``row_window`` in csrc/warp_separable.cu).

    Each rounded operation of a*x + b*y + c is monotone in x and in y, so
    the float32 grid is monotone along each axis and its least value over
    a band's rows and the output width is the least of the four corners.
    Returns ((base2, start2), (base1, start1)), int64: the vertical
    window of each output band (N, ceil(H_out / band)) and the
    horizontal window of each source band (N, ceil(H_in / band)), equal
    to what ``warp_affine_separable_plain`` takes from its full grid
    (``_clipped_base`` / ``_slice_start``)."""
    mats = matrices.to(torch.float32).reshape(-1, 2, 3)
    h_in, w_in = in_shape
    h_out, w_out = out_shape
    band, pad, pad_t = w._separable_geometry(h_in, out_shape, band, span,
                                             translation_budget)
    _m00, _m01, _m02, m10, m11, m12, gx, gy, g0 = w._separable_coeffs(mats)
    dev = mats.device
    xs = torch.tensor([0.0, w_out - 1.0], dtype=torch.float32, device=dev)

    def corners(a, b, c, n_bands):
        first = torch.arange(n_bands, dtype=torch.float32, device=dev) * band
        rows = torch.stack([first, first + (band - 1)], dim=1)[..., None]
        return a * xs + b * rows + c            # (N, n_bands, 2, 2)

    base2 = w._clipped_base(corners(m10, m11, m12, -(-h_out // band)),
                            -pad_t, h_in + 3)
    start2 = w._slice_start(base2, pad_t, pad_t + h_in + band + span + 4,
                            band + span)
    base1 = w._clipped_base(corners(gx, gy, g0, -(-h_in // band)), -pad,
                            w_in + 3)
    start1 = w._slice_start(base1, pad, w_in + 2 * pad, w_out + span)
    return (base2, start2), (base1, start1)


#: (source shape, output shape, band, span, translation budget)
WINDOW_CASES = [
    ((64, 96), (64, 96), 64, 12, None),
    ((64, 96), (64, 96), 16, 24, None),
    ((64, 96), (80, 112), 16, 24, None),       # an ap_stack canvas
    ((50, 47), (50, 47), 16, 12, 40),
    ((96, 64), (48, 64), 8, 24, 64),           # a pipeline band
    ((33, 70), (33, 70), 64, 256, None),       # band cut to the height
]


@pytest.mark.parametrize("in_shape,out_shape,band,span,budget", WINDOW_CASES)
def test_four_corner_windows_equal_the_full_grid(in_shape, out_shape, band,
                                                 span, budget):
    mats = _similarities(300, seed=hash((in_shape, band, span)) % 2**32)
    got = _window_starts(mats, in_shape, out_shape, band, span, budget)
    want = _twin_windows(mats, in_shape, out_shape, band, span, budget)
    for (gb, gs), (wb, ws) in zip(got, want):
        assert torch.equal(gb, wb)
        assert torch.equal(gs, ws)


def _kernel_rule(imgs, mats, out_shape, band, span, analytic, budget):
    """The kernel's arithmetic (csrc/warp_separable.cu) restated in
    PyTorch: windows from four corners, each mid row of the source by its
    own source band's window, sums from -0 over every shift, rows and
    columns outside the source read as 0, coverage inline."""
    n, h_in, w_in = imgs.shape
    h_out, w_out = out_shape
    (b2, s2), (b1, s1) = _window_starts(
        mats, (h_in, w_in), out_shape, band, span, budget)
    band = min(band, h_in, h_out)
    m00, m01, m02, m10, m11, m12, gx, gy, g0 = (
        t.reshape(n, 1, 1) for t in w._separable_coeffs(mats))
    chans = 1 if analytic else 2
    xi = torch.arange(w_out)
    xs = xi.to(torch.float32)

    def resolved(acc, wsum):
        safe = wsum.abs() > 1e-3
        return torch.where(safe, acc / torch.where(safe, wsum, 1.0), 0.0)

    # pass 1: every source row y, its window of band y // band
    k = torch.arange(h_in) // band
    start1 = s1[:, k][..., None]
    ys = torch.arange(h_in, dtype=torch.float32)[:, None]
    coord = (gx * xs + gy * ys + g0) - b1[:, k][..., None].to(torch.float32)
    acc = [torch.full(coord.shape, -0.0) for _ in range(chans)]
    wsum = torch.full(coord.shape, -0.0)
    for s in range(span):
        wt = w.lanczos3_poly(coord - (xs + s))
        col = start1 + xi + s
        inb = (col >= 0) & (col < w_in)
        val = torch.where(inb, imgs.gather(2, col.clamp(0, w_in - 1)), 0.0)
        acc[0] = acc[0] + wt * val
        if chans == 2:
            acc[1] = acc[1] + wt * inb.to(torch.float32)
        wsum = wsum + wt
    mid = [resolved(a, wsum) for a in acc]

    # pass 2: output row y in band b, r = y - b * band
    yo = torch.arange(h_out)
    b = yo // band
    r = yo - b * band
    yf = yo.to(torch.float32)[:, None]
    start2 = s2[:, b][..., None]
    v = m10 * xs + m11 * yf + m12
    coord = v - b2[:, b][..., None].to(torch.float32)
    acc = [torch.full(coord.shape, -0.0) for _ in range(chans)]
    wsum = torch.full(coord.shape, -0.0)
    for s in range(span):
        wt = w.lanczos3_poly(coord - (r + s).to(torch.float32)[:, None])
        row = (start2 + (r + s)[:, None]).expand(n, h_out, w_out)
        inr = (row >= 0) & (row < h_in)
        for c in range(chans):
            val = torch.where(inr, mid[c].gather(1, row.clamp(0, h_in - 1)),
                              0.0)
            acc[c] = acc[c] + wt * val
        wsum = wsum + wt
    data = resolved(acc[0], wsum)
    if analytic:
        sx = m00 * xs + m01 * yf + m02
        cov = ((sx >= 2.0) & (sx <= w_in - 4.0) & (v >= 2.0)
               & (v <= h_in - 4.0))
        if budget is not None:
            b_eff = float(budget - span - 4)
            cov = cov & ((sx - xs).abs() <= b_eff) & ((v - yf).abs() <= b_eff)
        cover = cov.to(torch.float32)
        return data * cover, cover
    cover = resolved(acc[1], wsum)
    ok = cover > 1e-6
    return (torch.where(ok, data / torch.where(ok, cover, 1.0), 0.0),
            torch.clamp(cover, 0.0, 1.0))


def _same_bits(got, want):
    """Equal bit for bit, except that a NaN only has to be a NaN."""
    gn, wn = torch.isnan(got), torch.isnan(want)
    assert torch.equal(gn, wn)
    assert torch.equal(torch.where(gn, 0.0, got).view(torch.int32),
                       torch.where(wn, 0.0, want).view(torch.int32))


def _field(n, h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 800.0 + 0.3 * xx - 0.2 * yy + rng.normal(0, 8, (n, h, w))
    for f in range(n):
        for x0, y0 in rng.uniform(4, [w - 4, h - 4], (6, 2)):
            img[f] += 3e4 * np.exp(-0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2)
                                   / 1.6)
    img[:, ::9, ::7] *= -1.0          # negative values: signed products
    return torch.from_numpy(img.astype(np.float32))


#: (frames, source shape, output shape, band, span, analytic, budget,
#: degrees, what is planted in the source)
RULE_CASES = [
    (5, (40, 64), (40, 64), 16, 12, True, None, 0.5, None),
    (5, (40, 64), (40, 64), 16, 12, False, None, 3.0, None),
    (4, (37, 53), (37, 53), 8, 24, True, 40, 6.0, None),
    (4, (32, 48), (44, 64), 16, 24, True, None, 2.0, None),      # canvas
    (3, (25, 23), (25, 23), 64, 12, False, None, 15.0, None),    # odd
    (4, (40, 64), (40, 64), 16, 12, True, None, 1.0, "nonfinite"),
    (4, (40, 64), (40, 64), 16, 12, False, None, 1.0, "nonfinite"),
    (3, (24, 40), (24, 40), 8, 40, False, None, 10.0, None),
]


@pytest.mark.parametrize("n,in_shape,out_shape,band,span,analytic,budget,"
                         "deg,planted", RULE_CASES)
def test_kernel_rule_is_the_twin_bit_for_bit(n, in_shape, out_shape, band,
                                             span, analytic, budget, deg,
                                             planted):
    imgs = _field(n, *in_shape, seed=span + n)
    if planted:
        imgs[1, 10, 20] = torch.nan
        imgs[2, 12, 30] = torch.inf
        imgs[3, 30, 5] = -torch.inf
    mats = _similarities(n, seed=n * 31 + span, max_deg=deg, far=False)
    mats[-1, :, 2] = REJECTED_TRANSLATION
    if n > 3:
        mats[1, :, 2] = torch.tensor([-0.75, 1.5])
    got = _kernel_rule(imgs, mats, out_shape, band, span, analytic, budget)
    want = w.warp_affine_separable_plain(imgs, mats, out_shape, band=band,
                                         span=span,
                                         analytic_coverage=analytic,
                                         translation_budget=budget)
    for g, x in zip(got, want):
        _same_bits(g, x)
    if planted:
        assert torch.isnan(want[0]).any()


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("band", [64, 33, 16, 1])
def test_route_and_tile_rule(band, channels):
    """Every 'smem' tile fits a block's shared memory; the tile is the
    widest that leaves room for 4 blocks an SM, else the widest that fits;
    the route is 'smem' exactly up to _SEP_SMEM_MAX_SPAN where a tile
    fits, and switches to 'scratch' there."""
    cap = kernels._SMEM_MAX
    quarter = 233472 // kernels._SEP_BLOCKS_PER_SM
    last_smem = None
    for span in range(1, 4001):
        tw = kernels._warp_separable_tile(band, span, channels)
        sizes = {t: kernels._warp_separable_smem_bytes(band, span, channels,
                                                       t)
                 for t in kernels._SEP_TILE_COLS}
        fits = [t for t in kernels._SEP_TILE_COLS if sizes[t] <= cap]
        roomy = [t for t in fits if sizes[t] + 1024 <= quarter]
        assert tw == (roomy[0] if roomy else fits[0] if fits else 0)
        if tw:
            assert sizes[tw] <= cap == 232448
        route = kernels._warp_separable_route(band, span, channels)
        assert route == ("smem" if tw and span <= kernels._SEP_SMEM_MAX_SPAN
                         else "scratch")
        if route == "smem":
            assert last_smem in (None, span - 1)
            last_smem = span
    assert last_smem == kernels._SEP_SMEM_MAX_SPAN
    assert kernels._warp_separable_route(band, last_smem + 1,
                                         channels) == "scratch"


def test_the_cells_band_takes_one_smem_launch_of_128_columns():
    """The unfused cell's warp (span 12, analytic coverage, bands of 64
    rows) takes 'smem' with 128-column tiles, 4 blocks an SM; the
    default span 24 too; the warped ones channel halves the tile."""
    assert kernels._warp_separable_route(64, 12, 1) == "smem"
    assert kernels._warp_separable_tile(64, 12, 1) == 128
    assert kernels._warp_separable_tile(64, 24, 1) == 128
    assert kernels._warp_separable_tile(64, 12, 2) == 64
    assert kernels._warp_separable_smem_bytes(64, 12, 1, 128) == \
        4 * (76 * 128 + 2 * 76)


def test_smem_bytes_mirror_the_source():
    """``_warp_separable_smem_bytes`` is ``smem_words`` of the source,
    four bytes a word."""
    src = (kernels._SRC / kernels._SOURCES["warp_separable"]).read_text()
    body = re.search(r"smem_words\(int rows, int tw,\s*int chans\) \{\s*"
                     r"return ([^;]+);", src)
    assert body is not None
    assert " ".join(body.group(1).split()) == \
        "(size_t)chans * rows * tw + 2 * (size_t)rows"


@pytest.mark.parametrize("n,h,w_out", [(24, 4096, 4096), (1, 64, 96),
                                       (300, 8192, 8192)])
@pytest.mark.parametrize("channels", [1, 2])
def test_scratch_chunks_stay_within_a_gib(n, h, w_out, channels):
    chunk = kernels._warp_separable_chunk(n, channels, h, w_out)
    assert 1 <= chunk <= n
    per = 4 * channels * h * w_out
    assert chunk == 1 or chunk * per <= kernels._SEP_SCRATCH_MAX
    assert chunk == n or (chunk + 1) * per > kernels._SEP_SCRATCH_MAX


@pytest.mark.parametrize("analytic,budget", [(True, None), (False, None),
                                             (True, 40)])
def test_cpu_tensors_take_the_twin(monkeypatch, analytic, budget):
    """On the CPU the warp is the twin, bit for bit, single frame and
    batch, and nothing reaches the launcher or its counts."""
    def refuse(*a, **k):
        raise AssertionError("the CPU path reached the kernel launcher")

    monkeypatch.setattr(kernels, "warp_separable_cuda", refuse)
    before = dict(kernels.launch_counts), \
        dict(kernels.warp_separable_route_counts)
    imgs = _field(3, 40, 56, seed=7)
    mats = _similarities(3, seed=8, max_deg=2.0, far=False)
    kw = dict(span=12, analytic_coverage=analytic, translation_budget=budget)
    got = w.warp_affine_separable(imgs, mats, (40, 56), **kw)
    want = w.warp_affine_separable_plain(imgs, mats, (40, 56), **kw)
    one = w.warp_affine_separable(imgs[1], mats[1], (40, 56), **kw)
    for g, x in zip(got, want):
        _same_bits(g, x)
    for g, x in zip(one, want):
        _same_bits(g, x[1])
    assert kernels.launch_counts["warp_separable"] == 0
    assert (dict(kernels.launch_counts),
            dict(kernels.warp_separable_route_counts)) == before


def test_no_fallback_on_other_devices():
    """A tensor that is neither on the CPU nor on a card raises: the warp
    never runs the twin in the kernel's place."""
    imgs = torch.empty((2, 16, 16), device="meta")
    mats = torch.empty((2, 2, 3), device="meta")
    with pytest.raises(ValueError, match="no warp_separable kernel"):
        w.warp_affine_separable(imgs, mats, (16, 16), span=12)


def test_launcher_refuses_what_the_kernel_does_not_take():
    imgs = torch.zeros((2, 16, 16))
    mats = torch.zeros((2, 2, 3))
    args = ((16, 16), 16, 12, True, None, 32, 32)
    with pytest.raises(ValueError, match="no route"):
        kernels.warp_separable_cuda(imgs, mats, *args, route="cols")
    with pytest.raises(ValueError, match="does not fit"):
        kernels.warp_separable_cuda(imgs, mats, (16, 16), 64, 4000, False,
                                    None, 32, 32, route="smem")
    with pytest.raises(ValueError, match="at least 1 frame"):
        kernels.warp_separable_cuda(imgs[:0], mats[:0], *args)
    with pytest.raises(ValueError, match="float32"):
        kernels.warp_separable_cuda(imgs.to(torch.float64), mats, *args)


def test_translation_budget_is_checked_before_the_device():
    """The geometry the card's path resolves before its launch refuses a
    budget within span + 4, as the twin does."""
    with pytest.raises(ValueError, match="translation_budget"):
        w._separable_geometry(16, (16, 16), 64, 12, 16)
    with pytest.raises(ValueError, match="translation_budget"):
        w.warp_affine_separable(torch.zeros((1, 16, 16)),
                                torch.zeros((1, 2, 3)), (16, 16), span=12,
                                translation_budget=16)
    assert math.isfinite(kernels._SEP_SMEM_MAX_SPAN)
