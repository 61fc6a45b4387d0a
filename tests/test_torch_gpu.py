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


def _detect_check(fr, thr, fwhm=3.0, **args):
    """K1 against its twin at the tolerances of chip_smoke.check_detect:
    maxima rtol 1e-4 / atol 1e-2, equal argmax, offsets within 1e-4; one
    launch.  Returns the kernel's results."""
    before = kernels.launch_counts["detect_tiles"]
    got = dt.detect_tiles(fr, thr, fwhm=fwhm, **args)
    assert kernels.launch_counts["detect_tiles"] == before + 1
    want = dt.detect_tiles_plain(fr, thr, fwhm=fwhm, **args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-2)
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[3], want[3], rtol=0, atol=1e-4)
    return got


def _offsets_f64(fr, got_idx, fwhm, mf_bc=None, a_plane=None,
                 exp_ratios=None):
    """The twin's parabola offsets (y, x) at the tiles' winners
    ``got_idx``, evaluated in float64 from the same inputs."""
    from astrophotography_tpu_torch.ops.detect import fast_density

    n, h, w = fr.shape
    cal_y, cal_x = dt._paroff_calibration(fwhm)
    er = torch.ones(n, dtype=torch.float64, device=fr.device) \
        if exp_ratios is None else exp_ratios.double()
    tyn, txn = h // 64, w // 256
    out = torch.zeros((2, n, tyn, txn), dtype=torch.float64)

    def par(a, b, c, coef):
        den = float(a - 2 * b + c)
        e = min(max(0.5 * float(a - c) / den, -0.5), 0.5) \
            if abs(den) > 1e-12 else 0.0
        c1, c3, c5 = coef
        return min(max(e * (c1 + e * e * (c3 + e * e * c5)), -0.5), 0.5)

    for f in range(n):
        x = fr[f].double()
        if a_plane is not None:
            x = x * a_plane.double()
        d = fast_density(0.5 * (x[0::2] + x[1::2]), fwhm, row_sigma_scale=0.5,
                         dtype=torch.float64)
        if mf_bc is not None:
            d = d - (mf_bc[0].double() + er[f] * mf_bc[1].double())
        d = torch.nn.functional.pad(d, (1, 1, 1, 1)).cpu()
        idx = got_idx[f].cpu()
        for ty in range(tyn):
            for tx in range(txn):
                ly, lx = divmod(int(idx[ty, tx]), 256)
                y, xx = ty * 32 + ly + 1, tx * 256 + lx + 1
                out[0, f, ty, tx] = par(d[y - 1, xx], d[y, xx], d[y + 1, xx],
                                        cal_y)
                out[1, f, ty, tx] = par(d[y, xx - 1], d[y, xx], d[y, xx + 1],
                                        cal_x)
    return out


def _k1_rule(fr, thr, fwhm=3.0, **args):
    """K1 against its twin by chip_smoke._k1_agrees' rule: equal empty
    tiles, maxima within 1e-2 + 1e-4 |max|, argmax equal except on tiles
    whose two maxima tie within 1e-3 relative, offsets within 1e-4 bin;
    one launch.  An offset may differ by more (d) only on a tile where
    float32 cannot resolve it that finely: the twin's own offset lies at
    least d / 3 from its float64 value there (a flat peak, whose
    parabola offset magnifies the densities' rounding).  Returns the
    kernel's results and the twin's."""
    before = kernels.launch_counts["detect_tiles"]
    got = dt.detect_tiles(fr, thr, fwhm=fwhm, **args)
    assert kernels.launch_counts["detect_tiles"] == before + 1
    want = dt.detect_tiles_plain(fr, thr, fwhm=fwhm, **args)
    torch.cuda.synchronize()
    live = want[0] > -1e37
    assert torch.equal(got[0] > -1e37, live)
    err = (got[0] - want[0]).abs()
    assert bool((err[live] <= 1e-2 + 1e-4 * want[0][live].abs()).all())
    same = got[1] == want[1]
    tie = ~same & (err <= 1e-3 * want[0].abs().clamp(min=1.0))
    assert bool((same | tie).all())
    off = torch.stack([(got[2] - want[2]).abs(), (got[3] - want[3]).abs()])
    wide = (off > 1e-4) & same
    if bool(wide.any()):
        exact = _offsets_f64(fr, want[1], fwhm, **args).to(off.device)
        twin_err = (torch.stack([want[2], want[3]]).double() - exact).abs()
        assert bool((twin_err[wide] >= off[wide].double() / 3).all()), (
            off[wide], twin_err[wide])
    return got, want


def _detect_masters(n, h, w, dev, fwhm=3.0):
    rng = np.random.default_rng(1)
    bias = torch.from_numpy((250 + rng.normal(0, 2, (h, w)))
                            .astype(np.float32)).to(dev)
    dark = torch.full((h, w), 3.0, device=dev)
    flat = 1.0 + 0.1 * torch.sin(torch.arange(h, device=dev) * 0.7)[:, None] \
        * torch.ones((1, w), device=dev)
    return dict(mf_bc=dt.master_densities(bias, dark, flat, fwhm=fwhm),
                a_plane=1.0 / flat,
                exp_ratios=torch.full((n,), 2.0, device=dev))


def _long_strips(monkeypatch, strip_tiles=8):
    """Keep K1's strip at ``strip_tiles`` tiles however few blocks the
    small test frames give (the wrapper would shorten it to fill the
    card)."""
    monkeypatch.setattr(kernels, "_DET_FILL_BLOCKS", 0)
    monkeypatch.setattr(kernels, "_DET_MAX_STRIP_TILES", strip_tiles)


@pytest.mark.parametrize("long_strips", [False, True])
@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
@pytest.mark.parametrize("h,w", [(64, 512), (256, 256), (576, 512),
                                 (448, 1536)])
def test_detect_kernel_frame_shapes(cuda, monkeypatch, h, w, dtype,
                                    long_strips):
    """A single tile row (H = 64), a single tile column (W = 256), a
    height that the strip of 8 tiles does not divide (576 = 9 tiles) or
    that a strip of 3 does not (448 = 7 tiles), blocks of 1 and 2 tile
    columns; uint16 and float32 frames."""
    if long_strips:
        _long_strips(monkeypatch, 3 if h == 448 else 8)
        lay = kernels._detect_layout(2, h, w)
        assert lay["strip_tiles"] == min(3 if h == 448 else 8, h // 64)
        assert h != 576 or lay["segments"] == 2
    n = 2
    fr = torch.from_numpy(_starfield(n, h, w, 7)).to(cuda)
    if dtype == torch.float32:
        fr = fr.to(torch.float32)
    got = _detect_check(fr, torch.full((n,), 60.0, device=cuda),
                        **_detect_masters(n, h, w, cuda))
    assert int((got[0] > -1e37).sum()) >= 4


@pytest.mark.parametrize("with_mf", [False, True])
@pytest.mark.parametrize("with_a", [False, True])
def test_detect_kernel_optional_planes(cuda, with_a, with_mf):
    n, h, w = 2, 128, 512
    fr = torch.from_numpy(_starfield(n, h, w, 8)).to(cuda)
    args = _detect_masters(n, h, w, cuda)
    if not with_a:
        args["a_plane"] = None
    if not with_mf:
        args["mf_bc"] = None
    _detect_check(fr, torch.full((n,), 60.0, device=cuda), **args)


def _placed_stars(h, w, centres, amp=20000.0, background=500.0):
    """One float32 frame: a constant background plus Gaussian stars
    (sigma^2 = 1.6) at the given (y, x) centres, no noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.full((h, w), background)
    for y0, x0 in centres:
        img += amp * np.exp(-0.5 * ((xx - x0) ** 2 + (yy - y0) ** 2) / 1.6)
    return img.astype(np.float32)


@pytest.mark.parametrize("strip_tiles", [1, 2, 8])
def test_detect_kernel_boundary_stars(cuda, monkeypatch, strip_tiles):
    """Stars on a tile corner (raw row 64, column 256), on a strip corner
    (raw rows 128 and 256 = the ends of 2-tile strips, column 1024 = the
    end of a 2-tile-column block), on either side of them, and inside the border
    mask (never reported): every one lands in the right tile with its
    cross neighbours taken across the boundary."""
    _long_strips(monkeypatch, strip_tiles)
    h, w = 512, 2048
    centres = [(64, 256), (63, 700), (128, 1024), (255, 1023), (129.4, 1500.3),
               (192, 1279), (300, 1024), (255.3, 511.6), (1, 40), (2, 2),
               (510, 2044), (400, 3), (320, 2045)]
    fr = torch.from_numpy(_placed_stars(h, w, centres))[None].to(cuda)
    got = _detect_check(fr, torch.full((1,), 60.0, device=cuda))
    live = got[0][0] > -1e37
    # the tile whose first pixel is the star at (64, 256): binned row 32
    assert bool(live[1, 1]) and int(got[1][0, 1, 1]) == 0
    assert bool(live[2, 4]) and int(got[1][0, 2, 4]) == 0
    # and the one whose last pixel is the star at (255, 1023)
    assert bool(live[3, 3]) and int(got[1][0, 3, 3]) == 32 * 256 - 1
    assert int(live.sum()) == 8          # the 5 stars in the border: none


def test_detect_kernel_equal_peaks_lowest_index(cuda):
    """Identical stars on a constant background give bit-equal peaks; the
    tile reports the one with the lowest row-major index."""
    h, w = 128, 512
    centres = [(20, 140), (20, 40),                  # tile (0, 0)
               (104, 300), (84, 300), (84, 420)]     # tile (1, 1)
    fr = torch.from_numpy(_placed_stars(h, w, centres))[None].to(cuda)
    got = _detect_check(fr, torch.full((1,), 60.0, device=cuda))
    assert int(got[1][0, 0, 0]) == 10 * 256 + 40
    assert int(got[1][0, 1, 1]) == 10 * 256 + (300 - 256)
    assert float(got[0][0, 0, 0]) == float(got[0][0, 1, 1])


def test_detect_kernel_flat_plateau(cuda):
    """A constant frame under a negative threshold: every interior
    density is equal, so the raster tie-break (strict against earlier
    neighbours) decides every peak, as in the twin."""
    fr = torch.full((2, 192, 512), 1000, dtype=torch.uint16, device=cuda)
    fr[1] = 3000
    _detect_check(fr, torch.full((2,), -1.0, device=cuda))


def _fwhm_for(r, monkeypatch):
    """A FWHM whose filter radius is ``r``: round(0.75 FWHM) for r >= 2
    (4, 5 and 8 px for radii 3, 4 and 6, as this file used before);
    radius 1, which no FWHM reaches (the radius is at least 2) but the
    kernel takes, by patching the radius of one FWHM that nothing else
    uses (``clear_k1_caches`` drops its cached taps and calibration)."""
    if r >= 2:
        return {3: 4.0, 4: 5.0, 6: 8.0}.get(r, r / 0.75)
    from astrophotography_tpu_torch.ops import detect as tdetect

    fwhm, orig = 1.3, tdetect._kernel_radius
    for mod in (tdetect, dt):
        monkeypatch.setattr(mod, "_kernel_radius",
                            lambda f: 1 if f == fwhm else orig(f))
    return fwhm


@pytest.fixture
def clear_k1_caches():
    """K1's cached taps and calibration dropped before and after a test
    that may patch a FWHM's radius."""
    dt._kernel_params.cache_clear()
    dt._paroff_calibration.cache_clear()
    yield
    dt._kernel_params.cache_clear()
    dt._paroff_calibration.cache_clear()


@pytest.mark.parametrize("geometry", ["256x512", "448x1536 strips of 3"])
@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
@pytest.mark.parametrize("r", list(range(1, 17)))
def test_detect_kernel_other_fwhm(cuda, monkeypatch, clear_k1_caches, r,
                                  dtype, masters, geometry):
    """Every radius below the separable route's: 2 and 3 take the rolling
    kernel's instances, 1 and 4-16 the ring kernel's; uint16 and float32
    frames, with and without masters; on 256 x 512 and on 448 x 1536 with
    strips of 3 tiles (3 strips of 2 tile columns, 3 segments: odd
    counts, the last segment one tile).  Held by :func:`_k1_rule`; the
    three cases the test had before (radii 3, 4 and 6, uint16 with
    masters on 256 x 512) keep the exact argmax of
    :func:`_detect_check`.  The ring kernel's maxima and argmax are the
    twin's bits."""
    fwhm = _fwhm_for(r, monkeypatch)
    assert dt._kernel_params(fwhm)[1] == r
    assert kernels._detect_route(r) == (
        "rolling" if r in (2, 3) else "ring")
    h, w = (256, 512) if geometry == "256x512" else (448, 1536)
    if h == 448:
        _long_strips(monkeypatch, 3)
        lay = kernels._detect_layout(2, h, w, r)
        assert (lay["strip_tiles"], lay["segments"]) == (3, 3)
        assert (w // 256) // lay["tile_cols"] == 3
    n = 2
    fr = torch.from_numpy(_starfield(n, h, w, 9)).to(cuda)
    if dtype == torch.float32:
        fr = fr.to(torch.float32)
    args = _detect_masters(n, h, w, cuda, fwhm=fwhm) if masters else {}
    thr = torch.full((n,), 60.0, device=cuda)
    if (h, dtype, masters) == (256, torch.uint16, True) and r in (3, 4, 6):
        # the cases this test held before the ring route: exact argmax
        got = _detect_check(fr, thr, fwhm=fwhm, **args)
        want = dt.detect_tiles_plain(fr, thr, fwhm=fwhm, **args)
    else:
        got, want = _k1_rule(fr, thr, fwhm=fwhm, **args)
    if r not in (2, 3):
        # the ring kernel rounds op by op as the twin does
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
    assert int((got[0] > -1e37).sum()) >= 4


@pytest.mark.parametrize("geometry", ["512x1024", "448x1536 strips of 3"])
@pytest.mark.parametrize("masters", [False, True])
@pytest.mark.parametrize("dtype", [torch.uint16, torch.float32])
@pytest.mark.parametrize("fwhm,r", [(22.7, 17), (32.0, 24), (64.0, 48)])
@pytest.mark.parametrize("chunked", [False, True])
def test_detect_kernel_separable_route(cuda, monkeypatch, fwhm, r, chunked,
                                       dtype, masters, geometry):
    """Radii past 16 (FWHM above ~22 px) take the separable route: the
    column pass into G and Box planes in device memory, then the planes
    kernel's strip walk with the row pass and peak test on them; with
    ``chunked`` the planes hold one frame at a time (three chunks).  It
    rounds op by op as the twin does, so its maxima are the twin's
    bits."""
    assert dt._kernel_params(fwhm)[1] == r
    assert kernels._detect_route(r) == "separable"
    n = 3
    h, w = (512, 1024) if geometry == "512x1024" else (448, 1536)
    if h == 448:
        _long_strips(monkeypatch, 3)
        lay = kernels._detect_layout(kernels._detect_chunk(n, h, w), h, w, r)
        assert (lay["strip_tiles"], lay["segments"]) == (3, 3)
    if chunked:
        monkeypatch.setattr(kernels, "_DET_SCRATCH_MAX", 8 * (h // 2) * w)
    assert kernels._detect_chunk(n, h, w) == (1 if chunked else n)
    fr = torch.from_numpy(_starfield(n, h, w, 9)).to(cuda)
    if dtype == torch.float32:
        fr = fr.to(torch.float32)
    args = _detect_masters(n, h, w, cuda, fwhm=fwhm) if masters else {}
    got = _detect_check(fr, torch.full((n,), 2.0, device=cuda), fwhm=fwhm,
                        **args)
    want = dt.detect_tiles_plain(fr, torch.full((n,), 2.0, device=cuda),
                                 fwhm=fwhm, **args)
    assert torch.equal(got[0], want[0])
    assert bool((got[0] > -1e37).any())


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
    """Frame counts where a shared block would have lost rows (7 rows at
    240 frames, 1 at 908) take the 'cols' route with all 8: uint16 with
    masters and float32 without, snapped translations."""
    assert kernels._warp_route(n, 12) == "cols"
    assert kernels._warp_smem_rows(n, 12) < 8
    assert kernels._warp_block_rows(n, 12) == 8
    h, w = 64, 256
    frames = torch.from_numpy(_starfield(n, h, w, 4)).to(cuda)
    masters = _warp_masters(h, w, cuda)
    if dtype == torch.float32:       # pre-calibrated input, no masters
        frames, masters = frames.to(torch.float32) * 1.02 - 300.0, None
    _warp_check(frames, _warp_mats(n, 5, rotate=False), masters,
                combine=combine)


def _many_frames(n, h, w, seed):
    """``n`` uint16 starfields: four distinct fields in turn, each frame
    with its own noise."""
    base = _starfield(4, h, w, seed).astype(np.float32)
    rng = np.random.default_rng(seed)
    out = base[np.arange(n) % 4] + rng.normal(0, 4, (n, h, w))
    return np.clip(out, 0, 65535).astype(np.uint16)


#: K2's cases on either side of the 'cols' crossing and at 1200 frames:
#: (frames, combine, body); the bodies are the snapped translation
#: ('snap'), 'exact' and 'lowrank' taps on rotated frames
_C = next(n for n in range(1, 1000) if kernels._warp_route(n, 12) == "cols")
WARP_COLS_CASES = [
    (_C - 1, "median", "snap"), (_C - 1, "sum", "exact"),
    (_C - 1, "average", "lowrank"), (_C, "average", "snap"),
    (_C, "median", "exact"), (_C, "sum", "lowrank"),
    (_C + 1, "sum", "snap"), (_C + 1, "average", "exact"),
    (_C + 1, "median", "lowrank"), (1200, "average", "snap"),
    (1200, "median", "snap"), (1200, "sum", "snap"), (1200, "mean", "snap"),
    (1200, "median", "exact"), (1200, "average", "lowrank")]


def _warp_body(n, seed, body):
    return dict(mats=_warp_mats(n, seed, rotate=body != "snap"),
                general_taps="lowrank" if body == "lowrank" else "exact")


@pytest.mark.parametrize("n,combine,body", WARP_COLS_CASES)
def test_warp_combine_kernel_cols_route(cuda, n, combine, body):
    """From the crossing on (150 frames, the route sweep's)
    K2 takes its 'cols' route: the samples cross
    device memory once each way (a scratch of an N-sample column per
    pixel of each resident block) and each warp sorts one pixel's column
    on chip; bit-identical to the twin on every body and combine, and
    below the crossing the 'smem' route is."""
    route = "cols" if n >= _C else "smem"
    assert kernels._warp_route(n, 12) == route
    h, w = 64, 256
    frames = torch.from_numpy(_many_frames(n, h, w, 4)).to(cuda)
    kw = _warp_body(n, 5, body)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _warp_check(frames, kw.pop("mats"), _warp_masters(h, w, cuda),
                combine=combine, **kw)
    if route == "cols":
        # the grid is no larger than the 2 x 8 x 4 blocks of the image
        run = kernels._warp_cols_run(8, 12)
        key = ("warp_combine", "cols", cuda.index or 0, 1, min(n, run), 12,
               8, run)
        blocks = min(2 * 8 * 4, kernels._resident[key])
        assert torch.cuda.max_memory_allocated() - base >= \
            kernels._warp_scratch_bytes(n, 8, blocks)


@pytest.mark.parametrize("combine", ["average", "median", "sum"])
@pytest.mark.parametrize("body", ["snap", "exact", "lowrank"])
def test_warp_combine_kernel_cols_past_the_reach(cuda, monkeypatch, combine,
                                                body):
    """Past the reach of 'cols' (the samples a warp sorts on chip at
    once) a column is sorted in runs written back to the scratch, its
    ranks are bisected over the runs and the kept samples summed in
    ascending chunks: bit-identical to the twin.  The reach (7232 frames
    at 8 rows) is lowered to 96 so that 300 frames make 4 runs."""
    monkeypatch.setattr(kernels, "_warp_cols_run", lambda rows, span: 96)
    n, h, w = 300, 64, 256
    frames = torch.from_numpy(_many_frames(n, h, w, 8)).to(cuda)
    kw = _warp_body(n, 9, body)
    _warp_check(frames, kw.pop("mats"), _warp_masters(h, w, cuda),
                combine=combine, sigma_lower=2.0, sigma_upper=2.5, **kw)


def test_warp_combine_kernel_wide_window_takes_the_cols_route(cuda):
    """Below the crossing, a window whose one-row block leaves the
    N-sample columns no room in shared memory (100 frames at span 190)
    takes the 'cols' route as well, bit-identical to the twin."""
    n, span, h, w = 100, 190, 224, 256
    assert kernels._warp_smem_rows(n, span) == 0
    assert kernels._warp_route(n, span) == "cols"
    frames = torch.from_numpy(_many_frames(n, h, w, 6)).to(cuda)
    _warp_check(frames, _warp_mats(n, 7, rotate=False),
                _warp_masters(h, w, cuda), tile=(192, 256), span=span)


def _field_rotation(n, h, w, seed, degrees=(5.0, 15.0)):
    """Frame 0 identity, frame 2 a pure translation (both snapped), the
    rest rotated by 5-15 degrees about the frame's centre (an alt-az
    mount's field rotation over an hour or two) and shifted by up to
    3 px: the 'exact' body at spans past 192."""
    rng = np.random.default_rng(seed)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    mats = []
    for f in range(n):
        th = 0.0 if f in (0, 2) else \
            np.deg2rad(rng.choice([-1, 1]) * rng.uniform(*degrees))
        tx, ty = (0.0, 0.0) if f == 0 else rng.uniform(-3, 3, 2)
        c, s = np.cos(th), np.sin(th)
        mats.append([[c, -s, cx - c * cx + s * cy + tx],
                     [s, c, cy - s * cx - c * cy + ty]])
    return np.asarray(mats, np.float32)


def _wide_case(n, body, span, seed, uint16=True, h=None, w=384):
    """Frames, matrices, masters and tap body of a 'wide' route case: a
    tile one row taller than the span (the window the route exists for),
    two tile rows; snapped translations, 5-15 degree field rotations on
    'exact', 0.002-0.004 rad on 'lowrank' (whose gate admits no more)."""
    th = span + 8
    h = h or th + 56
    frames = torch.from_numpy(_many_frames(n, h, w, seed))
    mats = (_warp_mats(n, seed + 1, rotate=body == "lowrank")
            if body != "exact" else _field_rotation(n, h, w, seed + 1))
    masters = _warp_masters(h, w, "cpu")
    if not uint16:                   # pre-calibrated input, no masters
        frames, masters = frames.to(torch.float32) * 1.02 - 300.0, None
    return frames, mats, masters, dict(
        tile=(th, 128), span=span, dither_budget=128,
        general_taps="lowrank" if body == "lowrank" else "exact")


def _on(dev, frames, masters):
    return frames.to(dev), None if masters is None else masters.to(dev)


@pytest.mark.parametrize("span", [193, 256])
@pytest.mark.parametrize("uint16", [True, False])
@pytest.mark.parametrize("body", ["snap", "exact", "lowrank"])
def test_warp_combine_kernel_wide_route(cuda, body, uint16, span):
    """Past span 192 one output row's window outgrows a shared block, and
    K2 takes its 'wide' route: the mid rows in shared memory, filled a
    window row per warp, the samples in the 'cols' scratch.  Bit for bit
    against the twin on every tap body, uint16 with masters and float32
    without, one launch on that route."""
    frames, mats, masters, kw = _wide_case(6, body, span, 3, uint16)
    assert kernels._warp_route(6, span) == "wide"
    frames, masters = _on(cuda, frames, masters)
    before = kernels.warp_route_counts["wide"]
    _warp_check(frames, mats, masters, combine="median", **kw)
    assert kernels.warp_route_counts["wide"] == before + 1


@pytest.mark.parametrize("combine", ["average", "sum", "mean"])
@pytest.mark.parametrize("body", ["snap", "exact", "lowrank"])
def test_warp_combine_kernel_wide_route_combines(cuda, body, combine):
    """The 'wide' route's other combines, span 200, bit for bit."""
    frames, mats, masters, kw = _wide_case(5, body, 200, 11)
    frames, masters = _on(cuda, frames, masters)
    _warp_check(frames, mats, masters, combine=combine, **kw)


@pytest.mark.parametrize("body", ["snap", "exact"])
def test_warp_combine_kernel_wide_route_many_frames(cuda, body):
    """Past the 'cols' crossing (160 frames) the 'wide' route's combine
    is the 'cols' route's: bit for bit at span 193."""
    frames, mats, masters, kw = _wide_case(160, body, 193, 5, h=208,
                                           w=256)
    frames, masters = _on(cuda, frames, masters)
    _warp_check(frames, mats, masters, combine="average", **kw)


@pytest.mark.parametrize("span", [1411, 1436])
def test_warp_combine_kernel_wide_route_at_its_limit(cuda, span):
    """At 1411 a 'wide' block still keeps 32 rows, at 1436 (the route's
    reach) 8; both bit for bit on the 'exact' body."""
    frames, mats, masters, kw = _wide_case(3, "exact", span, 7, h=None,
                                           w=256)
    assert kernels._warp_block_rows(3, span) == (32 if span == 1411 else 8)
    frames, masters = _on(cuda, frames, masters)
    _warp_check(frames, mats, masters, **kw)


#: the 'wide' route's frame counts and spans, with the combines each
#: case checks (the twin's cost grows with the frames and the image):
#: each thread's register combine (24, the wide pipeline's count; 32, its
#: largest), its shared column (33, 112), the 'cols' combine past it
#: (113; 160 and 600 below); spans 193, 256 and 1436 (the reach, 8 rows a
#: block); 3 blocks an SM at 24 frames, 2 at 112
_ALL = ("average", "median", "sum", "mean")
WIDE_CASES = [(24, 193, _ALL), (24, 256, _ALL), (24, 1436, ("median", "mean")),
              (32, 256, ("average", "median")), (33, 256, ("average", "sum")),
              (112, 193, ("average",)), (113, 256, ("median",))]


@pytest.mark.parametrize("n,span,combines", WIDE_CASES)
@pytest.mark.parametrize("uint16", [True, False])
@pytest.mark.parametrize("body", ["snap", "exact", "lowrank"])
def test_warp_combine_kernel_wide_route_frames(cuda, body, uint16, n, span,
                                               combines):
    """The 'wide' route at every frame count its combine distinguishes,
    on each tap body, uint16 with masters and float32 without: bit for
    bit against the twin, one launch each on 'wide'."""
    assert kernels._warp_route(n, span) == "wide"
    frames, mats, masters, kw = _wide_case(
        n, body, span, n + span, uint16,
        w=256 if n <= 32 and span < 1000 else 128)
    frames, masters = _on(cuda, frames, masters)
    for combine in combines:
        before = kernels.warp_route_counts["wide"]
        _warp_check(frames, mats, masters, combine=combine, **kw)
        assert kernels.warp_route_counts["wide"] == before + 1


def test_warp_combine_kernel_wide_route_600_frames(cuda):
    """600 frames (an alt-az night's deep stack) at span 193: the 'cols'
    combine under 3 blocks an SM, bit for bit."""
    n, span = 600, 193
    frames, mats, masters, kw = _wide_case(n, "snap", span, 17, h=208, w=128)
    assert kernels._warp_route(n, span) == "wide"
    assert kernels._warp_wide_min_blocks(
        n, 32, span, kernels._warp_cols_run(8, span)) == 3
    frames, masters = _on(cuda, frames, masters)
    _warp_check(frames, mats, masters, combine="average", **kw)


@pytest.mark.parametrize("body", ["snap", "exact", "lowrank"])
def test_warp_combine_kernel_wide_route_equals_smem(cuda, body):
    """Forced onto a span the shared route takes (12), the 'wide' route
    gives the 'smem' and 'cols' routes' image bit for bit."""
    n, h, w = 6, 128, 256
    raw = torch.from_numpy(_starfield(n, h, w, 3)).to(cuda)
    mats = torch.tensor(_warp_mats(n, 2, rotate=body != "snap"), device=cuda)
    plan = wc.plan_warp_combine(
        raw.shape, mats, torch.full((n,), 0.5, device=cuda), tile=(32, 128),
        general_taps="lowrank" if body == "lowrank" else "exact")
    imgs = {r: kernels.warp_combine_cuda(raw, _warp_masters(h, w, cuda), plan,
                                         1, body == "lowrank", 5.0, 5.0,
                                         route=r)
            for r in ("smem", "cols", "wide")}
    assert torch.equal(imgs["wide"], imgs["smem"])
    assert torch.equal(imgs["wide"], imgs["cols"])
    assert (imgs["wide"] != 0).float().mean() > 0.8


@pytest.mark.parametrize("taps", ["exact", "lowrank"])
def test_warp_combine_kernel_wide_route_bounds_and_geom(cuda, taps):
    """The 'wide' route reads ``v_bounds`` (inside the image) and
    ``snap_geom`` (an interior band's) from the frame table as the twin
    does, span 200."""
    body = "exact" if taps == "exact" else "lowrank"
    frames, mats, masters, kw = _wide_case(5, body, 200, 13)
    frames, masters = _on(cuda, frames, masters)
    h, w = frames.shape[1:]
    _warp_check(frames, mats, masters,
                v_bounds=torch.tensor((10.0, h - 12.0), device=cuda),
                snap_geom=torch.tensor((w / 2, -70.0, w / 2, h / 2),
                                       device=cuda), **kw)


@pytest.mark.parametrize("taps", ["exact", "lowrank"])
@pytest.mark.parametrize("v_bounds,snap_geom", [
    ((20.0, 100.5), (60.0, 30.0, 4.0, 4.0)),       # every frame snaps
    ((-40.0, 300.0), (127.5, -70.0, 127.5, 63.5)),  # an interior band's
])
def test_warp_combine_kernel_bounds_and_geom(cuda, taps, v_bounds, snap_geom):
    """K2 with ``v_bounds`` and ``snap_geom`` set reads the row bounds
    from its table as its twin does: bit for bit; bounds inside the image
    cut rows the default keeps."""
    n, h, w = 6, 128, 256
    raw = torch.from_numpy(_starfield(n, h, w, 3)).to(cuda)
    mats = torch.tensor(_warp_mats(n, 2), device=cuda)
    kw = dict(masters=_warp_masters(h, w, cuda), tile=(32, 128),
              general_taps=taps,
              exp_ratios=torch.full((n,), 0.5, device=cuda))
    geo = dict(v_bounds=torch.tensor(v_bounds, device=cuda),
               snap_geom=torch.tensor(snap_geom, device=cuda))
    before = kernels.launch_counts["warp_combine"]
    got = wc.warp_combine(raw, mats, **kw, **geo)
    assert kernels.launch_counts["warp_combine"] == before + 1
    assert torch.equal(got, wc.warp_combine_plain(raw, mats, **kw, **geo))
    full = wc.warp_combine(raw, mats, **kw)
    if v_bounds[0] > 2.0:
        assert (got != 0).sum() < (full != 0).sum()
        assert (got[40:90] != 0).float().mean() > 0.8
    else:
        # wider bounds than the image's keep every row the default keeps
        assert bool(((got != 0) | (full == 0)).all())


@pytest.mark.parametrize("rotate,taps", [(False, "exact"), (True, "exact"),
                                         (True, "lowrank")])
def test_banded_warp_combine_matches_whole_frame(cuda, rotate, taps):
    """The band loop launches K2 once per band.  Translations that are
    multiples of 1/64 px give the whole-frame result bit for bit;
    rotations follow the clip-tie rule (equal zero masks, median |diff|
    < 1e-3, beyond 0.5 + 1e-4 |ref| on under 1e-4 of the pixels)."""
    from astrophotography_tpu_torch.parallel import banded_warp_combine

    n, h, w = 6, 512, 256
    raw = torch.from_numpy(_starfield(n, h, w, 3)).to(cuda)
    mats = _warp_mats(n, 2, rotate=rotate)
    mats[:, :, 2] = np.round(mats[:, :, 2] * 64) / 64
    mats = torch.tensor(mats, device=cuda)
    kw = dict(masters=_warp_masters(h, w, cuda), tile=(32, 128),
              general_taps=taps,
              exp_ratios=torch.full((n,), 0.5, device=cuda))
    whole = wc.warp_combine(raw, mats, **kw)
    before = kernels.launch_counts["warp_combine"]
    banded = banded_warp_combine(raw, mats, 4, halo=32, **kw)
    assert kernels.launch_counts["warp_combine"] == before + 4
    assert torch.equal(banded == 0, whole == 0)
    if not rotate:
        assert torch.equal(banded, whole)
        return
    both = (banded != 0) & (whole != 0)
    err = (banded - whole).abs()[both]
    assert float(err.median()) < 1e-3
    assert float((err > 0.5 + 1e-4 * whole[both].abs()).float().mean()) < 1e-4


def _ranks_on_cards(transport: str, world: int) -> None:
    """Skip an NCCL case where the ranks cannot each have a card (NCCL
    refuses two ranks on one GPU)."""
    if transport == "nccl" and torch.cuda.device_count() < world:
        pytest.skip(f"NCCL needs {world} cards, one a rank; "
                    f"{torch.cuda.device_count()} found")


@pytest.mark.parametrize("transport", ["gloo", "nccl"])
@pytest.mark.parametrize("rotate,taps", [(False, "exact"), (True, "lowrank")])
def test_sharded_warp_combine_on_the_card_is_the_band_loop(cuda, rotate,
                                                           taps, transport):
    """2 ranks at 16x1024^2 (gloo: both on the first card, the halo
    staged through pinned host buffers; NCCL: a card each): each
    launches K2 once, and the gathered stack equals the 2-band loop with
    the same halo bit for bit."""
    from astrophotography_tpu_torch.parallel import banded_warp_combine
    from astrophotography_tpu_torch.parallel.launch import spawn
    # as a top-level module (pytest puts tests/ on the path): where a
    # package named 'tests' is installed, 'tests.' resolves there
    from torch_parallel_ranks import card_k2_rank

    _ranks_on_cards(transport, 2)
    n, h, w = 16, 1024, 1024
    rng = np.random.default_rng(7)
    field = _starfield(1, h, w, 7)[0].astype(np.float32)
    raw = np.clip(np.stack([np.roll(field, (f % 5, -(f % 3)), (0, 1))
                            + rng.normal(0, 3, (h, w)) for f in range(n)]),
                  0, 65535).astype(np.uint16)
    case = {"frames": torch.from_numpy(raw),
            "matrices": torch.from_numpy(_warp_mats(n, 4, rotate=rotate)),
            "masters": _warp_masters(h, w, "cpu"),
            "exp_ratios": torch.linspace(0.5, 1.5, n), "halo": 64,
            "kw": dict(tile=(64, 256), general_taps=taps)}
    ranks = spawn(card_k2_rank, 2, device="cuda", transport=transport,
                  args=(case,))
    want = banded_warp_combine(
        case["frames"].to(cuda), case["matrices"].to(cuda), 2,
        masters=case["masters"].to(cuda),
        exp_ratios=case["exp_ratios"].to(cuda), halo=64, **case["kw"]).cpu()
    assert (want != 0).float().mean() > 0.9
    for res in ranks:
        assert res["transport"] == transport
        assert res["launches"]["warp_combine"] == 1
        assert torch.equal(res["stack"], want)


@pytest.mark.parametrize("center", ["mean", "median"])
def test_noise_stats_do_not_depend_on_the_batch(cuda, center):
    """The noise statistics of 24 frames of 4096 columns on the card, at
    once and as 12 + 12 (a frame shard's): bit for bit, so every frame
    shard of a mesh gets the one-device thresholds, with either noise
    centre.  A reduction call over the rows would not give that: its
    block shape follows the number of rows."""
    from astrophotography_tpu_torch.models.pipeline import frame_noise_stats

    g = torch.Generator(device=cuda).manual_seed(3)
    frames = 800.0 + 8.0 * torch.randn((24, 1024, 4096), generator=g,
                                       device=cuda)
    frames[:, ::97, ::89] += 30000.0
    whole = frame_noise_stats(frames, center)
    halves = [frame_noise_stats(h, center)
              for h in (frames[:12], frames[12:])]
    for k in range(2):
        assert torch.equal(whole[k], torch.cat([h[k] for h in halves]))


def test_dryrun_multichip_over_nccl(cuda, capsys):
    """The dry run's twin on 4 ranks with a card each takes NCCL, prints
    its OK line and launches K2 twice on every rank (sharded fused, lean
    sharded)."""
    from astrophotography_tpu_torch.graft_entry import dryrun_multichip

    _ranks_on_cards("nccl", 4)
    ranks = dryrun_multichip(4, size=512)
    out = capsys.readouterr().out
    assert "dryrun_multichip: 4 ranks on cuda, transport nccl" in out
    assert "dryrun_multichip OK: mesh {'frame': 2, 'space': 2}" in out
    for res in ranks:
        assert res["transport"] == "nccl" and res["finite"]
        assert res["launches"]["warp_combine"] == 2


@pytest.mark.parametrize("rotate", [False, True])
def test_kernels_on_calibrated_padded_stack(cuda, rotate):
    """The file-to-file path's inputs at a shape no tile divides (8 x 168
    x 1000: K2's plan pads rows and columns): K2 on a calibrated float32
    stack without masters, with the apron and the plan's own tile, as
    ``models.pipeline.stack_registered`` calls it (snapped translations,
    or rotations through the 'exact' tap body); K3 on the warped band
    ``combine_band`` hands it.  Both bit for bit against their twins."""
    from astrophotography_tpu_torch.models import PipelineConfig
    from astrophotography_tpu_torch.models import pipeline as pl

    n, h, w = 8, 168, 1000
    cal = torch.from_numpy(_starfield(n, h, w, 6)).to(cuda) \
        .to(torch.float32) * 1.02 - 300.0
    mats = _warp_mats(n, 7, rotate=rotate)
    _warp_check(cal, mats, None, apron=True, general_taps="exact")
    mats = torch.tensor(mats, device=cuda)
    warped, weights = pl.warp_band(cal, mats, h, PipelineConfig())
    mask = weights > 0.5
    before = kernels.launch_counts["clip_combine"]
    got = cc.clip_combine(warped, mask)
    assert kernels.launch_counts["clip_combine"] == before + 1
    want = cc.clip_combine_plain(warped, mask)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert float(torch.isnan(got).float().mean()) < 0.2


def _clip_stack(n, h, w, seed):
    """Normal samples with outliers, ~20% masked samples, a fully masked
    pixel, pixels with exactly 1 and 2 valid samples, and a masked +inf
    and a masked NaN sample."""
    rng = np.random.default_rng(seed)
    stack = rng.normal(800.0, 8.0, (n, h, w)).astype(np.float32)
    stack[rng.uniform(size=stack.shape) < 0.02] = 40000.0
    mask = rng.uniform(size=stack.shape) > 0.2
    mask[:, 3, 5] = False
    mask[:, 4, 5] = False
    mask[n // 2, 4, 5] = True
    mask[:, 5, 5] = False
    mask[[0, n - 1], 5, 5] = True
    stack[0, 6, 6], mask[0, 6, 6] = np.inf, False
    stack[n - 1, 7, 7], mask[n - 1, 7, 7] = np.nan, False
    return stack, mask


#: K3's route and block-shape boundaries: registers up to 8, 16, 24 and
#: 32 frames, 'smem' to 191, then 'cols' in blocks of 8 warps (to 3616
#: frames), 4 (to 7232), 2 (to 14496) and 1 (to the reach, 29024), then
#: 'select'
CLIP_FRAMES = [1, 2, 3, 7, 8, 9, 16, 17, 24, 25, 32, 33, 100, 191, 192, 193,
               1200, 3617, 7233, 14497, 29024, 29025]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", CLIP_FRAMES)
def test_clip_combine_kernel_equals_plain(cuda, n, masked):
    """K3 rounds every value operation as its twin does, so the two agree
    bit for bit, NaN where nothing is kept included; the width (300, 44
    past 2000 frames) is no multiple of any block's."""
    assert kernels._CLIP_COLS_REACH in CLIP_FRAMES
    assert kernels._CLIP_COLS_FRAMES in CLIP_FRAMES
    assert kernels._clip_route(max(CLIP_FRAMES)) == "select"
    h, w = (96, 300) if n <= 2000 else (8, 44)
    stack, mask = _clip_stack(n, h, w, n)
    if not masked:           # valid non-finite samples are outside the contract
        stack = np.where(np.isfinite(stack), stack, np.float32(800.0))
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
        # one valid sample is its own mean; masked inf / NaN add nothing
        assert float(got[4, 5]) == float(stack[n // 2, 4, 5])
        for y, x in ((6, 6), (7, 7)):
            assert bool(torch.isfinite(got[y, x])) == bool(mask[:, y, x].any())
        # a float mask (> 0.5 valid) is the same as the bool one
        fm = mk.to(torch.float32) * 0.75
        assert torch.equal(torch.nan_to_num(cc.clip_combine(st, fm, 3.0, 4.0)),
                           torch.nan_to_num(got))


def _select_stack(n, h, w, seed):
    """:func:`_clip_stack` with the columns the radix select must get
    right: row 0 all equal (MAD 0), row 1 two-valued (ties at both
    ranks), row 2 outliers at +-3.4e38 on a fifth of the frames, pixel
    (2, 1) fully masked, pixel (2, 2) with one valid sample of -3.4e38."""
    stack, mask = _clip_stack(n, h, w, seed)
    rng = np.random.default_rng(seed + 1)
    stack[:, 0, :] = 5.0
    stack[:, 1, :] = np.where(rng.uniform(size=(n, w)) < 0.5, 3.0, 7.5)
    big = rng.uniform(size=(n, w)) < 0.2
    sign = np.where(rng.uniform(size=(n, w)) < 0.5, 1.0, -1.0)
    stack[:, 2, :] = np.where(big, sign * 3.4e38, stack[:, 2, :])
    mask[:, 2, 1] = False
    mask[:, 2, 2] = False
    mask[n // 3, 2, 2] = True
    stack[n // 3, 2, 2] = -1.0e38
    return stack, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [29025, 30000])
def test_clip_combine_select_route(cuda, n, masked):
    """Past the 'cols' reach the public op takes K3's 'select' route (a
    radix select over the stack): bit for bit against the twin on
    all-equal, two-valued and +-3.4e38 columns, fully masked pixels (NaN)
    and one valid sample, with and without a mask, on a width (40) no
    multiple of the block's 32 pixels."""
    assert kernels._clip_route(n) == "select"
    stack, mask = _select_stack(n, 8, 40, 5)
    if not masked:           # valid non-finite samples are outside the contract
        stack = np.where(np.isfinite(stack), stack, np.float32(800.0))
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
    assert torch.equal(got[0], torch.full((40,), 5.0, device=cuda))
    if masked:
        assert bool(torch.isnan(got[2, 1])) and bool(torch.isnan(got[3, 5]))
        assert float(got[2, 2]) == float(np.float32(-1.0e38))


def test_kernel_wrapper_rejects_bad_input(cuda):
    fr = torch.zeros((2, 128, 256), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="uint16 or float32"):
        dt.detect_tiles(fr, torch.ones(2, device=cuda))
    with pytest.raises(ValueError, match="thresholds"):
        dt.detect_tiles(fr.to(torch.float32), torch.ones(3, device=cuda))
    with pytest.raises(ValueError, match="float32"):
        cc.clip_combine(fr, None)


@pytest.mark.parametrize("route", ["smem", "cols", "select"])
def test_clip_combine_routes_agree(cuda, route):
    """Every route the launcher has past 32 frames, forced on the same
    kind of stack (227 frames on 'smem', its limit, which refuses 228;
    909 on the others), is the twin's bit for bit: constant columns (MAD
    0), a column with one valid sample, the rest 20% masked."""
    n = 227 if route == "smem" else 909
    g = torch.Generator(device=cuda).manual_seed(9)
    st = 800.0 + 8.0 * torch.randn((n, 4, 100), generator=g, device=cuda)
    st[:, 0, :7] = 5.0
    mk = torch.rand(st.shape, generator=g, device=cuda) > 0.2
    mk[:, 1, 3] = False
    mk[17, 1, 3] = True
    before = kernels.launch_counts["clip_combine"]
    got = kernels.clip_combine_cuda(st, mk, 5.0, 5.0, route=route)
    assert kernels.launch_counts["clip_combine"] == before + 1
    want = cc.clip_combine_plain(st, mk)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert torch.equal(got[0, :7], torch.full((7,), 5.0, device=cuda))
    assert float(got[1, 3]) == float(st[17, 1, 3])
    if route == "smem":
        with pytest.raises(ValueError, match="227"):
            kernels.clip_combine_cuda(torch.cat([st, st[:1]]), None, 5.0, 5.0,
                                      route=route)


# -- RAW conversion and the calibration engine: the card against the CPU --

def _bayer(h, w, seed):
    """A uint16 RGGB mosaic with real edges, its colour map, black
    levels and white balance."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cmap = (2 * (yy % 2) + (xx % 2)).astype(np.uint8)
    cmap = np.array([0, 1, 3, 2], np.uint8)[cmap]
    base = 2000 + 1500 * np.sin(xx / 9.0) * np.cos(yy / 7.0) \
        + 900 * (xx > w // 2)
    gains = np.array([0.5, 1.0, 0.7, 1.0])[cmap]
    mosaic = base * gains + rng.normal(0, 25, (h, w)) + 512
    return (np.clip(mosaic, 0, 16383).astype(np.uint16), cmap,
            np.array([512, 500, 520, 508], np.float32),
            np.array([2.0, 1.0, 1.4, 1.0], np.float32))


DEMOSAIC_CASES = ["demosaic_bilinear", "demosaic_mhc", "demosaic_ahd",
                  "safe_subtract_black", "raw_to_rgb", "raw_to_grey_linear",
                  "raw_to_grey_direct", "split_channels", "wb_from_region",
                  "percentile_renorm"]


@pytest.mark.parametrize("name", DEMOSAIC_CASES)
def test_demosaic_functions_card_equals_cpu(cuda, name):
    """Each of the ten RAW-conversion functions gives on the card what
    it gives on the CPU: elementwise float32 work rounds alike (AHD by
    the tie rule: a pixel whose homogeneity test flips takes another of
    its three candidate values), the reductions of ``wb_from_region`` to
    1e-5 relative."""
    from astrophotography_tpu_torch.ops import demosaic as dk

    mosaic, cmap, blacks, wb = _bayer(192, 256, 0)
    cpu = [torch.from_numpy(a) for a in (mosaic, cmap, blacks, wb)]
    dev = [t.to(cuda) for t in cpu]

    def call(m, c, b, w):
        if name in ("demosaic_bilinear", "demosaic_mhc", "demosaic_ahd"):
            return getattr(dk, name)(m, c)
        if name == "safe_subtract_black":
            return dk.safe_subtract_black(m, c, b)
        if name in ("raw_to_rgb", "raw_to_grey_linear"):
            return getattr(dk, name)(m, c, b, w, 16383.0)
        if name == "raw_to_grey_direct":
            return dk.raw_to_grey_direct(m, c, b, w)
        if name == "split_channels":
            return dk.split_channels(m, c, b)
        sub = dk.safe_subtract_black(m, c, b)
        if name == "wb_from_region":
            return dk.wb_from_region(sub, c, [3, 150, 10, 200])
        return dk.percentile_renorm(sub)

    want = call(*cpu)
    got = call(*dev)
    assert got.device.type == "cuda" and got.dtype == want.dtype
    got = got.cpu()
    if name == "wb_from_region":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    elif name == "demosaic_ahd":
        bad = ((got - want).abs() > 1e-5 * want.abs() + 0.05).any(dim=-1)
        assert bad.float().mean() <= 2e-3
        if bad.any():
            ch, cv = dk._ahd_candidates(cpu[0], cpu[1])
            options = torch.stack([ch, cv, 0.5 * (ch + cv)])[:, bad]
            err = (options - got[bad][None]).abs().amax(dim=-1)
            assert (err.amin(dim=0) <= 0.05 + 1e-5 * got[bad].abs()
                    .amax(dim=-1)).all()
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.05)


def test_calibrator_round_trip_card_equals_cpu(cuda, tmp_path):
    """Masters built, a mask found and a light calibrated through the
    file engines on the card give the files the CPU run gives."""
    from astrophotography_tpu_torch.core import (Calibrator, find_badpix,
                                                 make_master)
    from astrophotography_tpu_torch.io.fits import (Header, read_image,
                                                    write_image)

    rng = np.random.default_rng(3)
    h, w = 96, 128
    rate = np.full((h, w), 0.5)
    rate[[9, 40, 77], [15, 100, 60]] = 200.0
    folders = {}
    for kind, level, exp in (("bias", 0.0, 0.0), ("dark", 60.0, 60.0)):
        folders[kind] = tmp_path / kind
        folders[kind].mkdir()
        for i in range(5):
            hdr = Header()
            hdr["IMAGETYP"] = kind.upper()
            hdr["EXPTIME"] = exp
            data = 300 + rate * level + rng.normal(0, 4, (h, w))
            write_image(str(folders[kind] / f"{kind}{i}.fits"),
                        data.round().astype(np.uint16), hdr)
    hdr = Header()
    hdr["IMAGETYP"] = "LIGHT"
    hdr["EXPTIME"] = 120.0
    light = str(tmp_path / "light.fits")
    write_image(light, (900 + 300 + rate * 120 + rng.normal(0, 6, (h, w)))
                .round().astype(np.uint16), hdr)
    outs = {}
    for name in ("cpu", "cuda"):
        bias = str(tmp_path / f"mbias_{name}.fits")
        dark = str(tmp_path / f"mdark_{name}.fits")
        mask = str(tmp_path / f"mask_{name}.fits")
        make_master(str(folders["bias"]), bias, device=name)
        make_master(str(folders["dark"]), dark, device=name)
        find_badpix(dark, mask, sigma=5.0, device=name)
        out = str(tmp_path / f"cal_{name}.fits")
        Calibrator(master_bias=bias, master_dark=dark, master_badpix=mask,
                   device=name).calibrate(light, out)
        outs[name] = [read_image(p, as_float32=False)[0]
                      for p in (bias, dark, mask, out)]
    for got, want in zip(outs["cuda"], outs["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)
    assert outs["cuda"][2][[9, 40, 77], [15, 100, 60]].all()
    repaired = outs["cuda"][3][[9, 40, 77], [15, 100, 60]]
    assert (np.abs(repaired - 900) < 40).all()


def test_frame_loaders_and_writer_on_the_card(cuda, tmp_path):
    """``read_image_device``, ``stream_stacks`` (pinned buffers, a copy
    stream, an event per chunk) and ``AsyncWriter`` with a device tensor:
    what arrives on the card, and what is written from it, is what the
    host reader gives."""
    from astrophotography_tpu_torch.io import read_image_device
    from astrophotography_tpu_torch.io.fits import (Header, read_image,
                                                    write_image)
    from astrophotography_tpu_torch.parallel import (AsyncWriter,
                                                     stream_stacks)

    rng = np.random.default_rng(5)
    paths, frames = [], []
    for i in range(7):
        data = rng.integers(0, 65536, (96, 160)).astype(np.uint16)
        hdr = Header()
        hdr["FRAMEIDX"] = i
        hdr["PEDESTAL"] = -100
        paths.append(str(tmp_path / f"f{i}.fits"))
        write_image(paths[-1], data, hdr)
        frames.append(data.astype(np.float32) - 100)
    got, hdr = read_image_device(paths[3], device=cuda)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert "PEDESTAL" not in hdr
    np.testing.assert_array_equal(got.cpu().numpy(), frames[3])
    sizes, at = [], 0
    with AsyncWriter() as writer:
        for names, stack, headers in stream_stacks(paths, chunk=3, depth=2,
                                                   workers=2, device=cuda):
            assert stack.device.type == "cuda"
            sizes.append(stack.shape[0])
            want = torch.from_numpy(np.stack(frames[at:at + len(names)]))
            assert torch.equal(stack.cpu(), want)
            assert [h["FRAMEIDX"] for h in headers] \
                == list(range(at, at + len(names)))
            # work enqueued on the consumer's stream, then handed over
            doubled = stack[0] * 2.0
            writer.submit(str(tmp_path / f"out{at}.fits"), doubled)
            at += len(names)
    assert sizes == [3, 3, 1]
    for at in (0, 3, 6):
        data, _ = read_image(str(tmp_path / f"out{at}.fits"))
        np.testing.assert_array_equal(data, frames[at] * 2.0)


def test_bench_attempt_lean_on_the_card(cuda):
    """bench_torch's lean line at 8x1024^2 on the card: K1 and K2 launched
    once each in one run, K3 not at all, the stack's interior median
    within 5% of the sky, the card's name and power limit in the line."""
    import bench_torch

    line = bench_torch.attempt(8, 1024, 1, "lean", device=cuda)
    assert line["launches"] == {"detect_tiles": 1, "warp_combine": 1,
                                "clip_combine": 0, "warp_separable": 0,
                                "find_exact": 0, "calibrate": 0}
    assert abs(line["interior_median"] - bench_torch.SKY) \
        < 0.05 * bench_torch.SKY
    assert line["vs_baseline"] is None and line["value"] > 0
    assert line["peak_mem_bytes"] > 0
    assert line["device"]["name"] == torch.cuda.get_device_name(0)
    assert line["device"]["power_limit_w"] > 0


@pytest.mark.parametrize("path", ["lean", "unfused"])
def test_spans_and_syncs_on_the_card(cuda, path):
    """Each entry at 8 x 1024^2 on the card under the profiler: every
    record holds its profiler range (started within 1 ms of the record),
    no program range reaches the card's timeline, the launches are
    counted in the spans, and the host reads the program counts in a
    call are the synchronizations the card's sync debug mode reports."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from astrophotography_tpu_torch.models import pipeline as pl
    from astrophotography_tpu_torch.utils import timing
    from stackbench.registry import Registry
    from stackbench.run import pipeline_config

    reg = Registry.load()
    name = {"lean": "lean-rot-16mpix-n100.rotate",
            "unfused": "unfused-16mpix-n24.dither"}[path]
    cell = reg.cell(name)
    config = dict(reg.config(cell["config"]), frames=8, height=1024,
                  width=1024)
    mix = reg.traffic(cell["traffic"])
    obs = reg.generator(mix["generator"]).inputs(config, mix, 2**31 + 3,
                                                 cuda)
    cfg = pipeline_config(config)
    entry = getattr(pl, config["entry"])

    def call():
        return entry(obs.frames, bias=obs.bias, dark=obs.dark, flat=obs.flat,
                     exp_ratios=obs.exp_ratios, config=cfg)

    call()
    torch.cuda.synchronize()
    timing.clear_records()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    recs = timing.records()
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("apt."):
            assert e.device_type() == torch.autograd.DeviceType.CPU
            events.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert {r["name"] for r in recs} == set(events)
    for span in events:
        mine = sorted((r["t0"], r["t1"]) for r in recs if r["name"] == span)
        assert len(mine) == len(events[span])
        for (t0, t1), (s, e) in zip(mine, sorted(events[span])):
            assert t0 <= s <= e <= t1 and s - t0 < 1_000_000, span
    counted = {}
    for r in recs:
        for k, v in r["counters"].items():
            counted[k] = counted.get(k, 0) + v
    if path == "lean":
        assert counted["launch.detect_tiles"] == 1
        assert counted["launch.warp_combine"] == 1
        assert counted["launch.warp_combine.smem"] == 1
    else:
        # calibration's and exact detection's kernels once, the plain
        # warp's and K3 (under the cell's 'xla') once a band
        assert {k: v for k, v in counted.items()
                if k.startswith("launch.")} == {
                    "launch.calibrate": 1,
                    "launch.find_exact": 1,
                    "launch.clip_combine": cfg.n_bands,
                    "launch.warp_separable": cfg.n_bands,
                    "launch.warp_separable.smem": cfg.n_bands}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    assert syncs == counted.get("host_reads", 0) > 0


def test_unfused_xla_combines_with_k3_on_the_card(cuda, monkeypatch):
    """``calibrate_register_stack`` under the default engine 'xla' (the
    unfused cell's configuration at 8 x 1024^2): K3 once a band, and the
    stack each band's replay through ``clip_combine_plain`` bit for
    bit."""
    from astrophotography_tpu_torch.models import pipeline as pl
    from stackbench.registry import Registry
    from stackbench.run import pipeline_config

    reg = Registry.load()
    cell = reg.cell("unfused-16mpix-n24.dither")
    config = dict(reg.config(cell["config"]), frames=8, height=1024,
                  width=1024)
    mix = reg.traffic(cell["traffic"])
    obs = reg.generator(mix["generator"]).inputs(config, mix, 2**31 + 23,
                                                 cuda)
    cfg = pipeline_config(config)
    assert cfg.combine_impl == "xla" and cfg.n_bands == 2
    bands = []
    combine = pl.combine_band

    def keep(warped, weights, config):
        bands.append((warped.clone(), weights.clone()))
        return combine(warped, weights, config)

    monkeypatch.setattr(pl, "combine_band", keep)
    before = kernels.launch_counts["clip_combine"]
    got, _diag = pl.calibrate_register_stack(
        obs.frames, bias=obs.bias, dark=obs.dark, flat=obs.flat,
        exp_ratios=obs.exp_ratios, config=cfg)
    assert kernels.launch_counts["clip_combine"] == before + cfg.n_bands
    assert len(bands) == cfg.n_bands
    plain = [cc.clip_combine_plain(w, m > 0.5, cfg.sigma_lower,
                                   cfg.sigma_upper) for w, m in bands]
    want = torch.cat([torch.where(torch.isnan(p), 0.0, p) for p in plain])
    assert torch.equal(got, want)
    assert float((got != 0).float().mean()) > 0.9


def test_altaz_cell_on_the_card(cuda):
    """The alt-az cell's configuration (``lean-wide-4mpix-n360``) at 24
    frames of 1024^2 on the card, under the profiler: K1 and one K2
    launch, on the 'wide' route, its span saying so; every (frame, tile)
    pair combined; the refit inside the solve; the kernel's image the
    twin's bit for bit on the call's own matrices; and every host read
    counted (the card's sync debug mode reports as many)."""
    import math
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from astrophotography_tpu_torch.models import pipeline as pl
    from astrophotography_tpu_torch.ops.register import Similarity
    from astrophotography_tpu_torch.utils import timing
    from stackbench.registry import Registry
    from stackbench.run import pipeline_config

    reg = Registry.load()
    cell = reg.cell("lean-wide-4mpix-n360.altaz")
    n, size = 24, 1024
    config = dict(reg.config(cell["config"]), frames=n, height=size,
                  width=size)
    mix = dict(reg.traffic(cell["traffic"]))
    # the mix's edge rule at this size: a star turned 15 deg stays inside
    c = (size - 1) / 2
    t = math.radians(mix["rotation_deg"][1])
    mix["star_edge_px"] = math.ceil(c - (c - 17) / (math.cos(t) + math.sin(t)))
    obs = reg.generator(mix["generator"]).inputs(config, mix, 2**31 + 29,
                                                 cuda)
    cfg = pipeline_config(config)

    def call():
        return pl.calibrate_register_stack_lean(
            obs.frames, bias=obs.bias, dark=obs.dark, flat=obs.flat,
            exp_ratios=obs.exp_ratios, config=cfg)

    call()
    torch.cuda.synchronize()
    timing.clear_records()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        image, diag = call()
        torch.cuda.synchronize()
    recs = timing.records()
    counted = {}
    for r in recs:
        for k, v in r["counters"].items():
            counted[k] = counted.get(k, 0) + v
    assert {k: v for k, v in counted.items() if k.startswith("launch.")} \
        == {"launch.detect_tiles": 1, "launch.warp_combine": 1,
            "launch.warp_combine.wide": 1}
    assert counted["warp_combine.frame_tiles_used"] \
        == counted["warp_combine.frame_tiles"] == n * 4
    (k2,) = [r for r in recs if r["name"] == "apt.warp_combine.k2"]
    assert k2["attrs"] == {"route": "wide", "span": 288, "taps": "exact"}
    assert any(r["name"] == "apt.register.refit" for r in recs)
    assert int(diag["n_inliers"].min()) >= 3
    mats = Similarity(diag["scale"], diag["theta"], diag["tx"], diag["ty"],
                      diag["n_inliers"], diag["rms"]).matrix()
    masters = pl.lean_masters(obs.bias, obs.dark, obs.flat, cfg, size, size,
                              cuda)
    twin = wc.warp_combine_plain(obs.frames, mats, masters=masters,
                                 exp_ratios=obs.exp_ratios,
                                 **pl.lean_kernel_kwargs(cfg, size, size))
    assert torch.equal(image, twin)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = sum("called a synchronizing CUDA operation" in str(w.message)
                for w in caught)
    assert syncs == counted.get("host_reads", 0) > 0


# -- the separable warp (csrc/warp_separable.cu) against its twin --------


def _sep_mats(n, seed, max_deg=0.01, shift=4.0, scale=1e-5):
    """``n`` similarity matrices on the CPU: turns to +-max_deg, scales
    within ``scale``, translations to +-shift px (frame 0 the
    identity)."""
    rng = np.random.default_rng(seed)
    th = np.deg2rad(rng.uniform(-max_deg, max_deg, n))
    sc = 1.0 + rng.uniform(-scale, scale, n)
    t = rng.uniform(-shift, shift, (n, 2))
    th[0], sc[0], t[0] = 0.0, 1.0, 0.0
    c, s = sc * np.cos(th), sc * np.sin(th)
    mats = np.stack([np.stack([c, -s, t[:, 0]], 1),
                     np.stack([s, c, t[:, 1]], 1)], 1)
    return torch.from_numpy(mats.astype(np.float32))


def _sep_field(n, h, w, seed, dev):
    """A sky of 800 with a gradient, noise and negative pixels, made on
    the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    img = 800.0 + 0.01 * xx - 0.02 * yy + 8.0 * torch.randn(
        (n, h, w), generator=gen, device=dev)
    img[:, ::9, ::7] *= -1.0
    return img.contiguous()


def _same_bits(got, want, what):
    gn, wn = torch.isnan(got), torch.isnan(want)
    assert torch.equal(gn, wn), what
    diff = (torch.where(gn, 0.0, got).view(torch.int32)
            != torch.where(wn, 0.0, want).view(torch.int32))
    assert not bool(diff.any()), \
        f"{what}: {int(diff.sum())} of {diff.numel()} values differ"


def _sep_check(imgs, mats, out_shape, route=None, **kw):
    """The separable warp on the card against its twin on the same
    tensors, bit for bit (a NaN only has to be a NaN), with the launches
    on the route the rule names counted from 0.  Returns the kernel's
    (warped, coverage)."""
    from astrophotography_tpu_torch.ops import warp as wp

    span = kw.get("span", 24)
    chans = 1 if kw.get("analytic_coverage") else 2
    band, pad, pad_t = wp._separable_geometry(
        imgs.shape[-2], out_shape, kw.get("band", 64), span,
        kw.get("translation_budget"))
    want_route = route or kernels._warp_separable_route(band, span, chans)
    kernels.reset_launch_counts()
    if route is None:
        got = wp.warp_affine_separable(imgs, mats, out_shape, **kw)
    else:
        got = kernels.warp_separable_cuda(
            imgs, mats.to(imgs.device), out_shape, band, span,
            bool(kw.get("analytic_coverage")), kw.get("translation_budget"),
            pad, pad_t, route=route)
    launches = dict(kernels.launch_counts)
    routes = dict(kernels.warp_separable_route_counts)
    want = wp.warp_affine_separable_plain(imgs, mats.to(imgs.device),
                                          out_shape, **kw)
    torch.cuda.synchronize()
    n = imgs.shape[0] if imgs.dim() == 3 else 1
    per = 1 if want_route == "smem" else 2 * -(-n // kernels.
                                              _warp_separable_chunk(
                                                  n, chans, imgs.shape[-2],
                                                  out_shape[1]))
    assert launches == {"detect_tiles": 0, "warp_combine": 0,
                        "clip_combine": 0, "warp_separable": per,
                        "find_exact": 0, "calibrate": 0}
    assert routes == {"smem": 0, "scratch": 0, want_route: per}
    _same_bits(got[0], want[0], "warped")
    _same_bits(got[1], want[1], "coverage")
    return got


def test_warp_separable_the_cells_bands(cuda):
    """The unfused cell's warp at 24 x 512 x 4096: both output bands
    (``band_matrices``), span 12, analytic coverage, one 'smem' launch a
    band."""
    from astrophotography_tpu_torch.models.pipeline import band_matrices

    imgs = _sep_field(24, 512, 4096, 1, cuda)
    mats = _sep_mats(24, 2).to(cuda)
    assert kernels._warp_separable_route(64, 12, 1) == "smem"
    for b in range(2):
        _sep_check(imgs, band_matrices(mats, float(b * 256)), (256, 4096),
                   span=12, analytic_coverage=True)


#: (frames, source shape, output shape, keyword arguments)
SEP_CASES = [
    (6, (256, 384), (256, 384), dict(span=12)),
    (6, (256, 384), (256, 384), dict(span=24, analytic_coverage=True,
                                     translation_budget=48)),
    (6, (256, 384), (256, 384), dict(span=12, translation_budget=40)),
    (5, (200, 300), (232, 336), dict(span=24, analytic_coverage=True)),
    (5, (200, 300), (232, 336), dict(span=24)),
    (4, (250, 236), (250, 236), dict(span=24, analytic_coverage=True)),
    (4, (501, 333), (501, 333), dict(span=12)),
    (3, (501, 333), (501, 333), dict(span=12, band=17,
                                     analytic_coverage=True)),
    (3, (40, 333), (40, 333), dict(span=24)),        # band cut to 40
]


@pytest.mark.parametrize("n,in_shape,out_shape,kw", SEP_CASES)
def test_warp_separable_equals_plain(cuda, n, in_shape, out_shape, kw):
    imgs = _sep_field(n, *in_shape, seed=n + in_shape[0], dev=cuda)
    mats = _sep_mats(n, seed=in_shape[1], max_deg=0.5).to(cuda)
    _sep_check(imgs, mats, out_shape, **kw)


@pytest.mark.parametrize("deg", [0.1, 2.0, 15.0])
@pytest.mark.parametrize("span,analytic", [(24, True), (24, False),
                                           (256, True), (256, False),
                                           (1700, False), (3300, True)])
def test_warp_separable_rotations(cuda, deg, span, analytic):
    """Turns of 0.1-15 deg at span 24 ('smem'), 256 and past the reach of
    a 16-column 'smem' tile (1700 with the ones channel, 3300 without),
    each on the route its rule names and on every route it can take."""
    imgs = _sep_field(3, 144, 160, seed=span, dev=cuda)
    mats = _sep_mats(3, seed=int(deg * 10), max_deg=deg, shift=6.0)
    mats[1, :, :2] = torch.tensor([[np.cos(np.deg2rad(deg)),
                                    -np.sin(np.deg2rad(deg))],
                                   [np.sin(np.deg2rad(deg)),
                                    np.cos(np.deg2rad(deg))]])
    mats = mats.to(cuda)
    kw = dict(span=span, analytic_coverage=analytic)
    got = _sep_check(imgs, mats, (144, 160), **kw)
    chans = 1 if analytic else 2
    if kernels._warp_separable_tile(64, span, chans):
        for route in ("smem", "scratch"):
            other = _sep_check(imgs, mats, (144, 160), route=route, **kw)
            for g, o in zip(got, other):
                _same_bits(o, g, route)
    else:
        assert span > 1600


@pytest.mark.parametrize("analytic", [True, False])
def test_warp_separable_scratch_in_chunks(cuda, monkeypatch, analytic):
    """'scratch' with its mid image capped at two frames: five frames in
    three launch pairs, each chunk's pointers offset by its first frame."""
    chans = 1 if analytic else 2
    monkeypatch.setattr(kernels, "_SEP_SCRATCH_MAX", 2 * 4 * chans * 96 * 128)
    assert kernels._warp_separable_chunk(5, chans, 96, 128) == 2
    imgs = _sep_field(5, 96, 128, seed=13, dev=cuda)
    mats = _sep_mats(5, seed=14, max_deg=4.0).to(cuda)
    _sep_check(imgs, mats, (96, 128), span=64, analytic_coverage=analytic)


@pytest.mark.parametrize("tile", [16, 32, 64, 128])
def test_warp_separable_every_tile_width(cuda, tile, monkeypatch):
    """Each tile width the kernel takes, the rule held to that one."""
    monkeypatch.setattr(kernels, "_SEP_TILE_COLS", (tile,))
    assert kernels._warp_separable_tile(64, 24, 2) == tile
    imgs = _sep_field(3, 200, 300, seed=tile, dev=cuda)
    mats = _sep_mats(3, seed=tile, max_deg=3.0).to(cuda)
    _sep_check(imgs, mats, (200, 300), route="smem", span=24)


@pytest.mark.parametrize("analytic", [True, False])
def test_warp_separable_far_frames(cuda, analytic):
    """A rejected frame at +1e9, one at -1e9 and frames thousands of
    pixels off: the twin's floor / clamp cases (coverage and values 0)."""
    imgs = _sep_field(6, 128, 192, seed=5, dev=cuda)
    mats = _sep_mats(6, seed=6, max_deg=1.0)
    mats[1, :, 2] = 1e9
    mats[2, :, 2] = -1e9
    mats[3, :, 2] = torch.tensor([-5000.0, 130.5])
    mats[4, :, 2] = torch.tensor([250.25, -9000.0])
    mats[5, :, 2] = torch.tensor([-150.0, -100.0])
    got = _sep_check(imgs, mats.to(cuda), (128, 192), span=12,
                     analytic_coverage=analytic)
    assert not bool(got[1][1:5].any())


@pytest.mark.parametrize("analytic", [True, False])
def test_warp_separable_non_finite_source(cuda, analytic):
    """A NaN and infinities planted in the source give the twin's
    non-finite pixels, at the same places."""
    imgs = _sep_field(4, 128, 192, seed=7, dev=cuda)
    imgs[1, 40, 50] = float("nan")
    imgs[2, 70, 100] = float("inf")
    imgs[3, 20, 150] = float("-inf")
    mats = _sep_mats(4, seed=8, max_deg=1.0).to(cuda)
    got = _sep_check(imgs, mats, (128, 192), span=12,
                     analytic_coverage=analytic)
    assert bool(torch.isnan(got[0][1]).any())
    assert not bool(torch.isfinite(got[0][2]).all())


def test_warp_separable_single_frame_and_uint16(cuda):
    """One (H, W) frame and a uint16 stack take the kernel too."""
    from astrophotography_tpu_torch.device import to_uint16

    imgs = _sep_field(3, 128, 160, seed=9, dev=cuda).abs()
    mats = _sep_mats(3, seed=10, max_deg=0.5).to(cuda)
    _sep_check(imgs[1], mats[1], (128, 160), span=12)
    _sep_check(to_uint16(imgs), mats, (128, 160), span=12,
               analytic_coverage=True)


def test_warp_separable_makes_no_host_read(cuda):
    """The kernel path waits for the card nowhere: under the sync debug
    mode's 'error' a call raises on any synchronization."""
    from astrophotography_tpu_torch.models.pipeline import band_matrices
    from astrophotography_tpu_torch.ops import warp as wp

    imgs = _sep_field(6, 256, 512, seed=11, dev=cuda)
    mats = _sep_mats(6, seed=12).to(cuda)
    for route in ("smem", "scratch"):
        kernels.warp_separable_cuda(imgs, mats, (128, 512), 64, 12, True,
                                    None, 528, 144, route=route)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in range(2):
            out = wp.warp_affine_separable(
                imgs, band_matrices(mats, float(128 * b)), (128, 512),
                span=12, analytic_coverage=True)
        kernels.warp_separable_cuda(imgs, mats, (128, 512), 64, 12, False,
                                    None, 528, 144, route="scratch")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out[0].shape == (6, 128, 512)


def _cal_inputs(n, h, w, seed, dtype="uint16", dev="cpu"):
    """``test_torch_calibrate_kernel._inputs`` (raw over the whole uint16
    range, a flat with zeros, NaNs and negative values) as tensors on
    ``dev``: the stack and calibrate_batch's keyword arguments."""
    from test_torch_calibrate_kernel import _inputs, _tensor

    raw, bias, dark, flat, ratios = _inputs(n, h, w, seed, dtype)
    kw = dict(bias=bias, dark=dark, flat=flat, exp_ratios=ratios)
    return _tensor(raw).to(dev), {k: torch.from_numpy(v).to(dev)
                                  for k, v in kw.items()}


def _cal_check(imgs, kw, launches=1, badpix_mask=None):
    """calibrate_batch on the card against calibrate_batch_plain on the
    same tensors, bit for bit (NaNs in place), with ``launches`` launches
    of the kernel.  Returns the kernel path's stack."""
    from astrophotography_tpu_torch.ops import calibrate as cb

    before = kernels.launch_counts["calibrate"]
    got = cb.calibrate_batch(imgs, badpix_mask=badpix_mask, **kw)
    assert kernels.launch_counts["calibrate"] == before + launches
    want = cb.calibrate_batch_plain(imgs, badpix_mask=badpix_mask, **kw)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape == imgs.shape
    _same_bits(got, want, "calibrated")
    return got


CAL_CASES = {
    "n1": dict(n=1, h=64, w=256),
    "n3": dict(n=3, h=64, w=256),
    "n7_unrolled": dict(n=7, h=1024, w=1024),
    "n40": dict(n=40, h=512, w=2048),
    "ragged_7x13": dict(n=3, h=7, w=13),
    "ragged_5x4099": dict(n=4, h=5, w=4099),
    "float32": dict(n=5, h=1024, w=1024, dtype="float32"),
    "int16": dict(n=5, h=64, w=256, dtype="int16"),
    "float32_ragged": dict(n=3, h=9, w=11, dtype="float32"),
    "no_bias": dict(n=3, h=64, w=256, drop=("bias",)),
    "no_dark": dict(n=3, h=64, w=256, drop=("dark",)),
    "no_flat": dict(n=3, h=64, w=256, drop=("flat",)),
    "bias_only_float32": dict(n=3, h=64, w=256, dtype="float32",
                              drop=("dark", "flat")),
    "no_masters": dict(n=3, h=64, w=256, drop=("bias", "dark", "flat")),
    "dark_not_biased": dict(n=3, h=64, w=256, dark_still_biased=False),
    "no_ratios": dict(n=6, h=64, w=256, drop=("exp_ratios",)),
    "badpix": dict(n=3, h=64, w=256, badpix=True),
    "badpix_no_masters_float32": dict(n=2, h=32, w=64, dtype="float32",
                                      drop=("bias", "dark", "flat"),
                                      badpix=True),
}


@pytest.mark.parametrize("case", sorted(CAL_CASES))
def test_calibrate_equals_plain(cuda, case):
    """The calibration kernel against its twin, bit for bit, on the card
    and against the twin on the CPU; a float32 or int16 stack without
    masters launches nothing, as the twin computes nothing."""
    c = dict(CAL_CASES[case])
    drop, badpix = c.pop("drop", ()), c.pop("badpix", False)
    dsb = c.pop("dark_still_biased", True)
    imgs, kw = _cal_inputs(c["n"], c["h"], c["w"], seed=len(case),
                           dtype=c.get("dtype", "uint16"), dev=cuda)
    for k in drop:
        kw[k] = None
    kw["dark_still_biased"] = dsb
    mask = None
    if badpix:
        rng = np.random.default_rng(5)
        mask = torch.from_numpy(rng.random((c["h"], c["w"])) < 0.02).to(cuda)
    masterless = all(kw[k] is None for k in ("bias", "dark", "flat"))
    launches = 0 if masterless and c.get("dtype") in ("float32",
                                                      "int16") else 1
    got = _cal_check(imgs, kw, launches, mask)
    from astrophotography_tpu_torch.ops import calibrate as cb

    cpu = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
           for k, v in kw.items()}
    want = cb.calibrate_batch_plain(
        imgs.cpu(), badpix_mask=None if mask is None else mask.cpu(), **cpu)
    _same_bits(got.cpu(), want, "calibrated against the CPU twin")


def test_calibrate_the_cells_stack(cuda):
    """The unfused cell's own call: 24 x 4096^2 uint16 with the
    benchmark's masters and exposure ratio 0.5, one launch, bit for bit
    the twin on the card; two frames against the twin on the CPU."""
    from astrophotography_tpu_torch.ops import calibrate as cb
    from stackbench.registry import Registry
    from stackbench.run import pipeline_config

    reg = Registry.load()
    cell = reg.cell("unfused-16mpix-n24.dither")
    config = reg.config(cell["config"])
    mix = reg.traffic(cell["traffic"])
    obs = reg.generator(mix["generator"]).inputs(config, mix, 2**31 + 29,
                                                 cuda)
    assert obs.frames.shape == (24, 4096, 4096)
    assert obs.frames.dtype == torch.uint16
    assert bool((obs.exp_ratios == 0.5).all())
    kw = dict(bias=obs.bias, dark=obs.dark, flat=obs.flat,
              exp_ratios=obs.exp_ratios,
              dark_still_biased=pipeline_config(config).dark_still_biased)
    got = _cal_check(obs.frames, kw)
    idx = [0, 23]
    raw = obs.frames.view(torch.int16)[idx].view(torch.uint16)
    cpu = cb.calibrate_batch_plain(
        raw.cpu(), obs.bias.cpu(), obs.dark.cpu(), obs.flat.cpu(),
        obs.exp_ratios[idx].cpu(),
        dark_still_biased=kw["dark_still_biased"])
    _same_bits(got[idx].cpu(), cpu, "the cell's frames against the CPU")


def test_calibrate_launcher_makes_no_host_read(cuda):
    """The kernel path waits for the card nowhere, and allocates only its
    output: the peak rises by the float32 stack alone."""
    from astrophotography_tpu_torch.ops import calibrate as cb

    imgs, kw = _cal_inputs(6, 256, 512, seed=3, dev=cuda)
    cb.calibrate_batch(imgs, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = cb.calibrate_batch(imgs, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base == out.numel() * 4


def test_unfused_pipeline_launches_calibrate_once(cuda):
    """``calibrate_register_stack`` on the card launches the calibration
    kernel once a call, with and without a bad-pixel mask, and no more."""
    from astrophotography_tpu_torch.models import pipeline as pl
    from stackbench.registry import Registry
    from stackbench.run import pipeline_config

    reg = Registry.load()
    cell = reg.cell("unfused-16mpix-n24.dither")
    config = dict(reg.config(cell["config"]), frames=8, height=1024,
                  width=1024)
    mix = reg.traffic(cell["traffic"])
    obs = reg.generator(mix["generator"]).inputs(config, mix, 2**31 + 31,
                                                 cuda)
    cfg = pipeline_config(config)
    hot = obs.dark - obs.bias > 1000.0
    for mask in (None, hot):
        before = kernels.launch_counts["calibrate"]
        pl.calibrate_register_stack(
            obs.frames, bias=obs.bias, dark=obs.dark, flat=obs.flat,
            exp_ratios=obs.exp_ratios, badpix_mask=mask, config=cfg)
        assert kernels.launch_counts["calibrate"] == before + 1
