"""The count of exact detection on the unfused cell's shape."""

from stackbench import counts, counts_find


def test_footprint_taps():
    assert counts_find.footprint_taps(3.0) == 21       # 5 x 5 less corners
    assert counts_find.footprint_taps(4.0) == 37       # radius 3
    assert counts_find.footprint_taps(11.3) == 225     # radius 8


def test_find_exact_counts_24_frames_of_4096():
    n, h, w = 24, 4096, 4096
    b, ops = counts_find.find_exact(n, h, w, 3.0, 48)
    assert b == n * h * w * 4 + 8 * n + n * 48 * 25
    assert ops == n * h * w * (2 * 21 + 9)
    # bound by its bytes: the float32 stack once, ~0.48 ms
    assert b / counts.PEAK_BYTES_S > ops / counts.PEAK_F32_S
    assert abs(counts.bound_s(b, ops) - 0.481e-3) < 0.001e-3
