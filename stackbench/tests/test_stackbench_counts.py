"""The count-once arithmetic on known shapes."""

import math

from stackbench import counts


def test_bound_takes_the_larger_side():
    assert counts.bound_s(3.35e12, 0) == 1.0
    assert counts.bound_s(0, 67e12) == 1.0
    assert counts.bound_s(3.35e12, 134e12) == 2.0


def test_detect_radius_rule():
    assert counts.detect_radius(3.0) == 2
    assert counts.detect_radius(8.0) == 6
    assert counts.detect_radius(1.0) == 2


def test_detect_counts_100_frames_of_4096():
    n, h, w = 100, 4096, 4096
    b, ops = counts.detect(n, h, w, 3.0)
    tiles = n * 64 * 16
    assert b == n * h * w * 2 + h * w * 4 + 2 * 2048 * w * 4 + 8 * n \
        + 16 * tiles
    assert ops == n * h * w * (3 * 5 + 9.5)
    # K1's bound at this shape is set by its bytes, ~1.04 ms
    assert abs(counts.bound_s(b, ops) - 1.04e-3) < 0.01e-3


def test_warp_combine_counts():
    b, ops = counts.warp_combine(100, 4096, 4096)
    assert b == 100 * 4096 ** 2 * 2 + 16 * 4096 ** 2
    assert ops == 100 * 4096 ** 2 * (30 + math.log2(100))
    assert abs(counts.bound_s(b, ops) - 1.08e-3) < 0.01e-3


def test_band_counts_add_up_to_the_stack():
    n, h, w, bands = 24, 4096, 4096, 2
    whole = counts.warp(n, h, w)
    half = counts.warp(n, h // bands, w)
    assert whole == tuple(bands * x for x in half)
    b, ops = counts.combine(n, h, w)
    assert b == 2 * n * h * w * 4 + h * w * 4
    assert ops == n * h * w * (2 * math.log2(n) + 8)

