"""The count of calibration on the unfused cell's shape."""

from stackbench import counts, counts_calibrate


def test_calibrate_counts_24_frames_of_4096():
    n, h, w = 24, 4096, 4096
    b, ops = counts_calibrate.calibrate(n, h, w, 2)
    # uint16 in 805 MB, masters 201 MB, ratios 96 B, float32 out 1.61 GB
    assert b == 805_306_368 + 201_326_592 + 96 + 1_610_612_736
    assert b == 2_617_245_792
    assert ops == 5 * n * h * w
    # bound by its bytes: ~0.781 ms at 3.35 TB/s
    assert b / counts.PEAK_BYTES_S > ops / counts.PEAK_F32_S
    assert abs(counts.bound_s(b, ops) - 0.781e-3) < 0.001e-3


def test_calibrate_counts_float32_input():
    b, ops = counts_calibrate.calibrate(2, 8, 16, 4)
    assert b == 2 * 128 * 4 + 3 * 128 * 4 + 2 * 4 + 2 * 128 * 4
    assert ops == 2 * 128 * 5
