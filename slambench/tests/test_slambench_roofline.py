"""The rooflines' counts at the shapes of PERF.md's kernel table: the least
time the benchmark computes for each equals the table's bound."""

import pytest

from slambench import roofline

PEAK = roofline.PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("shape, bound_us", [
    ((1, 200, 200), 0.060), ((1, 400, 400), 0.239), ((1, 256, 256), 0.098),
    ((1, 512, 512), 0.391), ((8, 256, 256), 0.783), ((8, 448, 448), 2.396),
    ((50, 448, 448), 14.978)])
def test_field_bound(shape, bound_us):
    b, h, w = shape
    least = roofline.least_seconds({"fields": [(h, w, b)], "volumes": []},
                                   PEAK)
    assert least["k1"] * 1e6 == pytest.approx(bound_us, abs=0.0015)
    assert least["k2"] == 0


@pytest.mark.parametrize("t, half, s, b, n, bound_us, by", [
    (7, 6, 400, 1, 1079, 0.211, "bytes"),
    (13, 6, 512, 1, 1079, 0.349, "bytes"),
    (21, 14, 256, 8, 1069, 2.255, "operations")])
def test_volume_bound(t, half, s, b, n, bound_us, by):
    work = {"fields": [], "volumes": [(t, n, half, s)] * b}
    least = roofline.least_seconds(work, PEAK)
    assert least["k2"] * 1e6 == pytest.approx(bound_us, rel=0.01)
    ops = roofline.volume_ops(t, n, half) / PEAK["f32_flop_per_s"]
    moved = roofline.volume_bytes(t, n, half, s) / PEAK["bytes_per_s"]
    assert (ops > moved) == (by == "operations")


def test_kernel_seconds_sums_by_name():
    names = {"edt_band_kernel(unsigned char const*, float*)": 2e-6,
             "void corr_volume_kernel<1>(float const*)": 5e-6,
             "Memcpy HtoD": 1e-6}
    assert roofline.kernel_seconds(names, ("edt_band_kernel",)) == 2e-6
    assert roofline.kernel_seconds(names, ("corr_volume_kernel",)) == 5e-6
