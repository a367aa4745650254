"""The benchmark's arithmetic on hand-built numbers."""

import pytest

from cellbench import harness, measure


def test_union_of_device_intervals():
    assert measure.union_length([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert measure.union_length([]) == 0


def test_idle_gaps_and_their_host_labels():
    dev = [(10, 20), (15, 30), (50, 60)]
    assert measure.gaps(dev, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    host = [("request", 0, 100), ("aten::nonzero", 35, 45)]
    named = measure.label_gaps(measure.gaps(dev, 0, 100), host, top=2)
    assert named == [["request", 40e-6], ["aten::nonzero", 20e-6]]


def test_p95_is_over_every_request():
    lat = list(range(1, 101))  # 1..100
    assert measure.percentile(lat, 95) == pytest.approx(95.05)
    assert measure.percentile(lat, 50) == pytest.approx(50.5)
    assert measure.percentile([7.0], 95) == 7.0


def test_blend_bound_by_operations_and_by_bytes():
    peaks = {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}
    work = {"walked": 1000, "live": 100, "channels": 12, "entries": 10,
            "tiles": 2, "pixels_per_tile": 64}
    assert measure.blend_ops(work) == 1000 * 16 + 100 * 28
    assert measure.blend_bytes(work) == 10 * 20 * 4 + 2 * 64 * 13 * 4
    assert measure.blend_bound_s(work, peaks) == pytest.approx(
        max(18800 / 67e12, 7456 / 3.35e12))
    heavy = dict(work, walked=10**9, live=10**8)
    assert measure.blend_bound_s(heavy, peaks) == pytest.approx(
        (16e9 + 28e8) / 67e12)


def test_step_mfu_and_roofline_readers():
    ctx = harness.Ctx(window_s=2.0, completed=4)
    assert ctx.request_ms == 500.0
    ctx.peaks = {"fp32_flops": 1e12, "hbm_bytes_per_s": 1e12}
    work = {"walked": 10**9, "live": 0, "channels": 3, "entries": 0,
            "tiles": 0, "pixels_per_tile": 64}
    ctx.traced_work = [[work], [work]]
    ctx.network_flops = 4 * 10**9
    mfu = harness.load_reader("step_mfu")(ctx)
    assert mfu == pytest.approx((16e9 + 4e9) / (0.5 * 1e12) * 100)
    ctx.trace = {"by_name": {"void stream_blend_kernel<3, true>(...)": 0.064,
                             "other": 1.0}, "busy_s": 1.5, "window_s": 2.0,
                 "requests": 4}
    roof = harness.load_reader("blend_roofline")(ctx)
    assert roof == pytest.approx(2 * 16e-3 / 0.064 * 100)
    # 1.5 s busy over 4 profiled requests against 500 ms per request in
    # the window; the profiled stretch's own 2 s is not read
    assert harness.load_reader("device_idle")(ctx) == pytest.approx(25.0)
    ctx.trace["window_s"] = 3.0
    assert harness.load_reader("device_idle")(ctx) == pytest.approx(25.0)


def test_readers_return_nothing_where_nothing_is_read():
    ctx = harness.Ctx()
    for name in ("blend_roofline", "step_mfu", "device_idle", "model_ms",
                 "rgb_ms", "host_syncs", "request_ms"):
        assert harness.load_reader(name)(ctx) is None, name
    ctx.trace = {"by_name": {"other": 1.0}, "busy_s": 1.0, "window_s": 2.0,
                 "requests": 1}
    ctx.traced_work = [[{"walked": 1, "live": 1, "channels": 3,
                         "entries": 1, "tiles": 1, "pixels_per_tile": 64}]]
    ctx.peaks = {"fp32_flops": 1e12, "hbm_bytes_per_s": 1e12}
    assert harness.load_reader("blend_roofline")(ctx) is None  # no kernel

