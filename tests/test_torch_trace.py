"""The port's spans and counters (``gpcr_tpu_torch/utils/trace.py``) on
the CPU: off they cost one shared no-op object and change nothing; on they
form the tree of the render path, count what the path already holds on the
host, sit on the profiler's clock, and place device time and idle under
the innermost span.

Renders: 3,000 points of the profile's synthetic cloud, a U-Net of width
8 (learned) and 2 views of 32 px.
"""

import pytest
import torch

from gpcr_tpu_torch.cli.profile_pcrender import LEARNED_INFO, synthetic_cloud
from gpcr_tpu_torch.ops import rasterize as R
from gpcr_tpu_torch.ops import rasterize_stream as RS
from gpcr_tpu_torch.render import renderer as RD
from gpcr_tpu_torch.structures.pointcloud import PointCloud
from gpcr_tpu_torch.utils import trace

# one intra-op thread: see tests/test_torch_render.py
torch.set_num_threads(1)

VIEW_CHILDREN = ["gpcr.raster.features", "gpcr.raster.preprocess",
                 "gpcr.raster.bin",
                 "gpcr.raster.order", "gpcr.raster.blend",
                 "gpcr.raster.epilogue"]
VIEWS = 2


def _cam():
    return RD.generate_cam({"fov": 45, "width_px": 32, "height_px": 32,
                            "mode": "circle", "n_imgs": VIEWS, "d": 0,
                            "r": 3, "center_angles": [90, 0]})


@pytest.fixture(scope="module")
def scene():
    xyz, rgb = synthetic_cloud(3000)
    return PointCloud.from_numpy(xyz, rgb), _cam()


def _renderer(kind):
    if kind == "learned":
        info = dict(LEARNED_INFO, clr_encoder_channels="9 8 8 8 8 8")
        config = R.RasterizeConfig(max_dup_per_gaussian=256, chunk_size=256,
                                   opacity_radius=True)
        return RD.PCMLRender(info=info, voxelized=True, scale_factor=448,
                             config=config, device="cpu")
    # the analytic cell's caps, cut to 32 px: some entries are dropped
    config = R.RasterizeConfig(max_dup_per_gaussian=4, chunk_size=256,
                               k_budget=20000, max_active_tiles=3)
    return RD.SimpleRender(voxelized=True, scale_factor=448, config=config)


@pytest.fixture
def binned_rows(monkeypatch):
    """The stream rows of every ``bin_sorted_stream`` call, in order."""
    rows = []
    binned = RS.bin_sorted_stream

    def spy(*a, **kw):
        out = binned(*a, **kw)
        rows.append(out[0].shape[0])
        return out

    monkeypatch.setattr(RS, "bin_sorted_stream", spy)
    return rows


def _render(rdr, scene, timing=None):
    pcd, cam = scene
    return rdr.render(pcd, None, cam, 45, background_color=1.0,
                      timing=timing)


def test_off_is_one_shared_no_op():
    assert trace._REC is None
    assert trace.span("gpcr.render") is trace.NO_SPAN
    assert trace.span("anything") is trace.NO_SPAN
    assert trace.request("cpu") is trace.NO_SPAN
    with trace.span("x") as got:
        assert got is None
    assert trace.count("voxels", 3) is None
    with trace.recording() as rec:
        assert trace.span("a") is not trace.NO_SPAN
    assert trace._REC is None  # the recording ended with its block
    assert rec.spans == [] and rec.counters == {}
    with trace.span("after"):
        trace.count("after", 1)
    assert rec.spans == [] and rec.counters == {}


@pytest.mark.parametrize("kind", ["learned", "analytic"])
def test_outputs_equal_with_tracing_on_and_off(scene, kind):
    rdr = _renderer(kind)
    off = _render(rdr, scene)
    with trace.recording() as rec:
        on = _render(rdr, scene)
    assert rec.spans
    assert off.keys() == on.keys()
    for k, v in off.items():
        if v is None:
            assert on[k] is None
        else:
            assert torch.equal(v, on[k]), k


@pytest.mark.parametrize("kind", ["learned", "analytic"])
def test_span_tree(scene, kind):
    rdr = _renderer(kind)
    with trace.recording() as rec:
        _render(rdr, scene)
        _render(rdr, scene)
    spans = rec.spans
    roots = [i for i, s in enumerate(spans) if s.parent < 0]
    assert [spans[i].name for i in roots] == ["gpcr.render"] * 2
    assert [spans[i].request for i in roots] == [0, 1]
    assert rec.requests == 2

    def children(i):
        return [j for j, s in enumerate(spans) if s.parent == i]

    for i, s in enumerate(spans):
        assert s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
            assert s.request == p.request
        else:
            assert s.request is not None
    encode = (["gpcr.encode"] * 2 if kind == "learned" else [])
    for r in roots:
        names = [spans[j].name for j in children(r)]
        assert names == (encode + ["gpcr.splats"]
                         + ["gpcr.raster.view"] * VIEWS
                         + ["gpcr.raster.resize", "gpcr.finish"])
        for j in children(r):
            sub = [spans[k].name for k in children(j)]
            if spans[j].name == "gpcr.raster.view":
                assert sub == VIEW_CHILDREN
            elif spans[j].name == "gpcr.encode":
                assert sub == ["gpcr.encode.quantize", "gpcr.encode.plan",
                               "gpcr.encode.unet", "gpcr.encode.head"]
            else:
                assert sub == []


def test_learned_counters(scene, binned_rows):
    rdr = _renderer("learned")
    rows = binned_rows
    timings = [{}, {}]
    with trace.recording() as rec:
        _render(rdr, scene, timings[0])
        _render(rdr, scene, timings[1])
        _, grid, _ = rdr.encode(scene[0])  # outside a request
    assert len(rows) == 2 * VIEWS
    first, second = rec.counters[0], rec.counters[1]
    outside = rec.counters[None]
    assert outside == {"voxels": grid.num, "plan_hits": 1}
    # the first request builds the plan (its warm encode) and then hits it
    assert first["plan_builds"] == 1 and first["plan_hits"] == 1
    assert "plan_builds" not in second and second["plan_hits"] == 2
    for c, t, r in ((first, timings[0], rows[:VIEWS]),
                    (second, timings[1], rows[VIEWS:])):
        assert c["voxels"] == 2 * grid.num  # two encodes per request
        assert c["entries"] == sum(r)
        assert c["entries_dropped"] == t["dup_overflow"]
        assert 0 < c["tiles_rendered"] <= VIEWS * (64 // 16) ** 2
        assert "device_allocs" not in c  # counted on a CUDA device only
        assert "bin_kernel_views" not in c  # the CPU bins plainly
        assert "prep_kernel_views" not in c  # and preprocesses plainly


def test_analytic_counters(scene, binned_rows):
    rdr = _renderer("analytic")
    rows = binned_rows
    timing = {}
    with trace.recording() as rec:
        _render(rdr, scene, timing)
    c = rec.counters[0]
    assert c["entries"] == sum(rows) and len(rows) == VIEWS
    assert c["entries_dropped"] == timing["dup_overflow"] > 0
    assert c["tiles_rendered"] == VIEWS * 3  # max_active_tiles per view
    assert "voxels" not in c and "plan_builds" not in c
    assert "bin_kernel_views" not in c  # the CPU bins plainly
    assert "prep_kernel_views" not in c  # and preprocesses plainly


def test_render_span_on_the_profiler_clock(scene):
    """The recorder's gpcr.render, mapped onto the profiler's time base,
    agrees with the profiler's range of that name (the span enters it)."""
    from torch.profiler import ProfilerActivity, profile

    rdr = _renderer("analytic")
    with trace.recording() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):  # the first range pays the profiler's warm-up
            _render(rdr, scene)
    shift = rec.trace_shift_ns(prof)
    ours = [s for s in rec.spans if s.name == "gpcr.render"]
    theirs = sorted((e for e in prof.events() if e.name == "gpcr.render"),
                    key=lambda e: e.time_range.start)
    assert len(ours) == len(theirs) == 3
    s, e = ours[-1], theirs[-1]
    assert abs(e.time_range.start - (s.start_ns + shift) / 1e3) < 100
    assert abs(e.time_range.end - (s.end_ns + shift) / 1e3) < 100
    table = rec.attribute(prof)  # no device activity on the CPU
    assert table["spans"]["gpcr.render"]["count"] == 3
    assert table["device_ms"] == 0 and table["launch_records"] == 0


def test_a_clock_mapping_that_misses_raises():
    """A profiler whose start does not land on its trace's start through
    the wall-clock offset is refused, not placed on a guessed offset."""
    from torch.profiler import ProfilerActivity, profile

    with trace.recording() as rec, profile(
            activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(3).sum()
    rec.trace_shift_ns(prof)  # the true offset maps
    rec._wall_minus_perf += 2 * 10**9
    with pytest.raises(ValueError, match="2.0"):
        rec.trace_shift_ns(prof)


# hand-made intervals (us): a root r with children a and b, b holding c,
# then a second root
SPANS = [("r", 0, 100, -1), ("a", 10, 40, 0), ("b", 50, 90, 0),
         ("c", 60, 70, 2), ("r", 120, 150, -1)]


def test_innermost_segments():
    assert trace.innermost(SPANS) == [
        (0, 10, 0), (10, 40, 1), (40, 50, 0), (50, 60, 2), (60, 70, 3),
        (70, 90, 2), (90, 100, 0), (100, 120, -1), (120, 150, 4)]


@pytest.mark.parametrize("case", ["kernels", "idle"])
def test_attribution_to_nested_spans(case):
    # (start, end, launch): the launch decides the span, not the device
    # time, which may fall after the span ended
    device = [(5, 15, 1), (20, 30, 12), (45, 55, 65), (95, 130, 125),
              (140, 141, None)]
    got = trace.by_span(SPANS, device)
    rows = got["spans"]
    if case == "kernels":
        assert got["device_ms"] == pytest.approx(0.066)
        assert got["placed_ms"] == pytest.approx(0.065)
        assert rows["c"]["device_ms"] == pytest.approx(0.010)  # launched at 65
        assert rows["b"]["device_ms"] == pytest.approx(0.010)  # c's, inside b
        assert rows["a"]["device_ms"] == pytest.approx(0.010)
        assert rows["r"]["device_ms"] == pytest.approx(0.065)  # both roots
        assert rows[trace.OUTSIDE]["device_ms"] == pytest.approx(0.001)
        assert rows["r"]["count"] == 2
        assert rows["r"]["host_ms"] == pytest.approx(0.130)
    else:
        # idle: [0,5] r, [15,20] a, [30,40] a + [40,45] r,
        # [55,60] b + [60,70] c + [70,90] b + [90,95] r, [130,140] and
        # [141,150] the second r; [100,120] is busy (95-130)
        assert got["idle_ms"] == pytest.approx(0.084)
        assert rows["a"]["self_idle_ms"] == pytest.approx(0.015)
        assert rows["c"]["self_idle_ms"] == pytest.approx(0.010)
        assert rows["b"]["self_idle_ms"] == pytest.approx(0.025)
        assert rows["b"]["idle_ms"] == pytest.approx(0.035)
        assert rows["r"]["self_idle_ms"] == pytest.approx(0.015 + 0.019)
        assert rows["r"]["idle_ms"] == pytest.approx(0.084)
        assert got["idle_in_root_ms"] == pytest.approx(0.084)
        assert got["idle_under_child_ms"] == pytest.approx(0.050)
        assert rows[trace.OUTSIDE]["idle_ms"] == 0.0


def test_idle_between_roots_is_outside_every_span():
    spans = [("r", 0, 10, -1), ("r", 20, 30, -1)]
    got = trace.by_span(spans, [(0, 10, 1), (25, 30, 21)])
    assert got["spans"][trace.OUTSIDE]["idle_ms"] == pytest.approx(0.010)
    assert got["spans"]["r"]["idle_ms"] == pytest.approx(0.005)
    assert got["idle_in_root_ms"] == pytest.approx(0.005)
    assert got["idle_under_child_ms"] == 0.0
