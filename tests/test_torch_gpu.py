"""The port's CUDA kernels on the card (``gpu`` marker): the serving
stream blend (with its warp-level culling), the contributor-count
forward and the aligned all-tiles blend (both walking a chunk ring), the
replay backward (tiles split into segments); the binning kernels
(``csrc/bin_stream.cu``, bit-equal to ``bin_sorted_stream_plain``); the
preprocess kernel (``csrc/preprocess.cu``, bit-equal to
``fuse_view_features`` and ``preprocess``); the
U-Net's sparse convolution (``csrc/sparse_conv.cu``, its own tolerance
below); and the
data path's torch
ops on the card against the CPU (voxel downsampling, outlier removal,
RGBD unprojection, segment max / min, the surfel z-buffer, the k nearest
points to rays, sparse trilinear interpolation and pruning); and the
end-to-end forward entry (``gpcr_tpu_torch/entry.py``) against the CPU.

Each test skips without a CUDA device; the decision is taken inside the
``cuda`` fixture, never at import. The file imports no JAX, so it also
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` because tests/conftest.py configures JAX.)

Tolerance: forward kernels vs their plain PyTorch version at max 1e-4 /
mean 1e-6 (every alpha and transmittance is the same float32 value in
both, only the per-channel accumulation order differs) and equal
contributor counts; the replay backward per gradient column at
1e-4 * max|plain| + 1e-6 and ||d||_2 <= 1e-5 * ||plain||_2 + 1e-6
(1 / (1 - a) amplifies rounding along a range and the sums run in another
order; the second limit holds the typical row, the first the worst); card vs CPU gradients of a whole scene at
1e-3 of each input's largest gradient.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpcr_tpu_torch.ops import preprocess as TP
from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import rasterize_aligned as TRA
from gpcr_tpu_torch.ops import rasterize_stream as TRS
from gpcr_tpu_torch.ops import rasterize_stream_vjp as TV
from gpcr_tpu_torch.render.renderer import pin_fp32
from gpcr_tpu_torch.structures.camera import derive_camera_intrinsics
from gpcr_tpu_torch.utils import rigid_motion as TRM

from torch_streams import (aligned_layout, preprocess_scene, ring_tiles,
                           tile_stream)

pin_fp32()  # parity precision: full-float32 matmuls, no TF32 on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend kernel runs only there")
    return torch.device("cuda")


def _scene(dev, channels, n=3000, seed=7, res=128, overdraw=False):
    """Seeded scene (tests/test_torch_stream.py's, larger) on ``dev``:
    (means, opacity, settings, keyword arguments of the rasterizer). With
    ``overdraw`` the gaussians are wide and nearly opaque, so most pixels
    end their walk early."""
    rng = np.random.RandomState(seed)
    means = (rng.randn(n, 3) * 0.3 + np.array([0, 0, 2.5])).astype(np.float32)
    scales = (rng.rand(n, 3) * 0.05 + 0.01).astype(np.float32)
    rots = rng.randn(n, 4).astype(np.float32)
    op = rng.rand(n).astype(np.float32)
    if overdraw:
        scales, op = scales * 4.0, op * 0.1 + 0.9
    feats = rng.rand(n, channels).astype(np.float32)
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = 1.0
    P[3, 2] = 1.0
    P[2, 2] = 100.0 / (100.0 - 0.01)
    P[2, 3] = -(100.0 * 0.01) / (100.0 - 0.01)
    settings = TR.GaussianRasterizationSettings(
        image_height=res, image_width=res, tanfovx=1.0, tanfovy=1.0,
        bg=torch.full((channels,), 0.7, device=dev), scale_modifier=1.0,
        viewmatrix=torch.eye(4, device=dev),
        projmatrix=torch.from_numpy(P.T.copy()).to(dev), sh_degree=0,
        campos=torch.zeros(3, device=dev))

    def t(x):
        return torch.from_numpy(x).to(dev)

    return t(means), t(op), settings, dict(
        scales=t(scales), rotations=t(rots), colors_precomp=t(feats))


def _binned(dev, channels, config, n=3000, seed=7, res=128):
    """The seeded scene preprocessed and binned on ``dev``; returns
    (stream, starts, order, tiles, grid_x)."""
    means, op, settings, kw = _scene(dev, channels, n, seed, res)
    prep = TR.preprocess(means, op, settings, config, **kw)
    grid_x = res // 16
    num_tiles = grid_x * grid_x
    stream, starts, _ = TRS.bin_sorted_stream(prep, num_tiles, grid_x, config)
    counts = starts[1:] - starts[:-1]
    order = torch.argsort(-counts, stable=True).to(torch.int32)
    return stream, starts, order, num_tiles, grid_x


@pytest.mark.gpu
@pytest.mark.parametrize("max_active_tiles", [None, 8])
@pytest.mark.parametrize("channels", [9, 12])
@pytest.mark.parametrize("downscale", [1, 2])
def test_cuda_kernel_matches_plain(cuda, downscale, channels,
                                   max_active_tiles):
    config = TR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=64,
                                downscale=downscale, opacity_radius=True)
    stream, starts, order, nt, gx = _binned(cuda, channels, config)
    order = order[:max_active_tiles or nt].contiguous()
    before = TRS.LAUNCHES
    acc, t = TRS.blend_tiles(stream, starts, order, nt, gx, channels, config)
    torch.cuda.synchronize()
    assert TRS.LAUNCHES == before + 1
    acc_p, t_p = TRS.blend_tiles_plain(stream, starts, order, nt, gx,
                                       channels, config)
    p_out = 256 // downscale ** 2
    assert acc.shape == (nt, p_out, channels) and t.shape == (nt, p_out)
    for got, ref in ((acc, acc_p), (t, t_p)):
        err = (got - ref).abs()
        assert float(err.max()) <= 1e-4 and float(err.mean()) <= 1e-6
    if max_active_tiles:
        # tiles left out of the order keep acc 0 and T 1
        skipped = torch.ones(nt, dtype=torch.bool, device=cuda)
        skipped[order.long()] = False
        assert bool((acc[skipped] == 0).all()) and bool((t[skipped] == 1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("scene", ["overdrawn", "block_edges", "faint"])
@pytest.mark.parametrize("channels", [3, 9, 12])
def test_serving_kernel_culls_only_skipped_pairs(cuda, channels, scene,
                                                  downscale):
    """The serving kernel's warp-level culling on streams built to test
    it: over-drawn tiles (wide, nearly opaque splats: pixels stop in the
    middle of a chunk), means on the 8x4 warp-block edges, and opacities
    a hair above 1/255. The output is the plain version's."""
    kw = {"overdrawn": dict(sigma=(3.0, 10.0), opaque=0.8),
          "block_edges": dict(sigma=(0.4, 3.0), edges=True),
          "faint": dict(sigma=(0.5, 8.0), faint=True, edges=True)}[scene]
    counts = [0, 1, 37, 300, 700, 1500]
    stream, starts = tile_stream(counts, seed=channels, channels=channels,
                                 **kw)
    stream, starts = stream.to(cuda), starts.to(cuda)
    nt, gx = len(counts), 3
    order = torch.argsort(-(starts[1:] - starts[:-1]), stable=True).to(
        torch.int32)
    config = TR.RasterizeConfig(chunk_size=64, downscale=downscale)
    before = TRS.LAUNCHES
    acc, t = TRS.blend_tiles(stream, starts, order, nt, gx, channels, config)
    torch.cuda.synchronize()
    assert TRS.LAUNCHES == before + 1
    acc_p, t_p = TRS.blend_tiles_plain(stream, starts, order, nt, gx,
                                       channels, config)
    for got, ref in ((acc, acc_p), (t, t_p)):
        err = (got - ref).abs()
        assert float(err.max()) <= 1e-4 and float(err.mean()) <= 1e-6
    if scene == "overdrawn":
        _, _, cnt = TRS.blend_tiles_plain(
            stream, starts, order, nt, gx, channels,
            config._replace(downscale=1), with_contrib=True)
        stopped = cnt < (starts[1:] - starts[:-1])[:, None]
        assert float(stopped[3:].float().mean()) > 0.5
        assert bool((cnt[3:] % 64 != 0).any())  # mid-chunk
    # the predicate culls something on these streams
    rows = stream[int(starts[5]):int(starts[6])].cpu()
    assert not bool(TRS.block_mask_plain(rows, 32.0, 16.0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [3, 12])
@pytest.mark.parametrize("downscale", [1, 2])
def test_windowed_kernel_matches_plain(cuda, downscale, channels):
    """Every window of a 4-way split of the tile grid (the tile-sharded
    path): the kernel with ``tile_base`` against the windowed plain
    version (max 1e-4 / mean 1e-6), and the windows assembled give the
    unwindowed kernel's bits."""
    from gpcr_tpu_torch.parallel.render import window_of

    config = TR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=64,
                                downscale=downscale, opacity_radius=True)
    means, op, settings, kw = _scene(cuda, channels, res=144)  # 81 tiles
    prep = TR.preprocess(means, op, settings, config, **kw)
    gx = 9
    nt = gx * gx
    acc, t, _ = TRS.blend_stream(prep, None, nt, gx, config, channels)
    parts, filled = [], 0
    for d in range(4):
        base, count = window_of(nt, 4, d)
        stream, starts, ovf = TRS.bin_sorted_stream(
            prep, nt, gx, config, tile_window=(base, count))
        order, _ = TRS.render_order(starts, ovf, count, config)
        before = TRS.LAUNCHES
        got = TRS.blend_tiles(stream, starts, order, count, gx, channels,
                              config, tile_base=base)
        torch.cuda.synchronize()
        assert TRS.LAUNCHES == before + 1
        ref = TRS.blend_tiles_plain(stream, starts, order, count, gx,
                                    channels, config, tile_base=base)
        for g, r in zip(got, ref):
            err = (g - r).abs()
            assert float(err.max()) <= 1e-4 and float(err.mean()) <= 1e-6
        parts.append(got)
        filled += int(starts[-1]) > 0
    assert filled >= 3  # the scene spans the windows
    assert torch.equal(torch.cat([p[0] for p in parts])[:nt], acc)
    assert torch.equal(torch.cat([p[1] for p in parts])[:nt], t)


# binning on csrc/bin_stream.cu against bin_sorted_stream_plain: (dup cap,
# raster side, k_budget, tile window, share of splats kept valid). 128 px
# is 64 tiles; 1024 and 2048 px the learned and the analytic cells' 4,096
# and 16,384; 200 px an odd 169; at 320 px ~150 of the 3,000 splats span
# more than 256 tiles.
BIN_CASES = {
    "cap4": (4, 128, None, None, 0.8),
    "cap256_over": (256, 320, None, None, 0.8),
    "k_budget_cut": (16, 128, 1000, None, 0.8),
    "window": (16, 144, None, (20, 27), 0.8),
    "window_k_budget_cut": (16, 144, 300, (20, 27), 0.8),
    "tiles_4096": (16, 1024, None, None, 0.8),
    "tiles_16384": (4, 2048, 1_800_000, None, 0.8),
    "tiles_odd": (16, 200, None, None, 0.8),
    "nothing_emits": (16, 128, None, None, 0.0),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(BIN_CASES))
@pytest.mark.parametrize("channels", [3, 9, 12])
def test_binning_kernels_match_plain(cuda, case, channels):
    """The kernel binning gives the plain version's stream, starts,
    overflow, sorted ranks and presort permutation bit for bit, and
    ``LAUNCHES_BIN`` counts the call."""
    cap, res, k_budget, window, keep = BIN_CASES[case]
    config = TR.RasterizeConfig(max_dup_per_gaussian=cap, chunk_size=64,
                                k_budget=k_budget, opacity_radius=True)
    means, op, settings, kw = _scene(cuda, channels, res=res)
    valid = torch.from_numpy(
        np.random.RandomState(channels).rand(means.shape[0]) < keep)
    prep = TR.preprocess(means, op, settings, config,
                         valid_mask=valid.to(cuda), **kw)
    gx = -(-res // 16)
    nt = gx * gx
    before = TRS.LAUNCHES_BIN
    got = TRS.bin_sorted_stream(prep, nt, gx, config, return_entries=True,
                                tile_window=window)
    torch.cuda.synchronize()
    assert TRS.LAUNCHES_BIN == before + 1
    ref = TRS.bin_sorted_stream_plain(prep, nt, gx, config,
                                      return_entries=True, tile_window=window)
    assert TRS.LAUNCHES_BIN == before + 1
    stream, starts, ovf, ranks, gidx_s = got
    assert stream.dtype == torch.float32 and stream.is_contiguous()
    assert starts.dtype == torch.int32 and ranks.dtype == torch.int64
    assert torch.equal(stream.view(torch.int32), ref[0].view(torch.int32))
    for g, r in zip(got[1:], ref[1:]):
        assert g.dtype == r.dtype and torch.equal(g, r)
    # each case reaches what it is named for
    emitted = int(TR.entry_count(prep, config))
    if case == "nothing_emits":
        assert stream.shape[0] == 0 and emitted == 0
    else:
        assert stream.shape[0] > 0
    if case == "cap256_over":
        assert int(ovf) > 0
    if case == "k_budget_cut":
        assert emitted > stream.shape[0] == 1024
    if case == "window_k_budget_cut":
        assert int(starts[-1]) == stream.shape[0] == 320  # 300 in chunks
    if case == "tiles_16384":
        assert stream.shape[0] == emitted  # the budget cuts nothing


def _recorded_request(cuda, kind, views):
    """One request of a learned ring (dup cap 256, opacity-aware rects) or
    an analytic orbit (dup cap 4) of ``views`` 32² views of a 3,000-point
    cloud on the card, under ``trace.recording()``: the recorder."""
    from gpcr_tpu_torch.cli.profile_pcrender import (LEARNED_INFO,
                                                     synthetic_cloud)
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.structures.pointcloud import PointCloud
    from gpcr_tpu_torch.utils import trace

    xyz, rgb = synthetic_cloud(3000)
    pcd = PointCloud.from_numpy(xyz, rgb, device=cuda)
    cam = RD.generate_cam({"fov": 45, "width_px": 32, "height_px": 32,
                           "mode": "circle", "n_imgs": views, "d": 0,
                           "r": 3, "center_angles": [90, 0]}, device=cuda)
    if kind == "learned":
        rdr = RD.PCMLRender(
            info=dict(LEARNED_INFO, clr_encoder_channels="9 8 8 8 8 8"),
            voxelized=True, scale_factor=448, device=str(cuda),
            config=TR.RasterizeConfig(max_dup_per_gaussian=256,
                                      chunk_size=256, opacity_radius=True))
    else:
        rdr = RD.SimpleRender(voxelized=True, scale_factor=448,
                              config=TR.RasterizeConfig(
                                  max_dup_per_gaussian=4, chunk_size=256))
    with trace.recording() as rec:
        rdr.render(pcd, None, cam, 45, background_color=1.0)
        torch.cuda.synchronize()
    return rec


@pytest.mark.gpu
@pytest.mark.parametrize("kind,views", [("learned", 12), ("analytic", 16)])
def test_every_view_of_a_request_bins_on_the_kernels(cuda, kind, views):
    """A request of a learned ring (12 views) and of an analytic orbit
    (16 views), recorded: ``LAUNCHES_BIN`` and the request's
    ``bin_kernel_views`` counter both count every view."""
    before = TRS.LAUNCHES_BIN
    rec = _recorded_request(cuda, kind, views)
    assert TRS.LAUNCHES_BIN == before + views
    assert {r: c["bin_kernel_views"] for r, c in rec.counters.items()
            if "bin_kernel_views" in c} == {0: views}


@pytest.mark.gpu
@pytest.mark.parametrize("kind,views", [("learned", 12), ("analytic", 16)])
def test_every_view_of_a_request_preprocesses_on_the_kernel(cuda, kind,
                                                            views):
    """The same requests: ``LAUNCHES_PREP`` and the request's
    ``prep_kernel_views`` counter both count every view."""
    before = TP.LAUNCHES_PREP
    rec = _recorded_request(cuda, kind, views)
    assert TP.LAUNCHES_PREP == before + views
    assert {r: c["prep_kernel_views"] for r, c in rec.counters.items()
            if "prep_kernel_views" in c} == {0: views}


def _float_bits_equal(got, ref):
    """Bit for bit, a NaN equal to a NaN."""
    got, ref = got.contiguous(), ref.contiguous()
    same = got.view(torch.int32) == ref.view(torch.int32)
    return bool((same | (torch.isnan(got) & torch.isnan(ref))).all())


@pytest.mark.gpu
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("layout", ["learned", "analytic"])
def test_preprocess_kernel_matches_plain(cuda, layout, degree):
    """``preprocess_view`` on ``csrc/preprocess.cu`` gives every field of
    ``fuse_view_features`` + ``preprocess`` on the card bit for bit, on
    scenes that hold each case the kernel decides (``preprocess_scene``),
    and ``LAUNCHES_PREP`` counts the launch."""
    (settings, means, scales, rots, op, shs, normal, valid, config,
     with_normal) = preprocess_scene(layout, degree, cuda)
    before = TP.LAUNCHES_PREP
    with torch.no_grad():
        got = TP.preprocess_view(settings, means, scales, rots, op, shs,
                                 normal, valid, config, with_normal)
        torch.cuda.synchronize()
        assert TP.LAUNCHES_PREP == before + 1
        feats = TP.fuse_view_features(settings.campos, means, shs, normal,
                                      degree, with_normal)
        ref = TR.preprocess(means, op, settings, config, scales=scales,
                            rotations=rots, colors_precomp=feats,
                            valid_mask=valid)
    assert TP.LAUNCHES_PREP == before + 1
    assert got.features.shape == (means.shape[0], 12 if with_normal else 9)
    for name in ("valid", "rect"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    for name in ("depth", "mean2d", "conic", "radius", "features",
                 "opacity"):
        assert _float_bits_equal(getattr(got, name), getattr(ref, name)), name
    # each case the scene is built for is reached
    depth, rect, radius = ref.depth, ref.rect, ref.radius
    assert bool((depth <= 0.2).any())  # behind the near plane
    assert bool(((rect[:, 2] == rect[:, 0]) & (depth > 0.2)).any())
    assert not bool(valid.all())
    # the rank-one splat: det 0, so det_inv 1 and no radius
    assert not bool(ref.valid[-1]) and float(ref.conic[-1, 0]) > 1e6
    assert float(radius[-1]) == 0.0 and float(depth[-1]) > 0.2
    if config.opacity_radius:  # opacity <= 1/255: binned nowhere, reported
        assert bool((~ref.valid & (radius > 0)).any())
    assert bool(ref.valid.sum() > means.shape[0] // 2)


@pytest.mark.gpu
def test_a_gradient_keeps_the_plain_preprocess(cuda):
    """The dispatch on the card: inputs that require a gradient, under
    autograd, and ``config.differentiable`` take the plain ops (the
    features record a gradient, no launch); the same inputs under
    ``no_grad`` launch the kernel."""
    (settings, means, scales, rots, op, shs, normal, valid, config,
     with_normal) = preprocess_scene("learned", 1, cuda, n=500)
    shs.requires_grad_(True)
    args = (settings, means, scales, rots, op, shs, normal, valid)
    before = TP.LAUNCHES_PREP
    prep = TP.preprocess_view(*args, config, with_normal)
    assert prep.features.requires_grad and TP.LAUNCHES_PREP == before
    prep.features[:, :3].sum().backward()
    assert float(shs.grad.abs().sum()) > 0
    with torch.no_grad():
        TP.preprocess_view(*args, config._replace(differentiable=True),
                           with_normal)
        assert TP.LAUNCHES_PREP == before
        TP.preprocess_view(*args, config, with_normal)
    assert TP.LAUNCHES_PREP == before + 1


@pytest.mark.gpu
def test_refused_preprocess_launch_raises(cuda):
    """A launch the library refuses (an SH degree above 4) raises instead
    of returning the empty outputs, and a float64 input raises before the
    launch; neither counts."""
    (settings, means, scales, rots, op, shs, normal, valid, config,
     with_normal) = preprocess_scene("learned", 4, cuda, n=500)
    shs = torch.cat([shs, shs], dim=1)  # 50 coefficients: enough for 6
    before = TP.LAUNCHES_PREP
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="preprocess launch failed"):
            TP.preprocess_view(settings._replace(sh_degree=5), means, scales,
                               rots, op, shs, normal, valid, config,
                               with_normal)
        with pytest.raises(TypeError):
            TP.preprocess_view(settings, means.double(), scales, rots, op,
                               shs, normal, valid, config, with_normal)
    assert TP.LAUNCHES_PREP == before


@pytest.mark.gpu
def test_refused_launch_raises(cuda):
    """A launch the card refuses (here: more shared memory than an SM
    has) raises instead of returning the untouched outputs."""
    config = TR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=64)
    stream, starts, order, nt, gx = _binned(cuda, 12, config, n=500)
    before = TRS.LAUNCHES
    huge = config._replace(chunk_size=1 << 14)  # 16K rows x 20 cols x 4 B
    with pytest.raises(RuntimeError, match="stream_blend launch failed"):
        TRS.blend_tiles(stream, starts, order, nt, gx, 12, huge)
    assert TRS.LAUNCHES == before
    with pytest.raises(TypeError):
        TRS.blend_tiles(stream.double(), starts, order, nt, gx, 12, config)


@pytest.mark.gpu
@pytest.mark.parametrize("max_active_tiles", [None, 8])
@pytest.mark.parametrize("channels", [3, 12])
def test_cuda_training_kernels_match_plain(cuda, channels, max_active_tiles):
    """Kernel A's count equals the plain version's; kernel B's rows are
    within the stated tolerance, with a non-uniform dL/dout and a non-zero
    upstream of T."""
    config = TR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=32)
    stream, starts, order, nt, gx = _binned(cuda, channels, config)
    order = order[:max_active_tiles or nt].contiguous()
    args = (stream, starts, order, nt, gx, channels, config)
    before = (TRS.LAUNCHES, TRS.LAUNCHES_CONTRIB, TV.LAUNCHES_BWD)
    acc, t, cnt = TRS.blend_tiles(*args, with_contrib=True)
    torch.cuda.synchronize()
    acc_p, t_p, cnt_p = TRS.blend_tiles_plain(*args, with_contrib=True)
    assert cnt.dtype == torch.int32 and cnt.shape == (nt, 256)
    assert torch.equal(cnt, cnt_p)
    counts = (starts[1:] - starts[:-1])[:, None]
    assert bool((cnt <= counts).all()) and bool((cnt < counts).any())
    for got, ref in ((acc, acc_p), (t, t_p)):
        err = (got - ref).abs()
        assert float(err.max()) <= 1e-4 and float(err.mean()) <= 1e-6

    g = torch.Generator().manual_seed(channels)
    dl_dout = torch.randn(nt, 256, channels, generator=g).to(cuda)
    dt_tot = torch.randn(nt, 256, generator=g).to(cuda)
    bargs = (stream, starts, order, dl_dout, cnt, dt_tot, t, gx, channels,
             config)
    rows = TV.blend_tiles_bwd(*bargs)
    torch.cuda.synchronize()
    assert (TRS.LAUNCHES, TRS.LAUNCHES_CONTRIB, TV.LAUNCHES_BWD) == (
        before[0], before[1] + 1, before[2] + 1)
    rows_p = TV.blend_tiles_bwd_plain(*bargs)
    assert rows.shape == stream.shape
    col_err = (rows - rows_p).abs().amax(dim=0)
    col_lim = 1e-4 * rows_p.abs().amax(dim=0) + 1e-6
    assert bool((col_err <= col_lim).all()), (col_err, col_lim)
    # and over all rows, so an error on the typical row cannot hide behind
    # the column's largest entry
    l2_err = torch.linalg.vector_norm((rows - rows_p).double(), dim=0)
    l2_lim = 1e-5 * torch.linalg.vector_norm(rows_p.double(), dim=0) + 1e-6
    assert bool((l2_err <= l2_lim).all()), (l2_err, l2_lim)
    # the plain version's live count: some walked positions are skipped
    live = TRS.blend_tiles_plain(*args, with_contrib=True, with_live=True)[3]
    assert bool((live <= cnt).all()) and 0 < int(live.sum()) < int(cnt.sum())
    used = [0, 1, 2, 3, 4, 5] + list(range(8, 8 + channels))
    assert float(rows_p[:, used].abs().amax(dim=0).min()) > 0
    assert not bool(rows[:, 6:8].any())
    # deterministic: no atomics, so a second launch gives the same bits
    assert torch.equal(rows, TV.blend_tiles_bwd(*bargs))
    if max_active_tiles:
        skipped = torch.ones(nt, dtype=torch.bool, device=cuda)
        skipped[order.long()] = False
        assert not bool(cnt[skipped].any())
        s, e = starts[:-1][skipped], starts[1:][skipped]
        for a, b in zip(s.tolist(), e.tolist()):
            assert not bool(rows[a:b].any())


@pytest.mark.gpu
@pytest.mark.parametrize("channels", [3, 9, 12])
def test_replay_backward_segments_match_plain(cuda, channels):
    """Tile ranges around the replay kernel's segment length (chunk 64:
    segments of 128 entries): 0, 1, 127, 128, 129, 256, 257 and 1,000
    entries; over-drawn, so pixels stop in the first segment and later.
    Rows within the replay limits of the plain version, bit-equal on two
    launches, zero past each tile's walked range; the count forward's
    counts and outputs equal the plain version's."""
    counts = [0, 1, 127, 128, 129, 256, 257, 1000, 300]
    stream, starts = tile_stream(counts, seed=10 + channels,
                                 channels=channels, sigma=(2.0, 8.0))
    stream, starts = stream.to(cuda), starts.to(cuda)
    nt, gx = len(counts), 3
    order = torch.argsort(-(starts[1:] - starts[:-1]), stable=True).to(
        torch.int32)
    config = TR.RasterizeConfig(chunk_size=64)
    args = (stream, starts, order, nt, gx, channels, config)
    acc, t, cnt = TRS.blend_tiles(*args, with_contrib=True)
    acc_p, t_p, cnt_p = TRS.blend_tiles_plain(*args, with_contrib=True)
    assert torch.equal(cnt, cnt_p)
    for got, ref in ((acc, acc_p), (t, t_p)):
        err = (got - ref).abs()
        assert float(err.max()) <= 1e-4 and float(err.mean()) <= 1e-6
    lens = (starts[1:] - starts[:-1])[:, None]
    assert bool(((cnt > 0) & (cnt < 128)).any()) and bool((cnt == lens).any())
    g = torch.Generator().manual_seed(channels)
    dl_dout = torch.randn(nt, 256, channels, generator=g).to(cuda)
    dt_tot = torch.randn(nt, 256, generator=g).to(cuda)
    bargs = (stream, starts, order, dl_dout, cnt, dt_tot, t, gx, channels,
             config)
    before = TV.LAUNCHES_BWD
    rows = TV.blend_tiles_bwd(*bargs)
    again = TV.blend_tiles_bwd(*bargs)
    torch.cuda.synchronize()
    assert TV.LAUNCHES_BWD == before + 2
    assert torch.equal(rows, again)
    rows_p = TV.blend_tiles_bwd_plain(*bargs)
    col_err = (rows - rows_p).abs().amax(dim=0)
    assert bool((col_err <= 1e-4 * rows_p.abs().amax(dim=0) + 1e-6).all()), (
        col_err, rows_p.abs().amax(dim=0))
    l2_err = torch.linalg.vector_norm((rows - rows_p).double(), dim=0)
    l2_lim = 1e-5 * torch.linalg.vector_norm(rows_p.double(), dim=0) + 1e-6
    assert bool((l2_err <= l2_lim).all()), (l2_err, l2_lim)
    walked = torch.minimum(lens[:, 0], cnt.amax(dim=1))
    for tile in range(nt):
        s, e = int(starts[tile]), int(starts[tile + 1])
        assert not bool(rows[s + int(walked[tile]):e].any())


@pytest.mark.gpu
def test_gradients_on_the_card_match_the_cpu_path(cuda):
    config = TR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=64,
                                differentiable=True)
    rng = np.random.RandomState(3)
    n, res = 800, 64
    arrays = [
        (rng.randn(n, 3) * 0.3 + np.array([0, 0, 2.5])).astype(np.float32),
        (rng.rand(n, 3) * 0.05 + 0.01).astype(np.float32),
        rng.randn(n, 4).astype(np.float32),
        rng.rand(n).astype(np.float32),
        rng.rand(n, 12).astype(np.float32),
    ]
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = 1.0
    P[3, 2] = 1.0
    P[2, 2] = 100.0 / (100.0 - 0.01)
    P[2, 3] = -(100.0 * 0.01) / (100.0 - 0.01)
    grads = {}
    for dev in ("cpu", cuda):
        bg = torch.full((12,), 0.7, device=dev).requires_grad_(True)
        settings = TR.GaussianRasterizationSettings(
            image_height=res, image_width=res, tanfovx=1.0, tanfovy=1.0,
            bg=bg, scale_modifier=1.0, viewmatrix=torch.eye(4, device=dev),
            projmatrix=torch.from_numpy(P.T.copy()).to(dev), sh_degree=0,
            campos=torch.zeros(3, device=dev))
        leaves = [torch.from_numpy(a).to(dev).requires_grad_(True)
                  for a in arrays]
        m, s, q, o, f = leaves
        color, _, extra = TR.rasterize_gaussians(
            m, o, settings, scales=s, rotations=q, colors_precomp=f,
            config=config, return_extra=True)
        w = 0.5 + (torch.arange(color.numel(), device=dev).reshape(
            color.shape) % 7).to(torch.float32) / 7.0
        (torch.sum(color * w) + 0.3 * torch.sum(extra["final_T"])).backward()
        grads[str(dev)] = [x.grad.cpu() for x in leaves + [bg]]
    for c, g in zip(grads["cpu"], grads["cuda"]):
        assert float(c.abs().max()) > 0
        assert float((g - c).abs().max()) <= 1e-3 * float(c.abs().max())


@pytest.mark.gpu
def test_refused_backward_launch_raises(cuda):
    config = TR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=64)
    stream, starts, order, nt, gx = _binned(cuda, 12, config, n=500)
    _, t, cnt = TRS.blend_tiles(stream, starts, order, nt, gx, 12, config,
                                with_contrib=True)
    dl = torch.ones(nt, 256, 12, device=cuda)
    dt = torch.zeros(nt, 256, device=cuda)
    before = TV.LAUNCHES_BWD
    huge = config._replace(chunk_size=1 << 14)
    with pytest.raises(RuntimeError, match="stream_blend_bwd launch failed"):
        TV.blend_tiles_bwd(stream, starts, order, dl, cnt, dt, t, gx, 12, huge)
    assert TV.LAUNCHES_BWD == before
    with pytest.raises(TypeError):
        TV.blend_tiles_bwd(stream, starts, order, dl, cnt.float(), dt, t, gx,
                           12, config)
    with pytest.raises(ValueError, match="native resolution"):
        TRS.blend_tiles(stream, starts, order, nt, gx, 12,
                        config._replace(downscale=2), with_contrib=True)


# --------------------------------------------------------------------------
# the aligned all-tiles blend (csrc/aligned_blend.cu)
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("overdraw", [False, True])
@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("channels", [3, 9, 12])
def test_aligned_kernel_matches_plain(cuda, channels, chunk, overdraw):
    """acc and T of every tile, on an image whose sides are not multiples
    of 16; the over-drawn scene takes the block's early exit."""
    res = 120
    config = TR.RasterizeConfig(max_dup_per_gaussian=64, chunk_size=chunk)
    means, op, settings, kw = _scene(cuda, channels, res=res,
                                     overdraw=overdraw)
    prep = TR.preprocess(means, op, settings, config, **kw)
    gx = -(-res // 16)
    nt = gx * gx
    scal, feat, cstarts, _ = TRA.tile_bin_aligned(prep, nt, gx, config)
    args = (cstarts, scal, feat, nt, gx, channels, config)
    before = TRA.LAUNCHES
    acc, t = TRA.blend_aligned_tiles(*args)
    torch.cuda.synchronize()
    assert TRA.LAUNCHES == before + 1
    acc_p, t_p = TRA.blend_aligned_plain(*args)
    assert acc.shape == (nt, 256, channels) and t.shape == (nt, 256)
    for got, ref in ((acc, acc_p), (t, t_p)):
        err = (got - ref).abs()
        assert float(err.max()) <= 1e-4 and float(err.mean()) <= 1e-6
    assert float(acc_p.abs().max()) > 0.1
    if overdraw:
        # pixels that stopped before the end of their tile's chunks
        assert float((t_p < 1e-3).float().mean()) > 0.2
    empty = cstarts[1:] == cstarts[:-1]
    if bool(empty.any()):
        assert bool((acc[empty] == 0).all()) and bool((t[empty] == 1).all())


@pytest.mark.gpu
def test_aligned_route_matches_stream_route(cuda):
    """Both routes blend the same entries in the same order with the same
    float32 products: the images differ only by the order of the channel
    sums."""
    config = TR.RasterizeConfig(max_dup_per_gaussian=64, chunk_size=128)
    means, op, settings, kw = _scene(cuda, 12, res=120)
    before = TRA.LAUNCHES
    got, radii = TRA.rasterize_gaussians_aligned(means, op, settings,
                                                 config=config, **kw)
    assert TRA.LAUNCHES == before + 1
    ref, ref_radii = TRS.rasterize_gaussians_stream(means, op, settings,
                                                    config=config, **kw)
    assert got.shape == (12, 120, 120) and torch.equal(radii, ref_radii)
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.gpu
def test_refused_aligned_launch_raises(cuda):
    config = TR.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=64)
    means, op, settings, kw = _scene(cuda, 12, n=500)
    prep = TR.preprocess(means, op, settings, config, **kw)
    scal, feat, cstarts, _ = TRA.tile_bin_aligned(prep, 64, 8, config)
    before = TRA.LAUNCHES
    # 16K slots x 18 rows x 4 B of shared memory: more than an SM has
    huge = config._replace(chunk_size=1 << 14)
    wide = torch.zeros(1, 6, 1 << 14, device=cuda)
    with pytest.raises(RuntimeError, match="aligned_blend launch failed"):
        TRA.blend_aligned_tiles(
            torch.zeros(65, dtype=torch.int32, device=cuda), wide,
            torch.zeros(1, 12, 1 << 14, device=cuda), 64, 8, 12, huge)
    assert TRA.LAUNCHES == before
    with pytest.raises(TypeError):
        TRA.blend_aligned_tiles(cstarts, scal.double(), feat, 64, 8, 12,
                                config)
    with pytest.raises(ValueError, match="feat must be"):
        TRA.blend_aligned_tiles(cstarts, scal, feat[:, :9].contiguous(), 64,
                                8, 12, config)


# --------------------------------------------------------------------------
# the chunk ring (count forward and aligned blend)
# --------------------------------------------------------------------------


def _ring_lengths(chunk, stages):
    """Tile lengths around the ring: 1 entry, 1, S and 3S + 1 chunks,
    another 3S + 1 chunks for the split tile (id 4: its left warps stop in
    their first chunk, its right ones never), and an empty tile."""
    long = (3 * stages + 1) * chunk
    return [1, chunk, stages * chunk, long, long, 0]


def _assert_split_tile(cnt, lengths, chunk):
    c4 = cnt[4].reshape(16, 16)
    assert int(c4[:, :8].max()) < chunk
    assert bool((c4[:, 8:] == lengths[4]).all())


@pytest.mark.gpu
@pytest.mark.parametrize("misaligned", [False, True])
@pytest.mark.parametrize("channels", [3, 9, 12])
def test_count_kernel_ring_matches_plain(cuda, channels, misaligned):
    """The contributor-count forward on tiles of 1 entry and of 1, S and
    3S + 1 chunks of its ring, and on a tile where some warps stop in
    their first chunk while the others never stop: counts equal to the
    plain version's, acc and T within 1e-4 max / 1e-6 mean, the same bits
    on two launches. ``misaligned`` starts the stream 4 bytes off a
    16-byte boundary (4-byte copies instead of one bulk copy per chunk)."""
    chunk = 64
    stages, smem = TRS.count_ring_stages(8 + channels, chunk)
    assert 2 <= stages <= 8 and smem >= stages * chunk * (8 + channels) * 4
    lengths = _ring_lengths(chunk, stages)
    stream, starts = ring_tiles(lengths, seed=channels, channels=channels,
                                split=(4,))
    if misaligned:
        buf = torch.empty(stream.numel() + 1, device=cuda)
        stream = buf[1:].view(stream.shape).copy_(stream.to(cuda))
        assert stream.data_ptr() % 16 != 0
    stream, starts = stream.to(cuda), starts.to(cuda)
    nt, gx = len(lengths), 3
    order = torch.argsort(-(starts[1:] - starts[:-1]), stable=True).to(
        torch.int32)
    config = TR.RasterizeConfig(chunk_size=chunk)
    args = (stream, starts, order, nt, gx, channels, config)
    before = TRS.LAUNCHES_CONTRIB
    first = TRS.blend_tiles(*args, with_contrib=True)
    again = TRS.blend_tiles(*args, with_contrib=True)
    torch.cuda.synchronize()
    assert TRS.LAUNCHES_CONTRIB == before + 2
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    acc_p, t_p, cnt_p = TRS.blend_tiles_plain(*args, with_contrib=True)
    assert torch.equal(first[2], cnt_p)
    for got, ref in zip(first[:2], (acc_p, t_p)):
        err = (got - ref).abs()
        assert float(err.max()) <= 1e-4 and float(err.mean()) <= 1e-6
    _assert_split_tile(cnt_p, lengths, chunk)
    assert bool((first[1][5] == 1).all()) and not bool(first[2][5].any())


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [50, 64, 256])
@pytest.mark.parametrize("channels", [3, 9, 12])
def test_aligned_kernel_ring_matches_plain(cuda, channels, chunk):
    """The aligned blend on the same tile lengths of its ring (chunk 50:
    blocks not 16-byte sized, 4-byte copies), the split tile and an empty
    tile: acc and T within 1e-4 max / 1e-6 mean of the plain version, the
    same bits on two launches, the empty tile at acc 0 and T 1."""
    stages, smem = TRA.aligned_ring_stages(channels, chunk)
    assert 2 <= stages <= 8 and smem >= stages * chunk * (6 + channels) * 4
    lengths = _ring_lengths(chunk, stages)
    stream, starts = ring_tiles(lengths, seed=10 + channels,
                                channels=channels, split=(4,))
    cstarts, scal, feat = (x.to(cuda) for x in aligned_layout(
        stream, starts, chunk, channels))
    config = TR.RasterizeConfig(chunk_size=chunk)
    args = (cstarts, scal, feat, len(lengths), 3, channels, config)
    before = TRA.LAUNCHES
    first = TRA.blend_aligned_tiles(*args)
    again = TRA.blend_aligned_tiles(*args)
    torch.cuda.synchronize()
    assert TRA.LAUNCHES == before + 2
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    acc_p, t_p = TRA.blend_aligned_plain(*args)
    for got, ref in zip(first, (acc_p, t_p)):
        err = (got - ref).abs()
        assert float(err.max()) <= 1e-4 and float(err.mean()) <= 1e-6
    _, _, cnt = TRS.blend_tiles_plain(
        stream, starts, torch.arange(len(lengths), dtype=torch.int32),
        len(lengths), 3, channels, config, with_contrib=True)
    _assert_split_tile(cnt, lengths, chunk)
    assert bool((first[0][5] == 0).all()) and bool((first[1][5] == 1).all())


def _padded_cloud(n=20000, seed=3):
    """A seeded batch-2 cloud on a voxel grid (sphere shells at scale
    448), the second item padded with invalid zeros."""
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    rng = np.random.RandomState(seed)
    v = rng.randn(2, n, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    xyz = np.round(v * 0.8 * 448 * rng.uniform(0.9, 1.0, (2, n, 1)) + 512)
    vm = np.ones((2, n, 1), bool)
    vm[1, n - n // 5:] = False
    xyz[1, n - n // 5:] = 0.0
    return PointCloud(
        xyz_w=torch.from_numpy(xyz.astype(np.float32)),
        rgb=torch.from_numpy(rng.rand(2, n, 3).astype(np.float32)),
        normal_w=torch.from_numpy(v.astype(np.float32)),
        valid_mask=torch.from_numpy(vm))


@pytest.mark.gpu
def test_voxel_downsampling_on_the_card_matches_cpu(cuda):
    """The same cells on the card: equal valid masks, xyz / rgb / normal
    within 1e-5 (index_add_ sums in another order there)."""
    pcd = _padded_cloud()
    want = pcd.voxel_downsampling(cell_width=2.0)
    got = pcd.to(cuda).voxel_downsampling(cell_width=2.0)
    assert got.device.type == "cuda"
    assert torch.equal(got.valid_mask.cpu(), want.valid_mask)
    assert 0 < int(want.valid_mask.sum()) < int(pcd.get_valid_mask().sum())
    for k in ("xyz_w", "rgb", "normal_w"):
        err = (getattr(got, k).cpu() - getattr(want, k)).abs().max()
        assert float(err) <= 1e-5, (k, float(err))
    kept = pcd.to(cuda).remove_outlier(radius=2.0, min_neighbors=4, bidx=1)
    assert torch.equal(kept.valid_mask.cpu(), pcd.remove_outlier(
        radius=2.0, min_neighbors=4, bidx=1).valid_mask)


@pytest.mark.gpu
def test_get_pcd_on_the_card_matches_cpu(cuda):
    """A mesh's ray-cast RGBD unprojected on the card and on the CPU:
    equal masks, points and directions within 1e-5."""
    from gpcr_tpu_torch.structures.camera import Camera
    from gpcr_tpu_torch.train.data import synthetic_scene

    cam = Camera(H_c2w=TRM.get_H_c2w_lookat(
        torch.tensor([[0.3, -0.2, -2.2], [2.0, 0.5, 0.3]]),
        torch.zeros(2, 3), torch.tensor([[0.0, 1.0, 0.0]] * 2))[None],
        intrinsic=derive_camera_intrinsics(64, 48, 55.0).expand(1, 2, 3, 3),
        width_px=64, height_px=48)
    rgbd = synthetic_scene(2).get_rgbd_image(cam)
    want = rgbd.get_pcd()
    got = dataclasses.replace(rgbd, camera=cam.to(cuda)).get_pcd()
    assert got.device.type == "cuda"
    mask = want.valid_mask
    assert torch.equal(got.valid_mask.cpu(), mask) and 0 < int(mask.sum())
    for k in ("xyz_w", "rgb", "normal_w", "captured_z_direction_w",
              "captured_view_direction_w"):
        g = torch.where(mask, getattr(got, k).cpu(), 0.0)
        w = torch.where(mask, getattr(want, k), 0.0)
        assert float((g - w).abs().max()) <= 1e-5, k


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_segment_max_min_on_the_card_match_cpu(cuda, dtype):
    """scatter_reduce_ on the card: the CPU's values, empty segments at the
    reduction's identity."""
    from gpcr_tpu_torch.ops import segment as TSEG

    rng = np.random.RandomState(0)
    data = torch.from_numpy((rng.randn(5000, 3) * 100).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(rng.randint(0, 700, 5000))
    for fn in (TSEG.segment_max, TSEG.segment_min):
        want = fn(data, ids, 800)
        got = fn(data.to(cuda), ids.to(cuda), 800)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("shading", ["raw", "half"])
def test_rasterize_surfel_on_the_card_matches_cpu(cuda, shading):
    """The surfel z-buffer of a seeded sphere cloud on the card: hit maps
    and colours equal on at least 99.9% of pixels (the rest only where a
    point's uv or z rounds across a pixel edge or the 1e-6 tie window),
    depth within 1e-5 relative where both agree."""
    from gpcr_tpu_torch.structures.camera import Camera
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    rng = np.random.RandomState(1)
    v = rng.randn(1, 20000, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    pcd = PointCloud.from_numpy((v[0] * 0.5).astype(np.float32),
                                (v[0] * 0.5 + 0.5).astype(np.float32),
                                v[0].astype(np.float32))
    cam = Camera(H_c2w=TRM.get_H_c2w_lookat(
        torch.tensor([[0.0, 0.2, -2.0], [1.5, 0.3, -1.0]]), torch.zeros(2, 3),
        torch.tensor([[0.0, 1.0, 0.0]] * 2))[None],
        intrinsic=derive_camera_intrinsics(96, 96, 60.0).expand(1, 2, 3, 3),
        width_px=96, height_px=96)
    want = pcd.rasterize_surfel(cam, shading=shading)
    got = pcd.to(cuda).rasterize_surfel(cam.to(cuda), shading=shading)
    assert got.rgb.device.type == "cuda"
    same = ((got.hit_map.cpu() == want.hit_map)
            & (got.rgb.cpu() == want.rgb).all(-1))
    assert float(same.float().mean()) >= 0.999
    both = same & (want.hit_map > 0.5)
    assert int(both.sum()) > 1000
    rel = ((got.depth.cpu() - want.depth).abs() / want.depth)[both]
    assert float(rel.max()) <= 1e-5


@pytest.mark.gpu
def test_k_neighbor_points_on_the_card_match_cpu(cuda):
    """The same float32 operations one at a time on both devices, and one
    int64 key per (distance, index): equal indices, distances and t."""
    from gpcr_tpu_torch.utils import geometry as TG

    rng = np.random.RandomState(2)
    pts = torch.from_numpy(rng.randn(1, 20000, 3).astype(np.float32))
    o = torch.from_numpy((rng.randn(1, 300, 3) * 2).astype(np.float32))
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(1, 300, 3).astype(np.float32)), dim=-1)
    want = TG.get_k_neighbor_points_in_chunks(pts, o, d, k=8, chunk_rays=64,
                                              t_min=0.5, t_max=3.0)
    got = TG.get_k_neighbor_points_in_chunks(pts.to(cuda), o.to(cuda), d.to(cuda),
                                             k=8, chunk_rays=64, t_min=0.5,
                                             t_max=3.0)
    assert torch.equal(got["sorted_idxs"].cpu(), want["sorted_idxs"])
    for k in ("sorted_dists", "sorted_ts"):
        assert float((got[k].cpu() - want[k]).nan_to_num(0.0, 0.0, 0.0)
                     .abs().max()) <= 1e-6, k


@pytest.mark.gpu
def test_interpolate_trilinear_and_prune_on_the_card_match_cpu(cuda):
    """Trilinear features within 1e-6 and pruned codes / features equal."""
    from gpcr_tpu_torch.ops import sparse as TSP

    rng = np.random.RandomState(3)
    coords = torch.from_numpy(rng.randint(0, 40, (20000, 3)).astype(np.float32))
    feats = torch.from_numpy(rng.randn(20000, 8).astype(np.float32))
    grid = TSP.quantize_average(coords, feats)
    pts = torch.from_numpy(rng.uniform(-1, 41, (30000, 3)).astype(np.float32))
    gpu_grid = TSP.quantize_average(coords.to(cuda), feats.to(cuda))
    assert torch.equal(gpu_grid.codes.cpu(), grid.codes)
    want = TSP.interpolate_trilinear(grid, pts)
    got = TSP.interpolate_trilinear(gpu_grid.replace(feats=grid.feats.to(cuda)),
                                    pts.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-6
    keep = torch.from_numpy(rng.rand(grid.num) > 0.5)
    p_cpu, p_gpu = TSP.prune(grid, keep), TSP.prune(
        grid.replace(codes=grid.codes.to(cuda), feats=grid.feats.to(cuda)),
        keep.to(cuda))
    assert torch.equal(p_gpu.codes.cpu(), p_cpu.codes)
    assert torch.equal(p_gpu.feats.cpu(), p_cpu.feats)


@pytest.mark.gpu
def test_entry_on_the_card_matches_cpu(cuda):
    """``gpcr_tpu_torch.entry``'s forward on the card against
    ``entry(device="cpu")`` (the same seeded weights and scene) at 1e-4,
    with one serving-kernel launch per call and no training kernel."""
    from gpcr_tpu_torch import entry as TE

    fn, args = TE.entry()
    assert all(t.device.type == "cuda" for t in args[1:])
    fn_c, args_c = TE.entry(device="cpu")
    with torch.no_grad():
        want = fn_c(*args_c)
        for _ in range(2):
            TRS.LAUNCHES = TRS.LAUNCHES_CONTRIB = TV.LAUNCHES_BWD = 0
            got = fn(*args)
            torch.cuda.synchronize()
            assert (TRS.LAUNCHES, TRS.LAUNCHES_CONTRIB,
                    TV.LAUNCHES_BWD) == (1, 0, 0)
    assert tuple(got.shape) == (12, TE.HW, TE.HW)
    assert bool(torch.isfinite(got).all())
    assert float((got.cpu() - want).abs().max()) <= 1e-4


# --------------------------------------------------------------------------
# the U-Net's sparse convolutions: csrc/sparse_conv.cu
# --------------------------------------------------------------------------

# The kernel and its plain version sum the same float32 products in another
# order, so an output differs by float32 rounding of its sum: held to
# SPARSE_REL of the sum of the terms' magnitudes (|x| @ |W| + |b| over the
# same pairs; the rounding of n terms stays far below n * 2^-24 of it),
# plus SPARSE_ABS for outputs whose terms all vanish.
SPARSE_REL, SPARSE_ABS = 1e-5, 1e-7
UNET_WIDTHS = ["9 32 64 128 256 128", "9 16 16 16 16 16"]


def _sparse_encoder(dev, widths, n=60000, seed=11):
    """A seeded PCEncoder of ``widths`` on ``dev`` and a quantized
    shell-shaped cloud (a few voxels thick, like a scanned surface) with
    its plan."""
    from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                               assemble_input_features)
    from gpcr_tpu_torch.ops import sparse as TSP

    info = PCMLInfo(clr_encoder_channels=widths, scale_factor=448)
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = v * (100.0 + rng.rand(n, 1) * 3.0) + 512.0
    xyz = torch.from_numpy(xyz.astype(np.float32)).to(dev)
    rgb = torch.from_numpy((v * 0.5 + 0.5).astype(np.float32)).to(dev)
    grid = TSP.quantize_average(
        xyz, assemble_input_features(info, xyz, rgb, 512))
    model = PCEncoder(info, generator=torch.Generator().manual_seed(seed))
    # non-zero biases, so the epilogue's bias add is exercised
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=torch.Generator()
                                    .manual_seed(len(name))) * 0.1)
    model = model.to(dev).eval()
    return model, grid, model.build_plan(grid)


def _recorded_convs(monkeypatch, model, grid, plan):
    """Every conv_map call of one inference forward: (cmap, feats, weight,
    bias, relu) per weight."""
    from gpcr_tpu_torch.ops import sparse as TSP

    calls, real = [], TSP.conv_map

    def record(cmap, feats_list, weights, biases, relu=False):
        calls.extend((cmap, f.clone(), w, b, relu)
                     for f, w, b in zip(feats_list, weights, biases))
        return real(cmap, feats_list, weights, biases, relu)

    monkeypatch.setattr(TSP, "conv_map", record)
    with torch.no_grad():
        model.color_encoder(grid, plan)
    monkeypatch.setattr(TSP, "conv_map", real)
    return calls


@pytest.mark.gpu
@pytest.mark.parametrize("widths", UNET_WIDTHS)
@pytest.mark.parametrize("kind", ["cube", "down", "up"])
def test_sparse_conv_kernel_matches_plain(cuda, monkeypatch, kind, widths):
    """Each (Cin, Cout) of ``kind`` in a U-Net of ``widths``, on the inputs
    its forward gives it: the kernel against ``conv_map_plain`` within the
    rounding limit above, and the same bits on a second launch."""
    from gpcr_tpu_torch.ops import sparse as TSP

    model, grid, plan = _sparse_encoder(cuda, widths)
    calls = _recorded_convs(monkeypatch, model, grid, plan)
    assert len(calls) == 68  # 62 cube (conv_multi as two), 3 down, 3 up
    seen = set()
    for cmap, feats, w, b, relu in calls:
        shape = (cmap.src.num, w.shape[1], w.shape[2])
        if cmap.kind != kind or shape in seen:
            continue
        seen.add(shape)
        with torch.no_grad():
            before = TSP.LAUNCHES
            (got,) = TSP.conv_map(cmap, [feats], [w], [b], relu=relu)
            (again,) = TSP.conv_map(cmap, [feats], [w], [b], relu=relu)
            torch.cuda.synchronize()
            assert TSP.LAUNCHES == before + 2
            tiles = cmap.tiled_map()
            ref = TSP.conv_map_plain(tiles, feats, w, b, cmap.dst.num,
                                     relu=relu)
            scale = TSP.conv_map_plain(tiles, feats.abs(), w.abs(), b.abs(),
                                       cmap.dst.num)
        assert got.shape == ref.shape == (cmap.dst.num, w.shape[2])
        assert torch.equal(got, again), shape
        excess = (got - ref).abs() - (SPARSE_REL * scale + SPARSE_ABS)
        assert float(excess.max()) <= 0, (kind, shape,
                                          float((got - ref).abs().max()))
    assert seen


def _edge_map(dev, n_src=500, seed=5):
    """A cube ConvMap over a hand-made (300, 27) neighbour list whose tiles
    reach the kernel's ring edges: rows 0-99 miss every offset (tile 0 of
    the mask-sorted order has mask 0: no step at all), rows 100-199 hit
    only offsets 0, 6 and 13 (tiles 1 and 2, whose masks skip the offsets
    between), rows 200-299 each offset with probability one half."""
    from gpcr_tpu_torch.ops import sparse as TSP

    rng = np.random.RandomState(seed)
    nbr = rng.randint(0, n_src, size=(300, 27))
    nbr[:100] = -1
    nbr[100:200][:, [k for k in range(27) if k not in (0, 6, 13)]] = -1
    nbr[200:][rng.rand(100, 27) < 0.5] = -1
    codes = torch.arange(n_src, device=dev)
    src = TSP.SparseGrid(codes=codes, feats=codes[:, None].float())
    dst = TSP.SparseGrid(codes=codes[:300], feats=codes[:300, None].float())
    cmap = TSP.ConvMap("cube", src, dst)
    cmap.tiles = TSP.tile_map(torch.from_numpy(nbr).to(dev))
    return cmap


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout", [(9, 32), (32, 512), (12, 136),
                                      (64, 16), (16, 13), (256, 256)])
def test_sparse_conv_kernel_ring_edges(cuda, cin, cout):
    """The kernel's ring at its edges, on ``_edge_map``: Cin 9 (4-byte
    copies of A), Cin 12 (a row chunk shorter than KC), Cout 512 and 256
    (two consumer groups per stage, two column blocks at 512), Cout 136 (a
    ragged second group), Cout 13 (4-byte copies of W); an all-miss tile
    equals the bias, ReLU'd. Held to the rounding limit against
    ``conv_map_plain`` and to the same bits on a second launch."""
    from gpcr_tpu_torch.ops import sparse as TSP

    cmap = _edge_map(cuda)
    tiles = cmap.tiled_map()
    assert tiles.tile_masks[:3].tolist() == [0, 8257, 8257]
    gen = torch.Generator(device=cuda).manual_seed(cin * 1000 + cout)
    feats = torch.randn((cmap.src.num, cin), generator=gen, device=cuda)
    w = torch.randn((27, cin, cout), generator=gen, device=cuda) * 0.1
    b = torch.randn((cout,), generator=gen, device=cuda)
    with torch.no_grad():
        before = TSP.LAUNCHES
        (got,) = TSP.conv_map(cmap, [feats], [w], [b], relu=True)
        (again,) = TSP.conv_map(cmap, [feats], [w], [b], relu=True)
        torch.cuda.synchronize()
        assert TSP.LAUNCHES == before + 2
        ref = TSP.conv_map_plain(tiles, feats, w, b, cmap.dst.num, relu=True)
        scale = TSP.conv_map_plain(tiles, feats.abs(), w.abs(), b.abs(),
                                   cmap.dst.num)
    assert torch.equal(got, again)
    excess = (got - ref).abs() - (SPARSE_REL * scale + SPARSE_ABS)
    assert float(excess.max()) <= 0, float((got - ref).abs().max())
    assert torch.equal(got[:100], torch.relu(b).expand(100, cout))


@pytest.mark.gpu
@pytest.mark.parametrize("widths", UNET_WIDTHS)
def test_encoder_on_the_kernel_matches_the_differentiable_ops(cuda, widths):
    """A whole PCEncoder forward: inference (every conv on the kernel,
    68 launches) against the same forward with gradients first (the
    differentiable ops: no launch, and no kernel map built) at 1e-4 of
    each output's largest value; the plan's fill (pairs / slots) reported
    by the maps is in (0, 1]."""
    from gpcr_tpu_torch.ops import sparse as TSP

    model, grid, plan = _sparse_encoder(cuda, widths)
    before = TSP.LAUNCHES
    with torch.enable_grad():
        sp_ref = model(grid, plan)
        torch.cuda.synchronize()
        assert sp_ref.scale.requires_grad
    assert TSP.LAUNCHES == before  # a gradient keeps the ops
    assert all(m.tiles is None for ms in plan["maps"].values() for m in ms)
    with torch.no_grad():
        sp = model(grid, plan)
        torch.cuda.synchronize()
    assert TSP.LAUNCHES == before + 68
    for name in ("primitives", "rotation", "scale", "offsets"):
        got, ref = getattr(sp, name), getattr(sp_ref, name).detach()
        err = float((got - ref).abs().max())
        assert err <= 1e-4 * max(float(ref.abs().max()), 1.0), (name, err)
    # every map of the plan was tiled by its first launch
    tiles = [m.tiles for ms in plan["maps"].values() for m in ms]
    assert all(t is not None for t in tiles)
    assert all(0 < t.pairs <= t.slots for t in tiles)


# ---- Point Transformer V3: csrc/patch_attn.cu and the 5^3 stem -------------

# The attention kernel and its plain version (softmax, then two cuBLAS
# products) sum the same float32 terms in another order and take exp2 of
# log2-scaled scores for exp: on outputs of |v| ~ 1 they differ by float32
# rounding, held to ATTN_ABS.
ATTN_ABS = 1e-5


def _patches(dev, n, patch=1024, seed=3):
    from gpcr_tpu_torch.ops import serialize

    gen = torch.Generator().manual_seed(seed)
    code = torch.randperm(4 * n, generator=gen)[:n].to(dev)
    return serialize.patches_of(code, patch)


@pytest.mark.gpu
@pytest.mark.parametrize("n,heads", [(5000, 2), (5000, 32), (3072, 2),
                                     (700, 4)])
def test_patch_attn_kernel_matches_plain(cuda, n, heads):
    """d = 16, K = min(1,024, N): N not a multiple of K (the last patch
    shares rows with the one before), a multiple, and one patch of 700
    (a masked last key tile); heads 2 and 32. Same bits on a second
    launch; every voxel written."""
    from gpcr_tpu_torch.ops import patch_attn as PA

    pt = _patches(cuda, n)
    gen = torch.Generator(device=cuda).manual_seed(n + heads)
    qkv = torch.randn((n, 3 * heads * 16), generator=gen, device=cuda)
    with torch.no_grad():
        before = PA.LAUNCHES
        got = PA.patch_attention(qkv, pt, heads)
        again = PA.patch_attention(qkv, pt, heads)
        ref = PA.patch_attention_plain(qkv, pt, heads)
        torch.cuda.synchronize()
    assert PA.LAUNCHES == before + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= ATTN_ABS, err


def _ptv3_inputs(dev, points):
    """The benchmark's cloud of ``points`` and the reference's seeded
    full-width weights."""
    from cellbench import scene
    from cellbench.reference import ptv3 as REF

    cloud = {"points": points, "scale_factor": 448, "offset": 512,
             "grid": 1024, "radius": 0.55, "stretch_y": 1.6, "noise": 0.002}
    seed = 2**31 + 101
    xyz, rgb = scene.cloud(cloud, seed, dev)
    w = REF.make_weights(REF.settings({}), 13, scene.generator(
        seed, scene.STREAM_WEIGHTS, dev), dev)
    return xyz, rgb, w


def _ptv3_encoder(dev, xyz, rgb, w):
    from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                               assemble_input_features)
    from gpcr_tpu_torch.ops import sparse as TSP

    info = PCMLInfo.from_dict({"model_type": "ptv3", "scale_factor": 448,
                               "clr_encoder_channels": "9"})
    enc = PCEncoder(info, generator=torch.Generator().manual_seed(0))
    enc = enc.to(dev).eval()
    enc.color_encoder.load_state_dict(w)
    grid = TSP.quantize_average(
        xyz, assemble_input_features(info, xyz, rgb, 512))
    return enc, grid, enc.build_plan(grid)


@pytest.mark.gpu
def test_ptv3_stem_on_the_card_matches_plain(cuda):
    """The 125-offset stem, five launches of 25 offsets, against
    ``conv_map_plain`` over the same maps summed, within the sparse
    rounding limit."""
    from gpcr_tpu_torch.ops import sparse as TSP

    xyz, rgb, w = _ptv3_inputs(cuda, 100000)
    enc, grid, plan = _ptv3_encoder(cuda, xyz, rgb, w)
    kernel = w["embedding.conv.kernel"]
    got = ref = scale = 0
    with torch.no_grad():
        for i, cmap in enumerate(plan["stem"]):
            k = kernel[25 * i:25 * i + 25]
            got = got + TSP.conv_map(cmap, [grid.feats], [k], [None])[0]
            tiles = cmap.tiled_map()
            ref = ref + TSP.conv_map_plain(tiles, grid.feats, k, None,
                                           grid.num)
            scale = scale + TSP.conv_map_plain(tiles, grid.feats.abs(),
                                               k.abs(), None, grid.num)
    excess = (got - ref).abs() - (SPARSE_REL * scale + SPARSE_ABS)
    assert float(excess.max()) <= 0, float((got - ref).abs().max())


@pytest.mark.gpu
def test_ptv3_pass_on_the_card_matches_the_reference(cuda):
    """One full-width PTv3 pass (Pointcept's base widths) at a ~100K-voxel
    cloud, every sparse conv and attention on the kernels, against the
    plain reference on the card: the backbone at 1e-4 on features of rms
    ~2 (float32 sums in other orders through ~20 layers)."""
    from cellbench.reference import ptv3 as REF
    from gpcr_tpu_torch.ops import patch_attn as PA
    from gpcr_tpu_torch.ops import sparse as TSP

    xyz, rgb, w = _ptv3_inputs(cuda, 110000)
    enc, grid, plan = _ptv3_encoder(cuda, xyz, rgb, w)
    a0, s0 = PA.LAUNCHES, TSP.LAUNCHES
    with torch.no_grad():
        got = enc.color_encoder.backbone(grid, plan)
        torch.cuda.synchronize()
        _, _, want, net = REF.backbone(xyz, rgb, w, REF.settings({}), 448)
    assert grid.num > 90000
    # 22 blocks: one attention and one CPE conv each, and 5 stem launches
    assert PA.LAUNCHES - a0 == 22 and TSP.LAUNCHES - s0 == 5 + 22
    err = float((got - want).abs().max())
    assert err <= 1e-4, err


# ---- Point Transformer V2: csrc/gva.cu and the plan's kNN -----------------

# the GVA kernel against its plain version, both the folded function:
# float32 sums in other orders (the W2 sums run over C <= 512 channels),
# expf for exp, on outputs of |y| ~ 1
GVA_REL = 1e-5


def _gva_case(dev, n, groups, k, seed):
    """Seeded q, k, v, a kNN list of random points, their relative
    positions and an attention module's folded weights (seeded BatchNorm
    statistics, so that no fold is an identity)."""
    from gpcr_tpu_torch.models import ptv2 as P2
    from gpcr_tpu_torch.ops import knn as KN

    gen = torch.Generator().manual_seed(seed)
    c = groups * 8
    attn = P2.GroupedVectorAttention(c, groups, gen)
    with torch.no_grad():
        for bn in (attn.pe_norm, attn.we_norm):
            m = bn.weight.shape[0]
            bn.weight.copy_(1 + 0.1 * torch.randn(m, generator=gen))
            bn.bias.copy_(0.1 * torch.randn(m, generator=gen))
            bn.running_mean.copy_(0.1 * torch.randn(m, generator=gen))
            bn.running_var.copy_(torch.exp(0.2 * torch.randn(
                m, generator=gen)))
    attn = attn.to(dev).eval()
    pts = torch.rand((n, 3), generator=gen, dtype=torch.float64) * 40
    nbr = KN.knn(pts.to(dev), 16, 4.0)
    delta = (0.02 * (pts.to(dev)[nbr] - pts.to(dev)[:, None])).float()
    qkv = torch.relu(torch.randn((3, n, c), generator=gen)).to(dev)
    return (qkv[0].contiguous(), qkv[1].contiguous(),
            qkv[2].contiguous() - 0.5, nbr.int().contiguous(),
            delta.contiguous(), k, attn.folded())


@pytest.mark.gpu
@pytest.mark.parametrize("groups,k", [(6, 8), (6, 16), (12, 16), (24, 16),
                                      (48, 16), (64, 16)])
@pytest.mark.parametrize("n", [3000, 77])
def test_gva_kernel_matches_plain(cuda, groups, k, n):
    """Every stage width (C 48 / 96 / 192 / 384 / 512, and the patch
    embedding's 8 neighbours at 48), a tile-ragged and a one-tile n:
    within GVA_REL of the plain version's largest output, the same bits on
    a second launch, every output written."""
    from gpcr_tpu_torch.ops import gva as GV

    args = _gva_case(cuda, n, groups, k, seed=groups * 100 + k + n)
    with torch.no_grad():
        before = GV.LAUNCHES
        got = GV.grouped_vector_attention(*args)
        again = GV.grouped_vector_attention(*args)
        ref = GV.gva_plain(*args)
        torch.cuda.synchronize()
    assert GV.LAUNCHES == before + 2
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= GVA_REL * float(ref.abs().max()), err


@pytest.mark.gpu
def test_refused_gva_launch_raises(cuda):
    from gpcr_tpu_torch.ops import gva as GV

    q, k, v, nbr, delta, kk, f = _gva_case(cuda, 100, 12, 16, seed=5)
    with torch.no_grad():
        with pytest.raises(ValueError, match="8 at 6 groups"):
            GV.grouped_vector_attention(q, k, v, nbr, delta, 8, f)
        with pytest.raises(ValueError, match="int32"):
            GV.grouped_vector_attention(q, k, v, nbr.long(), delta, kk, f)


def _ptv2_inputs(dev, points):
    """The benchmark's cloud of ``points`` and the reference's seeded
    full-width weights."""
    from cellbench import scene
    from cellbench.reference import ptv2 as REF

    cloud = {"points": points, "scale_factor": 448, "offset": 512,
             "grid": 1024, "radius": 0.55, "stretch_y": 1.6, "noise": 0.002}
    seed = 2**31 + 101
    xyz, rgb = scene.cloud(cloud, seed, dev)
    w = REF.make_weights(REF.settings({}), 13, scene.generator(
        seed, scene.STREAM_WEIGHTS, dev), dev)
    return xyz, rgb, w


def _ptv2_encoder(dev, xyz, rgb, w):
    from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                               assemble_input_features)
    from gpcr_tpu_torch.ops import sparse as TSP

    info = PCMLInfo.from_dict({"model_type": "ptv2", "scale_factor": 448,
                               "clr_encoder_channels": "9"})
    enc = PCEncoder(info, generator=torch.Generator().manual_seed(0))
    enc = enc.to(dev).eval()
    enc.color_encoder.load_state_dict(w)
    grid = TSP.quantize_average(
        xyz, assemble_input_features(info, xyz, rgb, 512))
    return enc, grid, enc.build_plan(grid)


@pytest.mark.gpu
def test_ptv2_plan_on_the_card_matches_the_reference_geometry(cuda):
    """The plan's neighbour lists (the card's grid search, tie rule
    included), relative positions and clusters at all five levels equal
    the reference's brute force, bit for bit."""
    from cellbench.reference import network
    from cellbench.reference import ptv2 as REF

    xyz, rgb, w = _ptv2_inputs(cuda, 110000)
    enc, grid, plan = _ptv2_encoder(cuda, xyz, rgb, w)
    vox, _ = network.voxelize(xyz, rgb)
    levels = REF.hierarchy(vox, REF.settings({}))
    for got, want in zip(plan["levels"], levels):
        assert got.n == want.n
        assert torch.equal(got.nbr.long(), want.nbr)
        assert torch.equal(got.delta, want.delta)
        if want.cluster is not None:
            assert torch.equal(got.cluster, want.cluster)


@pytest.mark.gpu
def test_ptv2_pass_on_the_card_matches_the_reference(cuda):
    """One full-width PTv2 pass (Pointcept's m2 base widths) at a
    ~100K-voxel cloud, every grouped vector attention on the kernel,
    against the plain (unfolded) reference on the card: the backbone at
    1e-4 (float32 sums in other orders and the fold's, through 17
    blocks)."""
    from cellbench.reference import ptv2 as REF
    from gpcr_tpu_torch.ops import gva as GV
    from gpcr_tpu_torch.ops import patch_attn as PA
    from gpcr_tpu_torch.ops import sparse as TSP

    xyz, rgb, w = _ptv2_inputs(cuda, 110000)
    enc, grid, plan = _ptv2_encoder(cuda, xyz, rgb, w)
    g0, a0, s0 = GV.LAUNCHES, PA.LAUNCHES, TSP.LAUNCHES
    with torch.no_grad():
        got = enc.color_encoder.backbone(grid, plan)
        torch.cuda.synchronize()
        _, _, want, net, _ = REF.backbone(xyz, rgb, w, REF.settings({}), 448)
    assert grid.num > 90000
    assert GV.LAUNCHES - g0 == 17 and PA.LAUNCHES == a0
    assert TSP.LAUNCHES == s0
    err = float((got - want).abs().max())
    assert err <= 1e-4, (err, float(want.abs().max()))


# ---- Swin3D: csrc/swin_attn.cu and the plan's cross-set kNN ---------------

# the window attention kernel against its plain version, the same form:
# float32 sums in other orders (softmax over up to 343 keys, the value
# histogram's shared atomics in no fixed order), expf for exp
SWIN_REL = 1e-5


def _swin_case(dev, w, heads, d, shift, seed):
    """Seeded qkv, signals, tables and a partition whose windows hold a
    full w^3 block (split by the shift when it is on), single points, and
    a scatter; the tables at 0.3 so that every term weighs."""
    from gpcr_tpu_torch.ops import swin_attn as SA

    gen = torch.Generator().manual_seed(seed)
    r = torch.arange(w)
    block = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                        -1).reshape(-1, 3)
    lone = torch.tensor([[10 * w, 0, 0], [0, 10 * w, 0], [0, 0, 10 * w]])
    scatter = torch.randint(w, 7 * w, (1500, 3), generator=gen)
    cells = torch.unique(torch.cat([block, lone, scatter]), dim=0)
    n = cells.shape[0]
    pos = cells.float() + 0.9 * torch.rand((n, 3), generator=gen)
    col = (2 * torch.rand((n, 3), generator=gen) - 1) / 1.001
    sig = torch.cat([pos, col], 1).to(dev).contiguous()
    quant = 4
    lp, lc = 2 * w * quant, 2 * 2 * 2 * quant
    rows = 3 * lp + 3 * lc
    tabs = [(0.3 * torch.randn((rows, heads, d), generator=gen)).to(dev)
            for _ in range(3)]
    t = SA.Tables(q=tabs[0], k=tabs[1], v=tabs[2], lp=lp, lc=lc,
                  qp=float(quant), qc=float(2 * quant))
    qkv = torch.randn((n, 3 * heads * d), generator=gen).to(dev)
    win = SA.partition(cells.to(dev), w, shift)
    return qkv, win, sig, t, heads


@pytest.mark.gpu
@pytest.mark.parametrize("w,heads,d", [(5, 6, 8), (7, 6, 16), (7, 12, 16),
                                       (7, 24, 16)])
@pytest.mark.parametrize("shifted", [False, True])
def test_swin_attn_kernel_matches_plain(cuda, w, heads, d, shifted):
    """Every Swin3D-S width (d 8 at w 5, d 16 at w 7, H 6 to 24) over
    windows of 1 point, of w^3 points (125 / 343) and a scatter, unshifted
    and shifted: within SWIN_REL of the plain version's largest output,
    every output written, one launch each."""
    from gpcr_tpu_torch.ops import swin_attn as SA

    args = _swin_case(cuda, w, heads, d, w // 2 if shifted else 0,
                      seed=w * 100 + heads + d + shifted)
    win = args[1]
    counts = (win.offsets[1:] - win.offsets[:-1]).tolist()
    assert 1 in counts
    if not shifted:  # the block fills one window, over several chunks
        assert win.most == w ** 3 and w ** 3 > 32
    with torch.no_grad():
        before = SA.LAUNCHES
        got = SA.window_attention(*args)
        ref = SA.window_attention_plain(*args)
        torch.cuda.synchronize()
    assert SA.LAUNCHES == before + 1
    assert bool(torch.isfinite(got).all())
    err = float((got - ref).abs().max())
    assert err <= SWIN_REL * float(ref.abs().max()), err


@pytest.mark.gpu
def test_refused_swin_attn_launch_raises(cuda):
    from gpcr_tpu_torch.ops import swin_attn as SA

    qkv, win, sig, t, heads = _swin_case(cuda, 5, 6, 8, 0, seed=3)
    with torch.no_grad():
        with pytest.raises(ValueError, match="head dim"):
            SA.window_attention(qkv[:, :3 * 6 * 4].contiguous(), win, sig,
                                t, 6)
        with pytest.raises(ValueError, match="int32"):
            SA.window_attention(qkv, win._replace(perm=win.perm.long()), sig,
                                t, heads)


def _swin3d_encoder(dev, points):
    from cellbench import scene
    from cellbench.reference import swin3d as REF
    from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                               assemble_input_features)
    from gpcr_tpu_torch.ops import sparse as TSP

    cloud = {"points": points, "scale_factor": 448, "offset": 512,
             "grid": 1024, "radius": 0.55, "stretch_y": 1.6, "noise": 0.002}
    seed = 2**31 + 103
    xyz, rgb = scene.cloud(cloud, seed, dev)
    w = REF.make_weights(REF.settings({}), 13, scene.generator(
        seed, scene.STREAM_WEIGHTS, dev), dev)
    info = PCMLInfo.from_dict({"model_type": "swin3d", "scale_factor": 448,
                               "clr_encoder_channels": "9"})
    enc = PCEncoder(info, generator=torch.Generator().manual_seed(0))
    enc = enc.to(dev).eval()
    enc.color_encoder.load_state_dict(w)
    grid = TSP.quantize_average(
        xyz, assemble_input_features(info, xyz, rgb, 512))
    return xyz, rgb, w, enc, grid, enc.build_plan(grid)


@pytest.mark.gpu
def test_swin3d_plan_and_pass_on_the_card_match_the_reference(cuda):
    """A full-width Swin3D-S pass at a ~100K-voxel cloud: the plan's cells,
    positions, cross-set kNN lists (the card's grid search) and weights
    equal the reference's brute force bit for bit at all five levels; all
    27 window attentions launch the kernel; the backbone within 1e-4 of
    the reference (float32 sums in other orders through 27 blocks)."""
    from cellbench.reference import network
    from cellbench.reference import swin3d as REF
    from gpcr_tpu_torch.ops import swin_attn as SA

    xyz, rgb, w, enc, grid, plan = _swin3d_encoder(cuda, 110000)
    vox, _ = network.voxelize(xyz, rgb)
    with torch.no_grad():
        levels = REF.hierarchy(vox, REF.settings({}))
    for got, want in zip(plan["levels"], levels):
        assert got.n == want.n and torch.equal(got.cells, want.cells)
        assert torch.equal(got.pos, want.pos)
        if want.down is not None:
            assert torch.equal(got.down_nbr, want.down)
        if want.up is not None:
            assert torch.equal(got.up_nbr, want.up)
            assert torch.equal(got.up_w, want.up_w)
    a0 = SA.LAUNCHES
    with torch.no_grad():
        got = enc.color_encoder.backbone(grid, plan)
        torch.cuda.synchronize()
        _, _, want, _, _ = REF.backbone(xyz, rgb, w, REF.settings({}), 448)
    assert grid.num > 90000 and SA.LAUNCHES - a0 == 27
    err = float((got - want).abs().max())
    assert err <= 1e-4, (err, float(want.abs().max()))
