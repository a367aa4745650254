"""The port's CUDA kernels on the card (``gpu`` marker): the stream
blend, its contributor-count instantiation, the replay backward and the
aligned all-tiles blend.

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

import numpy as np
import pytest
import torch

from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import rasterize_aligned as TRA
from gpcr_tpu_torch.ops import rasterize_stream as TRS
from gpcr_tpu_torch.ops import rasterize_stream_vjp as TV
from gpcr_tpu_torch.render.renderer import pin_fp32

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
