"""The port's CUDA blend kernel on the card (``gpu`` marker).

Each test skips without a CUDA device; the decision is taken inside the
``cuda`` fixture, never at import. The file imports no JAX, so it also
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(``--noconftest`` because tests/conftest.py configures JAX.)

Tolerance: kernel vs its plain PyTorch version at max 1e-4 / mean 1e-6;
every alpha and transmittance is the same float32 value in both, only
the per-channel accumulation order differs.
"""

import numpy as np
import pytest
import torch

from gpcr_tpu_torch.ops import rasterize as TR
from gpcr_tpu_torch.ops import rasterize_stream as TRS
from gpcr_tpu_torch.render.renderer import pin_fp32

pin_fp32()  # parity precision: full-float32 matmuls, no TF32 on a card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend kernel runs only there")
    return torch.device("cuda")


def _binned(dev, channels, config, n=3000, seed=7, res=128):
    """Seeded scene (tests/test_torch_stream.py's, larger), preprocessed
    and binned on ``dev``; returns (stream, starts, order, tiles, grid_x)."""
    rng = np.random.RandomState(seed)
    means = (rng.randn(n, 3) * 0.3 + np.array([0, 0, 2.5])).astype(np.float32)
    scales = (rng.rand(n, 3) * 0.05 + 0.01).astype(np.float32)
    rots = rng.randn(n, 4).astype(np.float32)
    op = rng.rand(n).astype(np.float32)
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

    prep = TR.preprocess(t(means), t(op), settings, config, scales=t(scales),
                         rotations=t(rots), colors_precomp=t(feats))
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
