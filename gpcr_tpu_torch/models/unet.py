"""Sparse U-Net on the voxel gather-GEMM engine (port of
``gpcr_tpu/models/unet.py``, reference ``models/model_v2.py``
InceptionResNet :15-65 and SparseUNet :67-226).

Parameter names mirror the JAX dict keys and the reference torch module
tree (``conv0.kernel``, ``block0.0.conv0_0.bias``, ``up0``, ``conv_3``, ...),
so JAX params, native ``.npz`` checkpoints and reference state dicts load
by name. Every level's 27-neighbour kernel map comes from
``sparse.build_kernel_map`` once per coordinate set (``build_plan``) and
is shared by every conv at that level.
"""

from __future__ import annotations

import typing as T

import torch
from torch import nn

from ..ops import sparse


class SparseConvParams(nn.Module):
    """One sparse conv's parameters: ``kernel`` (K, Cin, Cout), ``bias``
    (Cout,). Initialised like the JAX package: normal * sqrt(2/fan_in),
    zero bias, drawn on the CPU from the caller's generator (move the
    finished module with ``.to(device)``)."""

    def __init__(self, kernel_volume: int, cin: int, cout: int,
                 generator: T.Optional[torch.Generator] = None):
        super().__init__()
        std = (2.0 / (kernel_volume * cin)) ** 0.5
        k = torch.randn((kernel_volume, cin, cout), generator=generator,
                        dtype=torch.float32) * std
        self.kernel = nn.Parameter(k)
        self.bias = nn.Parameter(torch.zeros((cout,), dtype=torch.float32))


class InceptionResNet(nn.Module):
    """Two-branch sparse residual block:
    (3³→3³: ch→ch/4→ch/2) ∥ (1³→3³→1³: ch→ch/4→ch/4→ch/2), concat + skip."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        c = channels
        kw = dict(generator=generator)
        self.conv0_0 = SparseConvParams(27, c, c // 4, **kw)
        self.conv0_1 = SparseConvParams(27, c // 4, c // 2, **kw)
        self.conv1_0 = SparseConvParams(1, c, c // 4, **kw)
        self.conv1_1 = SparseConvParams(27, c // 4, c // 4, **kw)
        self.conv1_2 = SparseConvParams(1, c // 4, c // 2, **kw)

    def forward(self, grid: sparse.SparseGrid, kmap: torch.Tensor):
        x = grid.feats
        h1 = torch.relu(x @ self.conv1_0.kernel[0] + self.conv1_0.bias)
        # conv0_0 (on x) and conv1_1 (on h1) share one neighbour gather
        o00, o11 = sparse.conv_multi(
            grid, kmap, [x, h1],
            [self.conv0_0.kernel, self.conv1_1.kernel],
            [self.conv0_0.bias, self.conv1_1.bias],
        )
        out0 = sparse.conv(grid.replace(feats=torch.relu(o00)), kmap,
                           self.conv0_1.kernel, self.conv0_1.bias)
        out1 = torch.relu(o11) @ self.conv1_2.kernel[0] + self.conv1_2.bias
        return torch.cat([out0, out1], dim=-1) + x


class SparseUNet(nn.Module):
    """3-level sparse U-Net."""

    def __init__(self, channels: T.Sequence[int] = (1, 16, 32, 64, 32, 8),
                 feat_dim: int = 32, block_layers: int = 3,
                 generator: T.Optional[torch.Generator] = None):
        super().__init__()
        c = list(channels)
        self.channels = c
        self.feat_dim = feat_dim
        self.block_layers = block_layers
        kw = dict(generator=generator)

        def conv(kv, cin, cout):
            return SparseConvParams(kv, cin, cout, **kw)

        def blocks(ch):
            return nn.ModuleList(
                [InceptionResNet(ch, **kw) for _ in range(block_layers)])

        self.conv0 = conv(27, c[0], c[1])
        self.down0 = conv(8, c[1], c[2])
        self.block0 = blocks(c[2])
        self.conv1 = conv(27, c[2], c[2])
        self.down1 = conv(8, c[2], c[3])
        self.block1 = blocks(c[3])
        self.conv2 = conv(27, c[3], c[3])
        self.down2 = conv(8, c[3], c[4])
        self.block2 = blocks(c[4])
        self.conv3 = conv(27, c[4], c[5])
        self.up0 = conv(8, c[5], c[3])
        self.conv_0 = conv(27, c[3] * 2, c[3])
        self.block_0 = blocks(c[3])
        self.up1 = conv(8, c[3], c[2])
        self.conv_1 = conv(27, c[2] * 2, c[2])
        self.block_1 = blocks(c[2])
        self.up2 = conv(8, c[2], c[1])
        self.conv_2 = conv(27, c[1] * 2, c[1])
        self.block_2 = blocks(c[1])
        self.conv_3 = conv(27, c[1], feat_dim)

    # ---- plan: geometry-only precomputation ---------------------------------

    @staticmethod
    def build_plan(grid: sparse.SparseGrid) -> dict:
        """Coordinate hierarchy + kernel maps for one input coordinate set
        (the MinkowskiEngine coordinate-manager equivalent); reusable across
        forward passes on the same cloud."""
        grids = [grid]
        downs = []  # (parent_slot, octant) per level transition
        g = grid
        for _ in range(3):
            pgrid, parent_slot, octant = sparse.downsample_coords(g)
            downs.append((parent_slot, octant))
            grids.append(pgrid)
            g = pgrid
        kmaps = [sparse.build_kernel_map(g, 3) for g in grids]
        return {"grids": grids, "downs": downs, "kmaps": kmaps}

    # ---- forward (model_v2.py:202-226) --------------------------------------

    def forward(self, grid: sparse.SparseGrid, plan: dict) -> torch.Tensor:
        grids, downs, kmaps = plan["grids"], plan["downs"], plan["kmaps"]
        relu = torch.relu

        def conv3x(p, feats, lvl):
            return sparse.conv(grids[lvl].replace(feats=feats), kmaps[lvl],
                               p.kernel, p.bias)

        def down(p, feats, lvl):
            parent_slot, octant = downs[lvl]
            return sparse.conv_down(
                grids[lvl].replace(feats=feats), grids[lvl + 1],
                parent_slot, octant, p.kernel, p.bias)

        def up(p, feats_coarse, lvl_coarse, lvl_fine):
            return sparse.conv_up_generative(
                grids[lvl_coarse].replace(feats=feats_coarse),
                grids[lvl_fine].codes, p.kernel, p.bias)

        def run_blocks(blocks, feats, lvl):
            for block in blocks:
                feats = block(grids[lvl].replace(feats=feats), kmaps[lvl])
            return feats

        out_x = relu(conv3x(self.conv0, grid.feats, 0))

        f1 = relu(down(self.down0, out_x, 0))
        f1 = run_blocks(self.block0, f1, 1)

        h = relu(conv3x(self.conv1, f1, 1))
        f2 = relu(down(self.down1, h, 1))
        f2 = run_blocks(self.block1, f2, 2)

        h = relu(conv3x(self.conv2, f2, 2))
        f3 = relu(down(self.down2, h, 2))
        f3 = run_blocks(self.block2, f3, 3)
        f3 = conv3x(self.conv3, f3, 3)

        u2 = relu(up(self.up0, f3, 3, 2))
        f2d = relu(conv3x(self.conv_0, torch.cat([u2, f2], dim=-1), 2))
        f2d = run_blocks(self.block_0, f2d, 2)

        u1 = relu(up(self.up1, f2d, 2, 1))
        f1d = relu(conv3x(self.conv_1, torch.cat([u1, f1], dim=-1), 1))
        f1d = run_blocks(self.block_1, f1d, 1)

        u0 = relu(up(self.up2, f1d, 1, 0))
        f0d = relu(conv3x(self.conv_2, torch.cat([u0, out_x], dim=-1), 0))
        f0d = run_blocks(self.block_2, f0d, 0)

        return conv3x(self.conv_3, f0d, 0)
