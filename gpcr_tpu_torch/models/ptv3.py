"""Point Transformer V3 (Wu et al., "Point Transformer V3: Simpler, Faster,
Stronger", CVPR 2024; Pointcept's ``point_transformer_v3m1_base.py``) as
the learned renderer's backbone, for inference.

- grid coordinates ``g = voxel - min`` per axis (Pointcept's
  ``GridSample``); level l holds the voxels ``g >> l`` in code order (a
  ``sparse.SparseGrid``), its pooling clusters are the parents;
- the stem: a submanifold 5^3 convolution without bias (five launches of
  the 25 offsets of one z slice each, summed), BatchNorm, GELU;
- the block (order ``i % 4`` of the orders for block i of a stage):
  ``x += LN(Linear(SubMConv3d_3^3(x)))`` (CPE), ``x += Proj(PatchAttn(
  LN(x)))``, ``x += fc2(GELU(fc1(LN(x))))``;
- encoder stages 1-4 start with pooling: Linear, segment max over each
  parent's children, BatchNorm, GELU; decoder stages start with unpooling:
  ``GELU(BN(Linear(skip))) + GELU(BN(Linear(coarse)))[parent]``;
- ``seg_head``: a Linear to the splat parameters, in the input voxels'
  order.

``build_plan`` computes everything that depends on the geometry alone
(levels, kernel maps, the serialization and its patches, the clusters);
the renderer keeps it per cloud. Sparse convolutions go through
``sparse.conv_map`` (``csrc/sparse_conv.cu`` on a card), patch attention
through ``patch_attn.patch_attention`` (``csrc/patch_attn.cu`` on a card);
LayerNorm, GELU, the Linears and the segment max are torch ops. BatchNorm
runs in evaluation (its running statistics). Parameter names follow the
benchmark reference ``cellbench/reference/ptv3.py``'s ``param_specs``.
"""

from __future__ import annotations

import dataclasses
import math
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import patch_attn, segment, serialize, sparse
from ..utils import trace

# Pointcept's base configuration fixes these (and ``serialize.ORDERS``);
# the widths are PTv3Config's
STEM_KERNEL, MLP_RATIO = 5, 4
STEM_SLICE = 25  # offsets per stem launch: one z slice of the 5^3 kernel
LN_EPS = 1e-5
BN_EPS = 1e-3


@dataclasses.dataclass(frozen=True)
class PTv3Config:
    """The backbone's widths; defaults are Pointcept's base configuration
    (``configs/scannet/semseg-pt-v3m1-0-base.py``)."""

    in_channels: int = 9
    patch_size: int = 1024
    enc_channels: T.Tuple[int, ...] = (32, 64, 128, 256, 512)
    enc_heads: T.Tuple[int, ...] = (2, 4, 8, 16, 32)
    enc_depths: T.Tuple[int, ...] = (2, 2, 2, 6, 2)
    dec_channels: T.Tuple[int, ...] = (64, 64, 128, 256)
    dec_heads: T.Tuple[int, ...] = (4, 4, 8, 16)
    dec_depths: T.Tuple[int, ...] = (2, 2, 2, 2)


def _normal(shape, fan_in: int, generator) -> torch.Tensor:
    """PyTorch's default variance for a Linear or convolution, 1 / (3
    fan-in), drawn normal from ``generator``."""
    return torch.randn(shape, generator=generator) / math.sqrt(3 * fan_in)


def _linear(cin: int, cout: int, generator) -> nn.Linear:
    lin = nn.Linear(cin, cout)
    with torch.no_grad():
        lin.weight.copy_(_normal((cout, cin), cin, generator))
        lin.bias.copy_(_normal((cout,), cin, generator))
    return lin


class BatchNorm(nn.Module):
    """BatchNorm1d in evaluation: (x - running_mean) / sqrt(running_var +
    eps) * weight + bias."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, BN_EPS)


class SubMConv(nn.Module):
    """A submanifold convolution's ``kernel`` (K, Cin, Cout) and, where it
    has one, ``bias``."""

    def __init__(self, volume: int, cin: int, cout: int, bias: bool,
                 generator):
        super().__init__()
        fan_in = volume * cin
        self.kernel = nn.Parameter(_normal((volume, cin, cout), fan_in,
                                           generator))
        self.bias = (nn.Parameter(_normal((cout,), fan_in, generator))
                     if bias else None)


class Embedding(nn.Module):
    def __init__(self, cfg: PTv3Config, generator):
        super().__init__()
        self.conv = SubMConv(STEM_KERNEL ** 3, cfg.in_channels,
                             cfg.enc_channels[0], False, generator)
        self.norm = BatchNorm(cfg.enc_channels[0])


class CPE(nn.Module):
    def __init__(self, c: int, generator):
        super().__init__()
        self.conv = SubMConv(27, c, c, True, generator)
        self.linear = _linear(c, c, generator)
        self.norm = nn.LayerNorm(c, eps=LN_EPS)


class Attention(nn.Module):
    def __init__(self, c: int, heads: int, generator):
        super().__init__()
        self.heads = heads
        self.qkv = _linear(c, 3 * c, generator)
        self.proj = _linear(c, c, generator)


class MLP(nn.Module):
    def __init__(self, c: int, generator):
        super().__init__()
        self.fc1 = _linear(c, MLP_RATIO * c, generator)
        self.fc2 = _linear(MLP_RATIO * c, c, generator)


class Block(nn.Module):
    """CPE, pre-norm patch attention and MLP, each a residual."""

    def __init__(self, c: int, heads: int, order_index: int, generator):
        super().__init__()
        self.order_index = order_index
        self.cpe = CPE(c, generator)
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attn = Attention(c, heads, generator)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = MLP(c, generator)

    def forward(self, x: torch.Tensor, lv: "LevelPlan") -> torch.Tensor:
        with trace.span("gpcr.encode.ptv3.cpe"):
            cpe = self.cpe
            (h,) = sparse.conv_map(lv.cpe, [x], [cpe.conv.kernel],
                                   [cpe.conv.bias])
            x = x + cpe.norm(cpe.linear(h))
        with trace.span("gpcr.encode.ptv3.attn"):
            qkv = self.attn.qkv(self.norm1(x))
            h = patch_attn.patch_attention(qkv, lv.patches[self.order_index],
                                           self.attn.heads)
            x = x + self.attn.proj(h)
        with trace.span("gpcr.encode.ptv3.mlp"):
            return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class Pool(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.proj = _linear(cin, cout, generator)
        self.norm = BatchNorm(cout)


class Unpool(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int, generator):
        super().__init__()
        self.proj = _linear(cin, cout, generator)
        self.proj_norm = BatchNorm(cout)
        self.skip = _linear(cskip, cout, generator)
        self.skip_norm = BatchNorm(cout)


class Stage(nn.Module):
    """A stage's blocks, after its pooling (encoder stages 1-4) or its
    unpooling (decoder)."""

    def __init__(self, c: int, heads: int, depth: int, generator,
                 pool=None, unpool=None):
        super().__init__()
        if pool is not None:
            self.pool = pool
        if unpool is not None:
            self.unpool = unpool
        self.blocks = nn.ModuleList([
            Block(c, heads, i % len(serialize.ORDERS), generator)
            for i in range(depth)])


@dataclasses.dataclass
class LevelPlan:
    """One level of the plan: its voxels, the CPE's 3^3 map, per order the
    patch layout, and (below the coarsest level) each voxel's parent."""

    grid: sparse.SparseGrid
    cpe: sparse.ConvMap
    patches: T.List[serialize.Patches]
    parent: T.Optional[torch.Tensor] = None  # (n,) row at the next level
    n_next: int = 0


class PointTransformerV3(nn.Module):
    """The backbone and its ``seg_head`` (to ``feat_dim`` channels). Built
    on the CPU from ``generator``; move it with ``.to(device)``."""

    def __init__(self, cfg: PTv3Config, feat_dim: int,
                 generator: T.Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        enc, dec = cfg.enc_channels, cfg.dec_channels
        self.embedding = Embedding(cfg, generator)
        self.enc = nn.ModuleList([
            Stage(c, cfg.enc_heads[st], cfg.enc_depths[st], generator,
                  pool=Pool(enc[st - 1], c, generator) if st else None)
            for st, c in enumerate(enc)])
        wide = list(dec) + [enc[-1]]
        self.dec = nn.ModuleList([
            Stage(c, cfg.dec_heads[st], cfg.dec_depths[st], generator,
                  unpool=Unpool(wide[st + 1], enc[st], c, generator))
            for st, c in enumerate(dec)])
        self.seg_head = _linear(dec[0], feat_dim, generator)

    # ---- plan: geometry-only precomputation ---------------------------------

    def build_plan(self, grid: sparse.SparseGrid) -> dict:
        """Levels, kernel maps, serialization, patches and clusters of one
        input coordinate set (``grid``'s voxels in code order)."""
        cfg = self.cfg
        coords = grid.coords()
        g = coords - coords.min(dim=0).values
        cur = sparse.SparseGrid(codes=sparse.pack_coords(g),
                                feats=coords.new_zeros((grid.num, 0)))
        stem = []
        offs = sparse._offsets_cube(STEM_KERNEL, device=g.device)
        for s0 in range(0, offs.shape[0], STEM_SLICE):
            kmap = sparse.build_offset_map(cur, offs[s0:s0 + STEM_SLICE])
            stem.append(sparse.ConvMap("cube", cur, cur, kmap=kmap))
        grids, parents = [cur], []
        for _ in range(len(cfg.enc_channels) - 1):
            nxt, parent, _ = sparse.downsample_coords(grids[-1])
            grids.append(nxt)
            parents.append(parent)
        with trace.span("gpcr.encode.plan.serialize"):
            depth = serialize.depth_of(g)
            codes = torch.stack([serialize.encode(g, o, depth)
                                 for o in serialize.ORDERS])
            patches = []
            for lvl in range(len(grids)):
                patches.append([serialize.patches_of(c, cfg.patch_size)
                                for c in codes])
                if lvl < len(parents):
                    codes = serialize.pooled_codes(codes, parents[lvl],
                                                   grids[lvl + 1].num)
        levels = [LevelPlan(grid=grd, cpe=sparse.ConvMap(
            "cube", grd, grd, kmap=sparse.build_kernel_map(grd, 3)),
            patches=pts) for grd, pts in zip(grids, patches)]
        for lp, parent, nxt in zip(levels, parents, grids[1:]):
            lp.parent, lp.n_next = parent, nxt.num
        return {"levels": levels, "stem": stem, "depth": depth}

    # ---- forward ------------------------------------------------------------

    def backbone(self, grid: sparse.SparseGrid, plan: dict) -> torch.Tensor:
        """(N, dec_channels[0]) features of the input voxels."""
        lv = plan["levels"]
        with trace.span("gpcr.encode.ptv3.stem"):
            kernel = self.embedding.conv.kernel
            x = None
            for i, cmap in enumerate(plan["stem"]):
                w = kernel[i * STEM_SLICE:(i + 1) * STEM_SLICE]
                (h,) = sparse.conv_map(cmap, [grid.feats], [w], [None])
                x = h if x is None else x + h
            x = F.gelu(self.embedding.norm(x))
        skips = []
        for st, stage in enumerate(self.enc):
            if st:
                with trace.span("gpcr.encode.ptv3.pool"):
                    prev = lv[st - 1]
                    x = segment.segment_max(stage.pool.proj(x), prev.parent,
                                            prev.n_next)
                    x = F.gelu(stage.pool.norm(x))
            for block in stage.blocks:
                x = block(x, lv[st])
            skips.append(x)
        for st in reversed(range(len(self.dec))):
            stage = self.dec[st]
            with trace.span("gpcr.encode.ptv3.unpool"):
                up = stage.unpool
                coarse = F.gelu(up.proj_norm(up.proj(x)))
                x = (F.gelu(up.skip_norm(up.skip(skips[st])))
                     + coarse.index_select(0, lv[st].parent))
            for block in stage.blocks:
                x = block(x, lv[st])
        return x

    def forward(self, grid: sparse.SparseGrid, plan: dict) -> torch.Tensor:
        return self.seg_head(self.backbone(grid, plan))
