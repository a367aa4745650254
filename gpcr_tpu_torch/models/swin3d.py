"""Swin3D (Yang et al., "Swin3D: A Pretrained Transformer Backbone for 3D
Indoor Scene Understanding", arXiv:2304.06906; Pointcept's
``swin3d_v1m1_base.py``, ``Swin3DUNet``) as the learned renderer's
backbone, for inference (drop path off).

- levels: level 0 is the voxels' integer cells in the grid's code order;
  level l + 1 is the occupied cells of ``floor(cell_0 / s_(l+1))``, s = 3,
  6, 12, 24 (stride 3, then 2: Minkowski's pooling, cells counted from 0),
  in ascending cell id (``ptv2.grid_cluster`` with origin 0); each level's
  position is its members' mean position one level down, in voxels of the
  input grid (level 0: the voxel itself), and its colour the members' mean
  colour (level 0: the voxel's mean rgb), both summed in ascending member
  order in float64;
- the stem ``ReLU(BN(SubMConv3d_3^3(9 -> 48, no bias)))`` on
  ``sparse.conv_map`` (``csrc/sparse_conv.cu`` on a card);
- the block ``x += proj(WA(LN(x)))``, ``x += fc2(GELU(fc1(LN(x))))``, its
  window attention with cRSE over the level's windows of w cells,
  shifted by ``w // 2`` in every other block of a stage
  (``ops/swin_attn.py``: ``csrc/swin_attn.cu`` on a card); the signals of
  a level are its position in its own cells and its colour as Pointcept
  feeds it, ``(2 rgb - 1) / 1.001``;
- ``GridKNNDownsample``: ``Linear_nobias(LN(x))`` of the 16 nearest points
  one level down of each coarse point, max over them; ``Upsample``
  ("linear_attn"): ``Linear(LN(skip)) + sum_j w_ij Linear(LN(coarse))_j``
  over each fine point's 3 nearest coarse points, ``w = 1 / (d + 1e-8)``
  normalised, then one unshifted block; nearest by position, in
  (distance, index) order, in float64 (``ops/knn.py``);
- the classifier: Linear, BN, ReLU, Linear to the splat parameters, in the
  input voxels' order.

``build_plan`` computes what depends on the geometry alone (the levels,
their two partitions into windows, the kNN lists and the interpolation
weights); the renderer keeps it per cloud. The colours are averaged in
every encode, from the features. LayerNorm (eps 1e-5), BatchNorm
(evaluation, eps 1e-5), GELU, the Linears, the max and the interpolation
are torch ops. Parameter names follow the benchmark reference
``cellbench/reference/swin3d.py``'s ``param_specs``.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import knn, sparse, swin_attn
from ..utils import trace
from .ptv2 import grid_cluster, members_table, ordered_mean
from .ptv3 import BatchNorm, SubMConv, _linear, _normal

LN_EPS = BN_EPS = 1e-5
MLP_RATIO = 4
DOWN_K = 16  # GridKNNDownsample's neighbours
COLOR_WINDOW = 2  # the colour signal's range, (2 rgb - 1) / 1.001 in (-1, 1)
COLOR_DIV = 1.001
KNN_CELL = 3.0  # kNN cell width in spacings of the searched level
INTERP_EPS = 1e-8


@dataclasses.dataclass(frozen=True)
class Swin3DConfig:
    """The backbone's settings; defaults are Pointcept's Swin3D-S
    (``configs/scannet/semseg-swin3d-v1m1-0-small.py``). Only the forms that
    configuration uses are built: the others raise."""

    in_channels: int = 9
    depths: T.Tuple[int, ...] = (2, 4, 9, 4, 4)
    channels: T.Tuple[int, ...] = (48, 96, 192, 384, 384)
    num_heads: T.Tuple[int, ...] = (6, 6, 12, 24, 24)
    window_sizes: T.Tuple[int, ...] = (5, 7, 7, 7, 7)
    quant_size: int = 4
    down_stride: int = 3
    up_k: int = 3
    knn_down: bool = True
    stem_transformer: bool = True
    upsample: str = "linear_attn"
    cRSE: str = "XYZ_RGB"
    fp16_mode: int = 0

    def __post_init__(self):
        forms = (self.knn_down, self.stem_transformer, self.upsample,
                 self.cRSE, self.fp16_mode)
        if forms != (True, True, "linear_attn", "XYZ_RGB", 0):
            raise NotImplementedError(
                f"Swin3D with knn_down, stem_transformer, upsample, cRSE, "
                f"fp16_mode = {forms}: only Swin3D-S's (True, True, "
                f"'linear_attn', 'XYZ_RGB', 0) is built")

    def strides(self) -> T.List[int]:
        """Each level's cell in voxels of the input grid."""
        out = [1]
        for lvl in range(1, len(self.channels)):
            out.append(out[-1] * (self.down_stride if lvl == 1 else 2))
        return out


class WindowAttention(nn.Module):
    def __init__(self, c: int, heads: int, window: int, quant: int,
                 generator):
        super().__init__()
        d = c // heads
        self.heads = heads
        self.lp, self.lc = 2 * window * quant, 2 * COLOR_WINDOW * 2 * quant
        self.qp, self.qc = float(quant), float(2 * quant)
        self.qkv = _linear(c, 3 * c, generator)
        for kind in ("query", "key", "value"):
            for sig, length in (("xyz", self.lp), ("rgb", self.lc)):
                table = 0.02 * torch.randn((3, length, heads, d),
                                           generator=generator)
                setattr(self, f"{kind}_{sig}_table", nn.Parameter(table))
        self.proj = _linear(c, c, generator)

    def tables(self) -> swin_attn.Tables:
        def rows(kind):
            xyz, rgb = (getattr(self, f"{kind}_{s}_table") for s in ("xyz",
                                                                     "rgb"))
            return torch.cat([xyz.flatten(0, 1), rgb.flatten(0, 1)])

        return swin_attn.Tables(q=rows("query"), k=rows("key"),
                                v=rows("value"), lp=self.lp, lc=self.lc,
                                qp=self.qp, qc=self.qc)


class MLP(nn.Module):
    def __init__(self, c: int, generator):
        super().__init__()
        self.fc1 = _linear(c, MLP_RATIO * c, generator)
        self.fc2 = _linear(MLP_RATIO * c, c, generator)


class Block(nn.Module):
    def __init__(self, c, heads, window, quant, generator):
        super().__init__()
        self.norm1 = nn.LayerNorm(c, eps=LN_EPS)
        self.attn = WindowAttention(c, heads, window, quant, generator)
        self.norm2 = nn.LayerNorm(c, eps=LN_EPS)
        self.mlp = MLP(c, generator)

    def forward(self, x, win: swin_attn.Windows, sig):
        with trace.span("gpcr.encode.swin3d.attn"):
            qkv = self.attn.qkv(self.norm1(x))
            h = swin_attn.window_attention(qkv, win, sig, self.attn.tables(),
                                           self.attn.heads)
            x = x + self.attn.proj(h)
        with trace.span("gpcr.encode.swin3d.mlp"):
            return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class GridKNNDownsample(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.norm = nn.LayerNorm(cin, eps=LN_EPS)
        self.linear = nn.Linear(cin, cout, bias=False)
        with torch.no_grad():
            self.linear.weight.copy_(_normal((cout, cin), cin, generator))

    def forward(self, x, nbr):
        """Max of ``Linear(LN(x))`` over each coarse point's rows ``nbr``
        (m, k) of ``x``."""
        y = self.linear(self.norm(x))
        out = y.index_select(0, nbr[:, 0])
        for t in range(1, nbr.shape[1]):
            out = torch.maximum(out, y.index_select(0, nbr[:, t]))
        return out


class BasicLayer(nn.Module):
    """A stage's blocks (shift ``w // 2`` in odd blocks) and, below the
    coarsest level, its downsampling to the next."""

    def __init__(self, c, depth, heads, window, quant, generator,
                 cout: T.Optional[int] = None):
        super().__init__()
        self.blocks = nn.ModuleList([Block(c, heads, window, quant, generator)
                                     for _ in range(depth)])
        if cout is not None:
            self.downsample = GridKNNDownsample(c, cout, generator)

    def run(self, x, lv: "LevelPlan", sig):
        for b, block in enumerate(self.blocks):
            x = block(x, lv.windows[b % 2], sig)
        return x


class Upsample(nn.Module):
    def __init__(self, cin, cout, heads, window, quant, generator):
        super().__init__()
        self.linear1 = nn.Sequential(nn.LayerNorm(cout, eps=LN_EPS),
                                     _linear(cout, cout, generator))
        self.linear2 = nn.Sequential(nn.LayerNorm(cin, eps=LN_EPS),
                                     _linear(cin, cout, generator))
        self.block = BasicLayer(cout, 1, heads, window, quant, generator)

    def forward(self, coarse, skip, lv: "LevelPlan"):
        """``skip``'s level's features from the level above's ``coarse``."""
        z = self.linear2(coarse)
        x = self.linear1(skip)
        for t in range(lv.up_nbr.shape[1]):
            x = x + lv.up_w[:, t:t + 1] * z.index_select(0, lv.up_nbr[:, t])
        return x


class Stem(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.conv = SubMConv(27, cin, cout, False, generator)
        self.norm = BatchNorm(cout, BN_EPS)


@dataclasses.dataclass
class LevelPlan:
    """One level of the plan: its cells (int64, counted from 0), positions
    (float64, voxels of the input grid) and position signals (float32, in
    the level's cells), its windows unshifted and shifted, each point's
    16 nearest points one level down (the downsampling's rows) and its
    ``up_k`` nearest one level up with their weights, and the members of
    each cluster of the next level."""

    n: int
    cells: torch.Tensor
    pos: torch.Tensor
    sig_pos: torch.Tensor
    windows: T.Tuple[swin_attn.Windows, swin_attn.Windows]
    down_nbr: T.Optional[torch.Tensor] = None
    up_nbr: T.Optional[torch.Tensor] = None
    up_w: T.Optional[torch.Tensor] = None
    members: T.Optional[torch.Tensor] = None


def coarsen(cells: torch.Tensor, pos: torch.Tensor, ratio: int):
    """(next cells, next positions, members table) of a level whose cells
    are grouped by ``ratio`` per axis."""
    cluster = grid_cluster(cells.to(torch.float64), float(ratio), 0.0)
    table = members_table(cluster)
    nxt = torch.div(cells[table[:, 0]], ratio, rounding_mode="floor")
    return nxt, ordered_mean(pos, table), table


def interpolation_weights(fine, coarse, nbr):
    """(n, k) float32: ``1 / (d + 1e-8)`` of each fine point's distances to
    its coarse rows ``nbr``, normalised, in float64."""
    d = coarse[nbr] - fine[:, None]
    dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                      + d[..., 2] * d[..., 2])
    w = 1.0 / (dist + INTERP_EPS)
    return (w / w.sum(dim=1, keepdim=True)).float()


class Swin3DUNet(nn.Module):
    """The backbone and its classifier (to ``feat_dim`` channels). Built on
    the CPU from ``generator``; move it with ``.to(device)``."""

    def __init__(self, cfg: Swin3DConfig, feat_dim: int,
                 generator: T.Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        ch, q = cfg.channels, cfg.quant_size
        top = len(ch) - 1
        self.stem_layer = Stem(cfg.in_channels, ch[0], generator)
        self.layers = nn.ModuleList([
            BasicLayer(ch[i], cfg.depths[i], cfg.num_heads[i],
                       cfg.window_sizes[i], q, generator,
                       cout=ch[i + 1] if i < top else None)
            for i in range(len(ch))])
        self.upsamples = nn.ModuleList([
            Upsample(ch[i], ch[i - 1], cfg.num_heads[i - 1],
                     cfg.window_sizes[i - 1], q, generator)
            for i in range(top, 0, -1)])
        self.classifier = nn.Sequential(
            _linear(ch[0], ch[0], generator), BatchNorm(ch[0], BN_EPS),
            nn.ReLU(), _linear(ch[0], feat_dim, generator))

    # ---- plan: geometry-only precomputation ---------------------------------

    def build_plan(self, grid: sparse.SparseGrid) -> dict:
        """Levels, windows, kNN lists and interpolation weights of one input
        coordinate set (``grid``'s voxels in code order). Raises where a
        level holds fewer points than a neighbour count."""
        cfg = self.cfg
        strides = cfg.strides()
        cells = grid.coords()
        pos = cells.to(torch.float64)
        levels = []
        for lvl, stride in enumerate(strides):
            w = cfg.window_sizes[lvl]
            with trace.span("gpcr.encode.plan.window"):
                windows = (swin_attn.partition(cells, w, 0),
                           swin_attn.partition(cells, w, w // 2))
            lv = LevelPlan(n=cells.shape[0], cells=cells, pos=pos,
                           sig_pos=(pos / stride).float().contiguous(),
                           windows=windows)
            if lvl:
                below = levels[-1]
                with trace.span("gpcr.encode.plan.knn"):
                    lv.down_nbr = knn.knn(below.pos, DOWN_K,
                                          KNN_CELL * strides[lvl - 1], pos)
                    below.up_nbr = knn.knn(pos, cfg.up_k, KNN_CELL * stride,
                                           below.pos)
                    below.up_w = interpolation_weights(below.pos, pos,
                                                       below.up_nbr)
            levels.append(lv)
            if lvl + 1 < len(strides):
                with trace.span("gpcr.encode.plan.window"):
                    cells, pos, lv.members = coarsen(
                        cells, pos, strides[lvl + 1] // stride)
        wins = [w for lv in levels for w in lv.windows]
        trace.count("swin_windows", sum(w.count for w in wins))
        trace.count("swin_window_max", max(w.most for w in wins))
        stem = sparse.ConvMap("cube", grid, grid,
                              kmap=sparse.build_kernel_map(grid, 3))
        return {"levels": levels, "stem": stem}

    # ---- forward ------------------------------------------------------------

    @staticmethod
    def signals(grid: sparse.SparseGrid, plan: dict) -> T.List[torch.Tensor]:
        """Per level (n, 6) float32: position in the level's cells, colour
        ``(2 rgb - 1) / 1.001`` of the members' mean rgb."""
        col = grid.feats[:, -3:].to(torch.float64)
        out = []
        for lvl, lv in enumerate(plan["levels"]):
            if lvl:
                col = ordered_mean(col, plan["levels"][lvl - 1].members)
            out.append(torch.cat([lv.sig_pos, ((2.0 * col - 1.0) / COLOR_DIV
                                               ).float()], 1).contiguous())
        return out

    def backbone(self, grid: sparse.SparseGrid, plan: dict) -> torch.Tensor:
        """(N, channels[0]) features of the input voxels."""
        lv = plan["levels"]
        sig = self.signals(grid, plan)
        with trace.span("gpcr.encode.swin3d.stem"):
            stem = self.stem_layer
            (h,) = sparse.conv_map(plan["stem"], [grid.feats],
                                   [stem.conv.kernel], [None])
            x = F.relu(stem.norm(h))
        skips = []
        for i, layer in enumerate(self.layers):
            x = layer.run(x, lv[i], sig[i])
            skips.append(x)
            if hasattr(layer, "downsample"):
                with trace.span("gpcr.encode.swin3d.down"):
                    x = layer.downsample(x, lv[i + 1].down_nbr)
        for u, up in enumerate(self.upsamples):
            i = len(self.layers) - 2 - u  # the level it upsamples to
            with trace.span("gpcr.encode.swin3d.up"):
                x = up(x, skips[i], lv[i])
            x = up.block.run(x, lv[i], sig[i])
        return x

    def forward(self, grid: sparse.SparseGrid, plan: dict) -> torch.Tensor:
        x = self.backbone(grid, plan)
        with trace.span("gpcr.encode.swin3d.head"):
            return self.classifier(x)
