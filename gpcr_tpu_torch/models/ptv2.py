"""Point Transformer V2 (Wu et al., "Point Transformer V2: Grouped Vector
Attention and Partition-based Pooling", NeurIPS 2022; Pointcept's
``point_transformer_v2m2_base.py``) as the learned renderer's backbone, for
inference.

- level 0 is the voxels' integer coordinates in the grid's code order;
  grid pooling to level l + 1 clusters level l by cells of ``grid_sizes[l]``
  voxels (torch_cluster's ``grid_cluster`` from the level's minimum), the
  clusters in ascending cell id, and level l + 1's coordinates are the
  clusters' mean coordinates; every level has its exact k nearest
  neighbours (``ops/knn.py``) and their relative positions ``0.02 (c_j -
  c_i)`` (metres at the published 0.02 m input grid);
- the patch embedding ``ReLU(BN(Linear(9 -> 48)))`` and its block (8
  neighbours); encoder stages: ``ReLU(BN(Linear))`` then a segment max
  over each cluster (grid pooling), and blocks; decoder stages: the
  coarse features' ``ReLU(BN(Linear))`` at each point's cluster plus the
  skip's ``ReLU(BN(Linear))`` (map unpooling), and blocks;
- the block: ``ReLU(BN(fc1))``, grouped vector attention
  (``ops/gva.py``: ``csrc/gva.cu`` on a card), ``ReLU(BN)``, ``BN(fc3)``,
  and ``ReLU`` of the residual sum;
- ``seg_head``: Linear, BN, ReLU, Linear to the splat parameters, in the
  input voxels' order.

``build_plan`` computes everything that depends on the geometry alone
(levels, clusters, neighbour lists and relative positions, float64 until
the positions are cast); the renderer keeps it per cloud. The Linears,
BatchNorm (evaluation, eps 1e-5), ReLU, the segment max and the unpooling
gathers are torch ops. Parameter names follow the benchmark reference
``cellbench/reference/ptv2.py``'s ``param_specs``.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import gva, knn, segment, sparse
from ..utils import trace
from .ptv3 import BatchNorm, _linear, _normal

BN_EPS = 1e-5
DELTA_SCALE = 0.02  # metres per voxel: Pointcept's base input grid
KNN_CELL = 3.0  # kNN cell width in point spacings (the level's grid size)


@dataclasses.dataclass(frozen=True)
class PTv2Config:
    """The backbone's widths; defaults are Pointcept's m2 base
    configuration (``configs/scannet/semseg-pt-v2m2-0-base.py``), grid
    sizes in voxels of the input grid."""

    in_channels: int = 9
    patch_embed_depth: int = 1
    patch_embed_channels: int = 48
    patch_embed_groups: int = 6
    patch_embed_neighbours: int = 8
    enc_depths: T.Tuple[int, ...] = (2, 2, 6, 2)
    enc_channels: T.Tuple[int, ...] = (96, 192, 384, 512)
    enc_groups: T.Tuple[int, ...] = (12, 24, 48, 64)
    enc_neighbours: T.Tuple[int, ...] = (16, 16, 16, 16)
    dec_depths: T.Tuple[int, ...] = (1, 1, 1, 1)
    dec_channels: T.Tuple[int, ...] = (48, 96, 192, 384)
    dec_groups: T.Tuple[int, ...] = (6, 12, 24, 48)
    dec_neighbours: T.Tuple[int, ...] = (16, 16, 16, 16)
    grid_sizes: T.Tuple[float, ...] = (3, 6, 12, 24)

    def level_neighbours(self) -> T.List[int]:
        """The largest k of each level's block sequences."""
        enc, dec = self.enc_neighbours, self.dec_neighbours
        out = [max(self.patch_embed_neighbours, dec[0])]
        for lvl in range(1, len(enc) + 1):
            out.append(max(enc[lvl - 1], dec[lvl] if lvl < len(dec) else 0))
        return out


def _bare_linear(cin: int, cout: int, generator) -> nn.Linear:
    lin = nn.Linear(cin, cout, bias=False)
    with torch.no_grad():
        lin.weight.copy_(_normal((cout, cin), cin, generator))
    return lin


class GroupedVectorAttention(nn.Module):
    def __init__(self, c: int, groups: int, generator):
        super().__init__()
        self.groups = groups
        self.linear_q = _linear(c, c, generator)
        self.norm_q = BatchNorm(c, BN_EPS)
        self.linear_k = _linear(c, c, generator)
        self.norm_k = BatchNorm(c, BN_EPS)
        self.linear_v = _linear(c, c, generator)
        self.pe_fc1 = _linear(3, c, generator)
        self.pe_norm = BatchNorm(c, BN_EPS)
        self.pe_fc2 = _linear(c, c, generator)
        self.we_fc1 = _linear(c, groups, generator)
        self.we_norm = BatchNorm(groups, BN_EPS)
        self.we_fc2 = _linear(groups, groups, generator)

    def folded(self) -> gva.Folded:
        def pair(lin):
            return lin.weight, lin.bias

        def stats(bn):
            return {"weight": bn.weight, "bias": bn.bias,
                    "running_mean": bn.running_mean,
                    "running_var": bn.running_var}

        return gva.fold(pair(self.pe_fc1), stats(self.pe_norm),
                        pair(self.pe_fc2), pair(self.we_fc1),
                        stats(self.we_norm), pair(self.we_fc2), BN_EPS)

    def forward(self, x, lv: "LevelPlan", k: int):
        q = F.relu(self.norm_q(self.linear_q(x)))
        kk = F.relu(self.norm_k(self.linear_k(x)))
        v = self.linear_v(x)
        return gva.grouped_vector_attention(q, kk, v, lv.nbr, lv.delta, k,
                                            self.folded())


class Block(nn.Module):
    def __init__(self, c: int, groups: int, generator):
        super().__init__()
        self.fc1 = _bare_linear(c, c, generator)
        self.norm1 = BatchNorm(c, BN_EPS)
        self.attn = GroupedVectorAttention(c, groups, generator)
        self.norm2 = BatchNorm(c, BN_EPS)
        self.fc3 = _bare_linear(c, c, generator)
        self.norm3 = BatchNorm(c, BN_EPS)

    def forward(self, x, lv: "LevelPlan", k: int):
        h = F.relu(self.norm1(self.fc1(x)))
        with trace.span("gpcr.encode.ptv2.gva"):
            h = self.attn(h, lv, k)
        h = self.norm3(self.fc3(F.relu(self.norm2(h))))
        return F.relu(x + h)


class Stage(nn.Module):
    """A block sequence (its neighbour count ``k``) after its entry modules
    (the patch embedding's projection, grid pooling's ``down`` or
    unpooling's ``up``), registered first."""

    def __init__(self, c: int, groups: int, depth: int, k: int, generator,
                 **entry: nn.Module):
        super().__init__()
        self.k = k
        for name, module in entry.items():
            setattr(self, name, module)
        self.blocks = nn.ModuleList([Block(c, groups, generator)
                                     for _ in range(depth)])

    def run(self, x, lv: "LevelPlan"):
        for block in self.blocks:
            x = block(x, lv, self.k)
        return x


class Down(nn.Module):
    def __init__(self, cin: int, cout: int, generator):
        super().__init__()
        self.fc = _bare_linear(cin, cout, generator)
        self.norm = BatchNorm(cout, BN_EPS)


class Up(nn.Module):
    def __init__(self, cin: int, cskip: int, cout: int, generator):
        super().__init__()
        self.proj = _linear(cin, cout, generator)
        self.proj_norm = BatchNorm(cout, BN_EPS)
        self.skip = _linear(cskip, cout, generator)
        self.skip_norm = BatchNorm(cout, BN_EPS)


class SegHead(nn.Module):
    def __init__(self, c: int, feat_dim: int, generator):
        super().__init__()
        self.fc1 = _linear(c, c, generator)
        self.norm = BatchNorm(c, BN_EPS)
        self.fc2 = _linear(c, feat_dim, generator)


@dataclasses.dataclass
class LevelPlan:
    """One level of the plan: its points, the k nearest neighbours of each
    (int32, (n, k) for the level's largest k, in (distance, index) order)
    and their relative positions (float32 (n, k, 3)), and (below the
    coarsest level) each point's cluster at the next level."""

    n: int
    nbr: torch.Tensor
    delta: torch.Tensor
    cluster: T.Optional[torch.Tensor] = None
    n_next: int = 0


def grid_cluster(c: torch.Tensor, size: float,
                 origin: T.Optional[float] = None) -> torch.Tensor:
    """(n,) int64 cluster of each point: cells of ``size`` counted from
    ``origin`` (torch_cluster's ``grid_cluster`` from the level's minimum
    without it; Minkowski's pooling counts from 0), clusters in ascending
    cell id."""
    start = c.min(dim=0).values if origin is None else origin
    rel = c - start
    cell = torch.floor(rel / size).long()
    dims = torch.floor(rel.max(dim=0).values / size).long() + 1
    ids = cell[:, 0] + dims[0] * cell[:, 1] + dims[0] * dims[1] * cell[:, 2]
    return torch.unique(ids, sorted=True, return_inverse=True)[1]


def members_table(cluster: torch.Tensor) -> torch.Tensor:
    """(m, most) int64: each cluster's members in ascending order, padded
    with n (a row past the end)."""
    n = cluster.shape[0]
    members = torch.argsort(cluster, stable=True)
    counts = torch.bincount(cluster)
    slot = (torch.arange(n, device=cluster.device)
            - (torch.cumsum(counts, 0) - counts)[cluster[members]])
    table = cluster.new_full((counts.shape[0], int(counts.max())), n)
    table[cluster[members], slot] = members
    return table


def ordered_mean(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(m, F) means of ``values`` (n, F) over ``members_table``'s rows, the
    members summed left to right in ascending order."""
    padded = torch.cat([values, values.new_zeros((1, values.shape[1]))])
    total = padded[table[:, 0]]
    for col in range(1, table.shape[1]):
        total = total + padded[table[:, col]]
    counts = (table < values.shape[0]).sum(dim=1)
    return total / counts[:, None].to(values.dtype)


def grid_pool(c: torch.Tensor, size: float):
    """(cluster (n,) int64, cluster coordinates (m, 3) float64):
    ``grid_cluster``'s clusters from the level's minimum and the members'
    mean coordinates."""
    cluster = grid_cluster(c, size)
    return cluster, ordered_mean(c, members_table(cluster))


class PointTransformerV2(nn.Module):
    """The backbone and its ``seg_head`` (to ``feat_dim`` channels). Built
    on the CPU from ``generator``; move it with ``.to(device)``."""

    def __init__(self, cfg: PTv2Config, feat_dim: int,
                 generator: T.Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        c0 = cfg.patch_embed_channels
        self.patch_embed = Stage(
            c0, cfg.patch_embed_groups, cfg.patch_embed_depth,
            cfg.patch_embed_neighbours, generator,
            proj=_bare_linear(cfg.in_channels, c0, generator),
            norm=BatchNorm(c0, BN_EPS))
        enc = [c0] + list(cfg.enc_channels)
        self.enc = nn.ModuleList([
            Stage(c, cfg.enc_groups[e], cfg.enc_depths[e],
                  cfg.enc_neighbours[e], generator,
                  down=Down(enc[e], c, generator))
            for e, c in enumerate(cfg.enc_channels)])
        dec = list(cfg.dec_channels) + [enc[-1]]
        self.dec = nn.ModuleList([
            Stage(c, cfg.dec_groups[d], cfg.dec_depths[d],
                  cfg.dec_neighbours[d], generator,
                  up=Up(dec[d + 1], enc[d], c, generator))
            for d, c in enumerate(cfg.dec_channels)])
        self.seg_head = SegHead(dec[0], feat_dim, generator)

    # ---- plan: geometry-only precomputation ---------------------------------

    def build_plan(self, grid: sparse.SparseGrid) -> dict:
        """Levels, clusters, neighbour lists and relative positions of one
        input coordinate set (``grid``'s voxels in code order). Raises where
        a level holds fewer points than its k."""
        cfg = self.cfg
        c = grid.coords().to(torch.float64)
        ks = cfg.level_neighbours()
        spacing = [1.0] + [float(s) for s in cfg.grid_sizes]
        levels = []
        for lvl, k in enumerate(ks):
            with trace.span("gpcr.encode.plan.knn"):
                nbr = knn.knn(c, k, KNN_CELL * spacing[lvl])
                delta = (DELTA_SCALE * (c[nbr] - c[:, None])).float()
            levels.append(LevelPlan(n=c.shape[0], nbr=nbr.int().contiguous(),
                                    delta=delta.contiguous()))
            if lvl < len(cfg.grid_sizes):
                with trace.span("gpcr.encode.plan.grid"):
                    cluster, c = grid_pool(c, float(cfg.grid_sizes[lvl]))
                levels[-1].cluster, levels[-1].n_next = cluster, c.shape[0]
        return {"levels": levels}

    # ---- forward ------------------------------------------------------------

    def backbone(self, grid: sparse.SparseGrid, plan: dict) -> torch.Tensor:
        """(N, dec_channels[0]) features of the input voxels."""
        lv = plan["levels"]
        with trace.span("gpcr.encode.ptv2.embed"):
            pe = self.patch_embed
            x = F.relu(pe.norm(pe.proj(grid.feats)))
        x = pe.run(x, lv[0])
        skips = [x]
        for e, stage in enumerate(self.enc):
            with trace.span("gpcr.encode.ptv2.pool"):
                h = F.relu(stage.down.norm(stage.down.fc(x)))
                x = segment.segment_max(h, lv[e].cluster, lv[e].n_next)
            x = stage.run(x, lv[e + 1])
            skips.append(x)
        for d in reversed(range(len(self.dec))):
            stage = self.dec[d]
            with trace.span("gpcr.encode.ptv2.unpool"):
                up = stage.up
                coarse = F.relu(up.proj_norm(up.proj(x)))
                x = (coarse.index_select(0, lv[d].cluster)
                     + F.relu(up.skip_norm(up.skip(skips[d]))))
            x = stage.run(x, lv[d])
        return x

    def forward(self, grid: sparse.SparseGrid, plan: dict) -> torch.Tensor:
        x = self.backbone(grid, plan)
        with trace.span("gpcr.encode.ptv2.head"):
            h = self.seg_head
            return h.fc2(F.relu(h.norm(h.fc1(x))))
