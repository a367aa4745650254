"""Plain PyTorch reference of the learned renderer's network, written from
the published description (PCGC-style sparse U-Net of ``model_v2.py``,
MinkowskiEngine semantics) and imported by nothing of the program:

- voxelisation: round the grid coordinates, clamp to [0, 1023], and
  average the input features of the points that share a voxel;
- the coordinate hierarchy: parents are the unique ``coord >> 1``;
  voxels of a level are kept in ascending (x, y, z) order;
- kernel maps: for each of the 27 offsets (first axis fastest, the
  MinkowskiEngine order) the pairs (voxel, neighbour) that exist;
- the U-Net: 3x3x3 convolutions as a sum over offsets of gathered rows
  times that offset's weight; the stride-2 down convolution sums
  ``W[octant] @ child`` into each parent and the generative transposed
  convolution gives each finer voxel ``W[octant] @ parent``, octant =
  (x & 1) * 4 + (y & 1) * 2 + (z & 1); InceptionResNet blocks;
- the head: rotation = f + (1, 0, 0, 0), scale = max(f + 1, 0), offset
  = f, normal = f / |f| (0 where |f| = 0), SH DC = (rgb - 0.5) / C0 of the
  voxel's mean colour with zero higher-order rows.

Everything is float32 on the inputs' device. ``flops`` counts the useful
multiply-adds of one pass (2 * Cin * Cout per existing kernel-map pair).
"""

from __future__ import annotations

import math

import torch

GRID = 1024
SH_C0 = 0.28209479177387814


def _key(c: torch.Tensor) -> torch.Tensor:
    return (c[:, 0] * GRID + c[:, 1]) * GRID + c[:, 2]


def _unkey(k: torch.Tensor) -> torch.Tensor:
    return torch.stack([k // (GRID * GRID), (k // GRID) % GRID, k % GRID], 1)


def voxelize(coords: torch.Tensor, feats: torch.Tensor):
    """(N, 3) float grid coordinates, (N, F) features -> (V, 3) int64
    voxels in ascending order and their (V, F) mean features."""
    q = torch.clamp(torch.round(coords), 0, GRID - 1).long()
    keys, inv = torch.unique(_key(q), sorted=True, return_inverse=True)
    total = torch.zeros((keys.numel(), feats.shape[1]), dtype=feats.dtype,
                        device=feats.device).index_add_(0, inv, feats)
    count = torch.bincount(inv, minlength=keys.numel()).to(feats.dtype)
    return _unkey(keys), total / count[:, None]


def input_features(coords, rgb, scale_factor: float, offset: float = 512.0):
    """The 9 input channels: world position (coords - offset) / scale
    factor, the rounding residual coords - round(coords), and rgb."""
    return torch.cat([(coords - offset) / scale_factor,
                      coords - torch.round(coords), rgb], dim=1)


def _octant(c: torch.Tensor) -> torch.Tensor:
    return (c[:, 0] & 1) * 4 + (c[:, 1] & 1) * 2 + (c[:, 2] & 1)


class Level:
    """One resolution level: its voxels and its 27-neighbour pairs."""

    def __init__(self, coords: torch.Tensor):
        self.coords = coords
        self.n = coords.shape[0]
        keys = _key(coords)
        r = torch.arange(-1, 2, device=coords.device)
        # offset o = ix + 3 iy + 9 iz: the first axis varies fastest
        offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1)
        offs = offs.permute(2, 1, 0, 3).reshape(27, 3)
        self.pairs = []  # per offset: (rows, neighbour rows)
        for o in range(27):
            q = coords + offs[o]
            inside = ((q >= 0) & (q < GRID)).all(1)
            pos = torch.searchsorted(keys, _key(q.clamp(0, GRID - 1)))
            pos = pos.clamp(max=self.n - 1)
            hit = inside & (keys[pos] == _key(q.clamp(0, GRID - 1)))
            rows = torch.nonzero(hit)[:, 0]
            self.pairs.append((rows, pos[rows]))
        self.hits = sum(int(r.numel()) for r, _ in self.pairs)


def hierarchy(coords0: torch.Tensor, levels: int = 4):
    """Levels 0..levels-1 and, per transition, (parent index, octant) of
    every child voxel."""
    lv = [Level(coords0)]
    links = []
    c = coords0
    for _ in range(levels - 1):
        keys, inv = torch.unique(_key(c >> 1), sorted=True,
                                 return_inverse=True)
        links.append((inv, _octant(c)))
        c = _unkey(keys)
        lv.append(Level(c))
    return lv, links


def param_specs(channels, feat_dim: int, blocks: int = 3):
    """(name, kernel volume, Cin, Cout) of every convolution, by the
    published module names (``conv0``, ``block0.1.conv0_0``, ...)."""
    c = list(channels)
    out = []

    def conv(name, k, cin, cout):
        out.append((name, k, cin, cout))

    def block(prefix, ch):
        for i in range(blocks):
            p = f"{prefix}.{i}."
            conv(p + "conv0_0", 27, ch, ch // 4)
            conv(p + "conv0_1", 27, ch // 4, ch // 2)
            conv(p + "conv1_0", 1, ch, ch // 4)
            conv(p + "conv1_1", 27, ch // 4, ch // 4)
            conv(p + "conv1_2", 1, ch // 4, ch // 2)

    conv("conv0", 27, c[0], c[1])
    conv("down0", 8, c[1], c[2])
    block("block0", c[2])
    conv("conv1", 27, c[2], c[2])
    conv("down1", 8, c[2], c[3])
    block("block1", c[3])
    conv("conv2", 27, c[3], c[3])
    conv("down2", 8, c[3], c[4])
    block("block2", c[4])
    conv("conv3", 27, c[4], c[5])
    conv("up0", 8, c[5], c[3])
    conv("conv_0", 27, c[3] * 2, c[3])
    block("block_0", c[3])
    conv("up1", 8, c[3], c[2])
    conv("conv_1", 27, c[2] * 2, c[2])
    block("block_1", c[2])
    conv("up2", 8, c[2], c[1])
    conv("conv_2", 27, c[1] * 2, c[1])
    block("block_2", c[1])
    conv("conv_3", 27, c[1], feat_dim)
    return out


def make_weights(channels, feat_dim: int, generator: torch.Generator,
                 device) -> dict:
    """Seeded weights, He-normal kernels (std sqrt(2 / (K * Cin))) and
    zero biases, drawn in one call on ``device``: {"<conv>.kernel": (K,
    Cin, Cout), "<conv>.bias": (Cout,)}."""
    specs = param_specs(channels, feat_dim)
    sizes = [k * ci * co for _, k, ci, co in specs]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, k, ci, co), s in zip(specs, sizes):
        out[name + ".kernel"] = (flat[at:at + s].view(k, ci, co)
                                 * math.sqrt(2.0 / (k * ci)))
        out[name + ".bias"] = torch.zeros(co, device=device)
        at += s
    return out


class UNet:
    """The 3-level sparse U-Net over a hierarchy, counting its flops."""

    def __init__(self, weights: dict, levels, links):
        self.w = weights
        self.lv = levels
        self.links = links
        self.flops = 0

    def _k(self, name):
        return self.w[name + ".kernel"], self.w[name + ".bias"]

    def conv3(self, name, x, lvl):
        w, b = self._k(name)
        level = self.lv[lvl]
        out = torch.zeros((level.n, w.shape[2]), device=x.device)
        for o, (rows, nbr) in enumerate(level.pairs):
            out.index_add_(0, rows, x[nbr] @ w[o])
        self.flops += 2 * level.hits * w.shape[1] * w.shape[2]
        return out + b

    def conv1(self, name, x):
        w, b = self._k(name)
        self.flops += 2 * x.shape[0] * w.shape[1] * w.shape[2]
        return x @ w[0] + b

    def down(self, name, x, lvl):
        w, b = self._k(name)
        parent, octant = self.links[lvl]
        out = torch.zeros((self.lv[lvl + 1].n, w.shape[2]), device=x.device)
        for o in range(8):
            rows = torch.nonzero(octant == o)[:, 0]
            out.index_add_(0, parent[rows], x[rows] @ w[o])
        self.flops += 2 * x.shape[0] * w.shape[1] * w.shape[2]
        return out + b

    def up(self, name, x, lvl_fine):
        w, b = self._k(name)
        parent, octant = self.links[lvl_fine]
        out = torch.zeros((parent.numel(), w.shape[2]), device=x.device)
        for o in range(8):
            rows = torch.nonzero(octant == o)[:, 0]
            out[rows] = x[parent[rows]] @ w[o]
        self.flops += 2 * parent.numel() * w.shape[1] * w.shape[2]
        return out + b

    def block(self, prefix, x, lvl):
        for i in range(3):
            p = f"{prefix}.{i}."
            h1 = torch.relu(self.conv1(p + "conv1_0", x))
            a = torch.relu(self.conv3(p + "conv0_0", x, lvl))
            out0 = self.conv3(p + "conv0_1", a, lvl)
            h2 = torch.relu(self.conv3(p + "conv1_1", h1, lvl))
            out1 = self.conv1(p + "conv1_2", h2)
            x = torch.cat([out0, out1], 1) + x
        return x

    def __call__(self, x):
        relu = torch.relu
        out_x = relu(self.conv3("conv0", x, 0))
        f1 = self.block("block0", relu(self.down("down0", out_x, 0)), 1)
        h = relu(self.conv3("conv1", f1, 1))
        f2 = self.block("block1", relu(self.down("down1", h, 1)), 2)
        h = relu(self.conv3("conv2", f2, 2))
        f3 = self.block("block2", relu(self.down("down2", h, 2)), 3)
        f3 = self.conv3("conv3", f3, 3)
        u = relu(self.up("up0", f3, 2))
        f2d = relu(self.conv3("conv_0", torch.cat([u, f2], 1), 2))
        f2d = self.block("block_0", f2d, 2)
        u = relu(self.up("up1", f2d, 1))
        f1d = relu(self.conv3("conv_1", torch.cat([u, f1], 1), 1))
        f1d = self.block("block_1", f1d, 1)
        u = relu(self.up("up2", f1d, 0))
        f0d = relu(self.conv3("conv_2", torch.cat([u, out_x], 1), 0))
        f0d = self.block("block_2", f0d, 0)
        return self.conv3("conv_3", f0d, 0)


def splats(coords, rgb, weights: dict, channels, scale_factor: float,
           offset: float = 512.0) -> dict:
    """The learned splats of a cloud in grid units, with the layout the
    head gives for rotation, scale, offset and normal (13 channels):
    {"xyz", "rotation", "scale", "normal", "sh" (V, 4, 3), "flops",
    "voxels"}."""
    vox, feats = voxelize(coords, input_features(coords, rgb, scale_factor,
                                                 offset))
    levels, links = hierarchy(vox)
    net = UNet(weights, levels, links)
    f = net(feats)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=f.device)
    normal = f[:, 10:13]
    norm2 = (normal ** 2).sum(1, keepdim=True)
    normal = torch.where(
        norm2 > 0, normal / torch.sqrt(torch.where(norm2 > 0, norm2, 1.0)),
        torch.zeros_like(normal))
    sh = torch.zeros((vox.shape[0], 4, 3), device=f.device)
    sh[:, 0] = (feats[:, -3:] - 0.5) / SH_C0
    return {
        "xyz": vox.to(torch.float32) + f[:, 7:10],
        "rotation": f[:, 0:4] + ident,
        "scale": torch.clamp(f[:, 4:7] + 1.0, min=0.0),
        "normal": normal,
        "sh": sh,
        "flops": net.flops,
        "voxels": int(vox.shape[0]),
    }
