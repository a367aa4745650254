"""Plain PyTorch reference of Point Transformer V2 as the learned renderer's
backbone, written from the published description (Wu, Lao, Jiang, Liu,
Zhao, "Point Transformer V2: Grouped Vector Attention and Partition-based
Pooling", NeurIPS 2022; Pointcept's ``point_transformer_v2m2_base.py`` and
``configs/scannet/semseg-pt-v2m2-0-base.py``) and imported by nothing of
the program. Float32 on the inputs' device; callers pin TF32 off. Every
module runs in evaluation: BatchNorm (eps 1e-5) with its running
statistics, drop path and attention dropout identities.

- voxelisation and input features: ``network.voxelize`` and
  ``network.input_features`` (the renderer's 9 channels, averaged per
  voxel); level 0 is the voxels' integer coordinates, in ascending
  (x, y, z) order;
- geometry, in float64: grid pooling with grid size s (voxels) takes
  ``start = min(c)`` per axis, ``cell = floor((c - start) / s)``, the
  linear id ``x + y nx + z nx ny`` with ``n = floor(max(c - start) / s) +
  1`` per axis (torch_cluster's ``grid_cluster``), clusters the sorted
  unique ids; the next level's coordinates are the mean of the members'
  coordinates, summed left to right in ascending member order; kNN by
  brute force: squared distance ``dx^2 + dy^2 + dz^2`` in float64, each
  point its own first neighbour, neighbours in (distance, index) order;
- the block: ``x = ReLU(BN1(fc1(x)))``, grouped vector attention,
  ``ReLU(BN2(.))``, ``BN3(fc3(.))``, ``ReLU(x0 + .)``; the attention:
  ``q = ReLU(BN(Wq x + bq))``, ``k`` likewise, ``v = Wv x + bv``; per
  point i and neighbour j, ``pe = fc2(ReLU(BN(fc1(delta))))`` of the
  relative position ``delta = float32(0.02 (c_j - c_i))`` (metres at
  the published 0.02 m input grid), ``rel = k_j - q_i + pe``, the weight
  ``Linear(G -> G)(ReLU(BN(Linear(C -> G)(rel))))``, a softmax over the
  neighbours per group, and ``sum_j a_jg (v_j + pe)`` per group of C / G
  channels; written unfolded, in blocks of points so that (block, k, C)
  tensors fit;
- the network: the patch embedding ``ReLU(BN(Linear(9 -> 48)))`` and its
  block at level 0 (8 neighbours); encoder stage e pools level e to e + 1
  (``ReLU(BN(Linear))`` then a max over each cluster) and runs its blocks;
  decoder stage d unpools level d + 1 to d (``ReLU(BN(Linear(coarse)))``
  at each point's cluster plus ``ReLU(BN(Linear(skip)))``) and runs its
  blocks; the seg head ``Linear, BN, ReLU, Linear`` to the 13 splat
  parameters; the splat split as ``network.splats``.

Departures from Pointcept, fixed by the renderer or by determinism: the
level-0 coordinates are integer voxel positions (Pointcept's are the
sampled points' positions in metres), grid sizes are in voxels (its
0.06-0.48 m over 0.02 m voxels) and the relative positions are scaled by
0.02 into metres; the geometry is float64 with the (distance, index) tie
rule and an ordered mean (Pointcept: float32 and ``segment_csr`` over an
unstable sort); a level with fewer than k points is refused (Pointcept
pads with -1); 9 input channels and a 13-channel head (ScanNet has 6 and
20 classes); one cloud, no batch.

``flops`` counts one pass: 2 in out per row and Linear outside the
attention, and for each grouped vector attention the least work of
``gva_work`` (the folded count below). The fold: the weight encoding's
first Linear with its BN, ``M`` (G x C), is linear in ``rel``, so ``M q``
and ``M k`` are taken once per point (4 G C), the position MLP's hidden
vector ``h`` goes straight to G logits through ``P = M W2`` (2 G C per
pair), and ``W2`` is applied once per point (2 C^2) to the per-group sums
``sum_j a_jg h_j`` (2 G C per pair).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .network import SH_C0, input_features, voxelize
from .ptv3 import HEAD_SHAPE_GAIN, HEAD_SHAPE_ROWS

BN_EPS = 1e-5
DELTA_SCALE = 0.02  # metres per voxel: Pointcept's base input grid
PAIR_BUDGET = 1 << 25  # float32 values per (block, k, C) tensor
KNN_BUDGET = 1 << 28  # float64 screening keys per block of queries
KNN_SLACK = 48  # candidates screened beyond k before the exact order

# the published m2 base configuration; grid sizes in voxels (0.06, 0.12,
# 0.24, 0.48 m over the 0.02 m input grid)
BASE = {
    "in_channels": 9,
    "patch_embed_depth": 1, "patch_embed_channels": 48,
    "patch_embed_groups": 6, "patch_embed_neighbours": 8,
    "enc_depths": [2, 2, 6, 2], "enc_channels": [96, 192, 384, 512],
    "enc_groups": [12, 24, 48, 64], "enc_neighbours": [16, 16, 16, 16],
    "dec_depths": [1, 1, 1, 1], "dec_channels": [48, 96, 192, 384],
    "dec_groups": [6, 12, 24, 48], "dec_neighbours": [16, 16, 16, 16],
    "grid_sizes": [3, 6, 12, 24],
}


def settings(info: dict) -> dict:
    """The backbone's settings from a ``pcml_info`` dict, base values for
    keys it does not give."""
    return {k: info.get(k, v) for k, v in BASE.items()}


def level_neighbours(s: dict) -> list:
    """The largest k that each level's block sequences use: level 0 the
    patch embedding's and decoder stage 0's, level l the encoder stage
    that pools into it and decoder stage l."""
    enc, dec = s["enc_neighbours"], s["dec_neighbours"]
    out = [max(s["patch_embed_neighbours"], dec[0])]
    for lvl in range(1, len(enc) + 1):
        out.append(max(enc[lvl - 1], dec[lvl] if lvl < len(dec) else 0))
    return out


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------


def grid_pool(c: torch.Tensor, size: float):
    """(cluster (n,) int64 of each point, coordinates (m, 3) float64 of the
    m clusters)."""
    start = c.min(dim=0).values
    rel = c - start
    cell = torch.floor(rel / size).long()
    dims = torch.floor(rel.max(dim=0).values / size).long() + 1
    ids = cell[:, 0] + cell[:, 1] * dims[0] + cell[:, 2] * dims[0] * dims[1]
    _, cluster = torch.unique(ids, sorted=True, return_inverse=True)
    m = int(cluster.max()) + 1
    # members in ascending index order per cluster, summed left to right
    counts = torch.bincount(cluster, minlength=m)
    members = torch.argsort(cluster, stable=True)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(c.shape[0], device=c.device) - first[cluster[members]]
    table = torch.zeros((m, int(counts.max()), 3), dtype=c.dtype,
                        device=c.device)
    table[cluster[members], slot] = c[members]
    total = table[:, 0]
    for col in range(1, table.shape[1]):
        total = total + table[:, col]
    return cluster, total / counts[:, None].to(c.dtype)


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = b - a
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _ordered(d2: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the first k of ``idx`` in (d2, idx) order."""
    by_idx = torch.argsort(idx, dim=1)
    d2, idx = d2.gather(1, by_idx), idx.gather(1, by_idx)
    by_d = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    return idx.gather(1, by_d)


def knn(c: torch.Tensor, k: int) -> torch.Tensor:
    """(n, k) int64 neighbours of every point of ``c`` (n, 3) float64 by
    brute force over blocks of queries: every point is screened by
    ``|p|^2 - 2 q.p`` (one matrix product), the k + KNN_SLACK lowest are
    ordered by their exact squared distance and index, and a row whose
    screening margin could hide a nearer point is ordered over all n."""
    n = c.shape[0]
    if n < k:
        raise ValueError(f"a level of {n} points has fewer than k = {k}")
    keep = min(n, k + KNN_SLACK)
    pn = (c * c).sum(dim=1)
    tol = 64 * torch.finfo(torch.float64).eps * float(pn.max() * 4 + 1)
    out = torch.empty((n, k), dtype=torch.int64, device=c.device)
    block = max(1, KNN_BUDGET // n)
    for b0 in range(0, n, block):
        q = c[b0:b0 + block]
        key = torch.addmm(pn[None], q, c.T, alpha=-2.0)
        low, cand = torch.topk(key, keep, dim=1, largest=False, sorted=True)
        d2 = _sq_dist(q[:, None], c[cand])
        rows = _ordered(d2, cand, k)
        out[b0:b0 + q.shape[0]] = rows
        if keep == n:
            continue
        kth = _sq_dist(q, c[rows[:, -1]])
        bound = low[:, -1] + (q * q).sum(dim=1) - tol
        for r in torch.nonzero(bound <= kth)[:, 0].tolist():
            full = _sq_dist(q[r][None], c)[None]
            out[b0 + r] = _ordered(full, torch.arange(
                n, device=c.device)[None], k)[0]
    return out


class Level:
    """One level: coordinates (float64), its neighbour list and relative
    positions, and (below the coarsest) each point's cluster."""

    def __init__(self, c: torch.Tensor, k: int):
        self.c = c
        self.n = c.shape[0]
        self.nbr = knn(c, k)
        self.delta = (DELTA_SCALE * (c[self.nbr] - c[:, None])).float()
        self.cluster = None


def hierarchy(vox: torch.Tensor, s: dict):
    """The levels of a voxel set (int64 (V, 3), ascending order)."""
    ks = level_neighbours(s)
    c = vox.to(torch.float64)
    levels = [Level(c, ks[0])]
    for lvl, size in enumerate(s["grid_sizes"]):
        cluster, c = grid_pool(levels[-1].c, float(size))
        levels[-1].cluster = cluster
        levels.append(Level(c, ks[lvl + 1]))
    return levels


def level_sizes(vox: torch.Tensor, s: dict) -> list:
    """Points per level, from the pooling alone (no kNN)."""
    c = vox.to(torch.float64)
    sizes = [c.shape[0]]
    for size in s["grid_sizes"]:
        _, c = grid_pool(c, float(size))
        sizes.append(c.shape[0])
    return sizes


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def param_specs(s: dict, feat_dim: int):
    """(name, shape, kind, fan-in) of every parameter and statistic, by the
    program module's ``state_dict`` keys; kinds as ``ptv3.param_specs``
    (Linear weights in torch's (out, in) layout)."""
    out = []

    def linear(p, cin, cout, bias=True):
        out.append((p + ".weight", (cout, cin), "weight", cin))
        if bias:
            out.append((p + ".bias", (cout,), "bias", cin))

    def batch_norm(p, c):
        out.extend([(p + ".weight", (c,), "gain", 1),
                    (p + ".bias", (c,), "shift", 1),
                    (p + ".running_mean", (c,), "shift", 1),
                    (p + ".running_var", (c,), "var", 1)])

    def block(p, c, g):
        linear(p + "fc1", c, c, bias=False)
        batch_norm(p + "norm1", c)
        for name in ("q", "k"):
            linear(p + f"attn.linear_{name}", c, c)
            batch_norm(p + f"attn.norm_{name}", c)
        linear(p + "attn.linear_v", c, c)
        linear(p + "attn.pe_fc1", 3, c)
        batch_norm(p + "attn.pe_norm", c)
        linear(p + "attn.pe_fc2", c, c)
        linear(p + "attn.we_fc1", c, g)
        batch_norm(p + "attn.we_norm", g)
        linear(p + "attn.we_fc2", g, g)
        batch_norm(p + "norm2", c)
        linear(p + "fc3", c, c, bias=False)
        batch_norm(p + "norm3", c)

    c0 = s["patch_embed_channels"]
    linear("patch_embed.proj", s["in_channels"], c0, bias=False)
    batch_norm("patch_embed.norm", c0)
    for i in range(s["patch_embed_depth"]):
        block(f"patch_embed.blocks.{i}.", c0, s["patch_embed_groups"])
    enc = [c0] + list(s["enc_channels"])
    for e in range(len(s["enc_channels"])):
        linear(f"enc.{e}.down.fc", enc[e], enc[e + 1], bias=False)
        batch_norm(f"enc.{e}.down.norm", enc[e + 1])
        for i in range(s["enc_depths"][e]):
            block(f"enc.{e}.blocks.{i}.", enc[e + 1], s["enc_groups"][e])
    dec = list(s["dec_channels"]) + [enc[-1]]
    for d in range(len(s["dec_channels"])):
        linear(f"dec.{d}.up.proj", dec[d + 1], dec[d])
        batch_norm(f"dec.{d}.up.proj_norm", dec[d])
        linear(f"dec.{d}.up.skip", enc[d], dec[d])
        batch_norm(f"dec.{d}.up.skip_norm", dec[d])
        for i in range(s["dec_depths"][d]):
            block(f"dec.{d}.blocks.{i}.", dec[d], s["dec_groups"][d])
    linear("seg_head.fc1", dec[0], dec[0])
    batch_norm("seg_head.norm", dec[0])
    out.extend([("seg_head.fc2.weight", (feat_dim, dec[0]), "head", dec[0]),
                ("seg_head.fc2.bias", (feat_dim,), "zero", 1)])
    return out


def make_weights(s: dict, feat_dim: int, generator: torch.Generator,
                 device) -> dict:
    """Seeded weights and statistics, drawn in one call on ``device``:
    normal at PyTorch's default variance for a Linear, 1 / (3 fan-in),
    weights and biases; the splat head's rotation and scale rows at
    ``HEAD_SHAPE_GAIN`` of it and its bias zero (as ``ptv3``); BatchNorm
    gains 1 + N(0, 0.1), shifts and means N(0, 0.1), variances exp(N(0,
    0.2))."""
    specs = param_specs(s, feat_dim)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(specs, sizes):
        z = flat[at:at + n].view(shape)
        at += n
        if kind in ("weight", "bias", "head"):
            out[name] = z * math.sqrt(1.0 / (3 * fan_in))
            if kind == "head":
                out[name][:HEAD_SHAPE_ROWS] *= HEAD_SHAPE_GAIN
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "gain":
            out[name] = 1.0 + 0.1 * z
        elif kind == "shift":
            out[name] = 0.1 * z
        else:
            out[name] = torch.exp(0.2 * z)
    return out


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------


def gva_least_ops(n: int, k: int, c: int, g: int) -> int:
    """The least operations of one grouped vector attention (module
    docstring): per (point, neighbour) pair 6C (the hidden vector), 2GC
    (its logits), 2G^2 (the second weight Linear), G (exp), 2C (sum a v)
    and 2GC (sum a h per group); per point 2C^2 (W2) and 4GC (M q, M k)."""
    pair = 6 * c + 2 * g * c + 2 * g * g + g + 2 * c + 2 * g * c
    return n * k * pair + n * (2 * c * c + 4 * g * c)


def gva_least_bytes(n: int, k: int, c: int, g: int) -> int:
    """q, k and v read and the output written once per point in float32,
    the int32 neighbour indices once, and the folded MLP parameters once
    (W1 and b1, P, the logit bias, Wg2 and bg2, W2 and b2)."""
    params = 4 * c + g * c + g + g * g + g + c * c + c
    return 4 * (4 * n * c) + 4 * n * k + 4 * params


class Net:
    """One pass over a hierarchy, counting its flops."""

    def __init__(self, w: dict, levels, s: dict):
        self.w, self.lv, self.s = w, levels, s
        self.flops = 0
        self.launches = []  # (n, k, C, G) per grouped vector attention

    def linear(self, p, x, count=True):
        w = self.w[p + ".weight"]
        if count:
            self.flops += 2 * x[..., 0].numel() * w.shape[0] * w.shape[1]
        y = x @ w.T
        b = self.w.get(p + ".bias")
        return y if b is None else y + b

    def batch_norm(self, p, x):
        w = self.w
        return ((x - w[p + ".running_mean"])
                / torch.sqrt(w[p + ".running_var"] + BN_EPS)
                * w[p + ".weight"] + w[p + ".bias"])

    def attention(self, p, x, lv: Level, groups: int, k: int):
        n, c = x.shape
        q = F.relu(self.batch_norm(p + ".norm_q", self.linear(p + ".linear_q",
                                                              x)))
        kk = F.relu(self.batch_norm(p + ".norm_k",
                                    self.linear(p + ".linear_k", x)))
        v = self.linear(p + ".linear_v", x)
        out = torch.empty_like(v)
        block = max(1, PAIR_BUDGET // (k * c))
        for b0 in range(0, n, block):
            idx = lv.nbr[b0:b0 + block, :k]
            pe = self.linear(p + ".pe_fc2", F.relu(self.batch_norm(
                p + ".pe_norm", self.linear(p + ".pe_fc1",
                                            lv.delta[b0:b0 + block, :k],
                                            False))), False)
            rel = kk[idx] - q[b0:b0 + block, None] + pe
            wt = self.linear(p + ".we_fc2", F.relu(self.batch_norm(
                p + ".we_norm", self.linear(p + ".we_fc1", rel, False))),
                False)
            a = torch.softmax(wt, dim=1)  # over the k neighbours
            val = (v[idx] + pe).view(idx.shape[0], k, groups, c // groups)
            out[b0:b0 + block] = torch.einsum(
                "nsgi,nsg->ngi", val, a).reshape(-1, c)
        self.flops += gva_least_ops(n, k, c, groups)
        self.launches.append((n, k, c, groups))
        return out

    def block(self, p, x, lv: Level, groups: int, k: int):
        h = F.relu(self.batch_norm(p + "norm1", self.linear(p + "fc1", x)))
        h = self.attention(p + "attn", h, lv, groups, k)
        h = F.relu(self.batch_norm(p + "norm2", h))
        h = self.batch_norm(p + "norm3", self.linear(p + "fc3", h))
        return F.relu(x + h)

    def seq(self, p, x, lv, depth, groups, k):
        for i in range(depth):
            x = self.block(f"{p}.blocks.{i}.", x, lv, groups, k)
        return x

    def __call__(self, feats):
        s, lv = self.s, self.lv
        x = F.relu(self.batch_norm("patch_embed.norm",
                                   self.linear("patch_embed.proj", feats)))
        x = self.seq("patch_embed", x, lv[0], s["patch_embed_depth"],
                     s["patch_embed_groups"], s["patch_embed_neighbours"])
        skips = [x]
        for e in range(len(s["enc_channels"])):
            h = F.relu(self.batch_norm(f"enc.{e}.down.norm",
                                       self.linear(f"enc.{e}.down.fc", x)))
            x = torch.full((lv[e + 1].n, h.shape[1]), float("-inf"),
                           device=h.device)
            x.scatter_reduce_(0, lv[e].cluster[:, None].expand_as(h), h,
                              "amax")
            x = self.seq(f"enc.{e}", x, lv[e + 1], s["enc_depths"][e],
                         s["enc_groups"][e], s["enc_neighbours"][e])
            skips.append(x)
        for d in reversed(range(len(s["dec_channels"]))):
            p = f"dec.{d}.up."
            up = F.relu(self.batch_norm(p + "proj_norm",
                                        self.linear(p + "proj", x)))
            skip = F.relu(self.batch_norm(p + "skip_norm",
                                          self.linear(p + "skip", skips[d])))
            x = up[lv[d].cluster] + skip
            x = self.seq(f"dec.{d}", x, lv[d], s["dec_depths"][d],
                         s["dec_groups"][d], s["dec_neighbours"][d])
        return x


def backbone(coords, rgb, weights: dict, s: dict, scale_factor: float,
             offset: float = 512.0):
    """(voxels (V, 3) int64, input features (V, 9), backbone output (V,
    dec_channels[0]), the pass's ``Net`` with its counts, the levels)."""
    vox, feats = voxelize(coords, input_features(coords, rgb, scale_factor,
                                                 offset))
    levels = hierarchy(vox, s)
    net = Net(weights, levels, s)
    return vox, feats, net(feats), net, levels


def splats(coords, rgb, weights: dict, s: dict, scale_factor: float,
           offset: float = 512.0) -> dict:
    """The learned splats of a cloud in grid units, in the form of
    ``network.splats``, and the pass's counts."""
    vox, feats, x, net, _ = backbone(coords, rgb, weights, s, scale_factor,
                                     offset)
    h = F.relu(net.batch_norm("seg_head.norm", net.linear("seg_head.fc1", x)))
    f = net.linear("seg_head.fc2", h)
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
        "gva_pairs": sum(n * k for n, k, _, _ in net.launches),
    }


def gva_work(coords, s: dict) -> list:
    """[ops, bytes] of every grouped vector attention of one pass, in the
    network's order, from this reference's own pooling of the cloud (the
    least work: ``gva_least_ops`` and ``gva_least_bytes``)."""
    vox, _ = voxelize(coords, coords[:, :1])
    sizes = level_sizes(vox, s)
    launches = [(sizes[0], s["patch_embed_neighbours"],
                 s["patch_embed_channels"], s["patch_embed_groups"])
                ] * s["patch_embed_depth"]
    for e in range(len(s["enc_channels"])):
        launches += [(sizes[e + 1], s["enc_neighbours"][e],
                      s["enc_channels"][e], s["enc_groups"][e])
                     ] * s["enc_depths"][e]
    for d in reversed(range(len(s["dec_channels"]))):
        launches += [(sizes[d], s["dec_neighbours"][d], s["dec_channels"][d],
                      s["dec_groups"][d])] * s["dec_depths"][d]
    return [[gva_least_ops(*w), gva_least_bytes(*w)] for w in launches]
