"""Plain PyTorch reference of Swin3D as the learned renderer's backbone,
written from the published description (Yang, Wang, Liu, Tong, Guo,
"Swin3D: A Pretrained Transformer Backbone for 3D Indoor Scene
Understanding", arXiv:2304.06906; Pointcept's ``swin3d_v1m1_base.py`` and
``configs/scannet/semseg-swin3d-v1m1-0-small.py``) and imported by nothing
of the program. Float32 on the inputs' device; callers pin TF32 off. Every
module runs in evaluation: BatchNorm (eps 1e-5) with its running
statistics, drop path an identity.

- voxelisation and input features: ``network.voxelize`` and
  ``network.input_features`` (the renderer's 9 channels, averaged per
  voxel); level 0 is the voxels' integer cells, in ascending (x, y, z)
  order;
- levels, in float64: level l + 1 is the occupied cells of ``floor(cell_l
  / r)`` (r = 3, then 2: MinkowskiEngine's pooling with kernel and stride
  r, cells counted from 0), ordered by the id ``x + nx (y + ny z)`` with
  ``n = max + 1`` per axis (torch_cluster's ``grid_cluster`` order); a
  coarse point's position and colour are the mean of its members' (the
  level below's), summed left to right in ascending member order
  (MinkowskiAvgPooling of the coordinate features);
- windows: at level l with window w and shift t, a point's window is
  ``floor((cell + t) / w)`` per axis (MinkowskiMaxPooling of the shifted
  coordinates); every point of a window attends to every point of it;
- cRSE ("XYZ_RGB"): the signals are the position in the level's cells
  (position / stride, float32) and the colour ``(2 rgb - 1) / 1.001`` (the
  renderer's rgb in [0, 1] to Pointcept's normalised colour, divided by
  1.001 as it feeds it); per axis a the bin ``clamp(floor((s_ia - s_ja)
  Q_a) + L_a / 2, 0, L_a - 1)`` with Q = quant size 4 and L = 2 w Q for
  positions, Q = 8 and L = 2 * 2 * 8 for colours; the logit ``q'_i . k_j +
  sum_a (q'_i . Tq_a + k_j . Tk_a)`` with ``q' = d^-0.5 q`` (the query is
  scaled before the attention, so the key term is not), the output ``sum_j
  softmax_j (v_j + sum_a Tv_a)``; written as the published pair form (the
  table rows of every pair gathered), in blocks of windows;
- the block ``x += proj(WA(LN(x)))``, ``x += fc2(GELU(fc1(LN(x))))``,
  shifted in odd blocks of a stage; ``GridKNNDownsample`` the max of
  ``Linear_nobias(LN(x))`` over each coarse point's 16 nearest points one
  level down; ``Upsample`` ``Linear(LN(skip)) + sum_j w_j
  Linear(LN(coarse))_j`` over each fine point's 3 nearest coarse points,
  ``w = 1 / (d + 1e-8)`` normalised, then one unshifted block; kNN by
  brute force over positions in voxels of the input grid, in float64,
  ``dx^2 + dy^2 + dz^2``, in (distance, index) order;
- the stem ``ReLU(BN(SubMConv3d_3^3))`` (no bias), the classifier Linear,
  BN, ReLU, Linear to the 13 splat parameters; the splat split as
  ``network.splats``.

Departures from Pointcept, fixed by the renderer or by determinism: the
level-0 positions are the voxels' integer cells (Pointcept adds each
voxel's mean point offset inside it), the geometry is float64 with the
(distance, index) tie rule and ordered means; 9 input channels and a
13-channel classifier (ScanNet has 6 and 20 classes); one cloud, no batch.

``flops`` counts one pass: 2 Cin Cout per kernel-map pair of the stem, 2
in out per row and Linear (the downsampling's Linear once per fine point,
the upsampling's once per coarse point), and for each window attention
the least work of ``attn_least_ops``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .network import SH_C0, input_features, voxelize
from .ptv2 import _ordered, _sq_dist
from .ptv3 import HEAD_SHAPE_GAIN, HEAD_SHAPE_ROWS, neighbour_pairs

LN_EPS = BN_EPS = 1e-5
MLP_RATIO = 4
DOWN_K = 16
COLOR_WINDOW, COLOR_DIV = 2, 1.001
INTERP_EPS = 1e-8
PAIR_BUDGET = 1 << 25  # float32 values per (block, m, m, C) tensor
KNN_BUDGET = 1 << 28  # float64 screening keys per block of queries
KNN_SLACK = 48  # candidates screened beyond k before the exact order
# the cRSE tables are drawn N(0, TABLE_STD^2): see the configuration's
# "weights" note
TABLE_STD = 0.02

# the published Swin3D-S configuration
BASE = {
    "in_channels": 9, "depths": [2, 4, 9, 4, 4],
    "channels": [48, 96, 192, 384, 384], "num_heads": [6, 6, 12, 24, 24],
    "window_sizes": [5, 7, 7, 7, 7], "quant_size": 4, "down_stride": 3,
    "up_k": 3,
}


def settings(info: dict) -> dict:
    """The backbone's settings from a ``pcml_info`` dict, base values for
    keys it does not give."""
    return {k: info.get(k, v) for k, v in BASE.items()}


def strides(s: dict) -> list:
    out = [1]
    for lvl in range(1, len(s["channels"])):
        out.append(out[-1] * (s["down_stride"] if lvl == 1 else 2))
    return out


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------


def _mean_rows(values: torch.Tensor, cluster: torch.Tensor, m: int):
    """(m, F) means of ``values`` per cluster, members summed left to right
    in ascending index order."""
    counts = torch.bincount(cluster, minlength=m)
    members = torch.argsort(cluster, stable=True)
    slot = torch.arange(cluster.shape[0], device=cluster.device) - (
        torch.cumsum(counts, 0) - counts)[cluster[members]]
    table = values.new_zeros((m, int(counts.max()), values.shape[1]))
    table[cluster[members], slot] = values[members]
    total = table[:, 0]
    for col in range(1, table.shape[1]):
        total = total + table[:, col]
    return total / counts[:, None].to(values.dtype)


def knn(points: torch.Tensor, queries: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, k) int64: the k nearest of ``points`` (n, 3) float64 to each of
    ``queries`` (Q, 3) float64 by brute force over blocks of queries:
    every point is screened by ``|p|^2 - 2 q.p`` (one matrix product), the
    k + KNN_SLACK lowest are ordered by their exact squared distance and
    index, and a row whose screening margin could hide a nearer point is
    ordered over all n."""
    n = points.shape[0]
    if n < k:
        raise ValueError(f"a level of {n} points has fewer than k = {k}")
    keep = min(n, k + KNN_SLACK)
    pn = (points * points).sum(dim=1)
    scale = float(torch.maximum(pn.max(), (queries * queries).sum(1).max()))
    tol = 64 * torch.finfo(torch.float64).eps * (scale * 4 + 1)
    out = torch.empty((queries.shape[0], k), dtype=torch.int64,
                      device=points.device)
    block = max(1, KNN_BUDGET // n)
    for b0 in range(0, queries.shape[0], block):
        q = queries[b0:b0 + block]
        key = torch.addmm(pn[None], q, points.T, alpha=-2.0)
        low, cand = torch.topk(key, keep, dim=1, largest=False, sorted=True)
        rows = _ordered(_sq_dist(q[:, None], points[cand]), cand, k)
        out[b0:b0 + q.shape[0]] = rows
        if keep == n:
            continue
        kth = _sq_dist(q, points[rows[:, -1]])
        bound = low[:, -1] + (q * q).sum(dim=1) - tol
        for r in torch.nonzero(bound <= kth)[:, 0].tolist():
            full = _sq_dist(q[r][None], points)[None]
            out[b0 + r] = _ordered(full, torch.arange(
                n, device=points.device)[None], k)[0]
    return out


def windows(cells: torch.Tensor, w: int, shift: int):
    """(rows (W, m) int64 padded with -1, occupancy (W,)): each window's
    points in ascending index order."""
    win = torch.div(cells + shift, w, rounding_mode="floor")
    key = (win[:, 0] * 4096 + win[:, 1]) * 4096 + win[:, 2]
    _, which = torch.unique(key, sorted=True, return_inverse=True)
    nw = int(which.max()) + 1
    counts = torch.bincount(which, minlength=nw)
    members = torch.argsort(which, stable=True)
    slot = torch.arange(cells.shape[0], device=cells.device) - (
        torch.cumsum(counts, 0) - counts)[which[members]]
    rows = torch.full((nw, int(counts.max())), -1, dtype=torch.int64,
                      device=cells.device)
    rows[which[members], slot] = members
    return rows, counts


class Level:
    """One level: cells (int64), positions (float64, voxels of the input
    grid), the cluster of each point at the next level, and the kNN lists:
    ``down`` (this level's 16 nearest one level down), ``up`` / ``up_w``
    (3 nearest one level up and their weights)."""

    def __init__(self, cells, pos, stride):
        self.cells, self.pos, self.stride = cells, pos, stride
        self.n = cells.shape[0]
        self.cluster = None
        self.down = self.up = self.up_w = None


def hierarchy(vox: torch.Tensor, s: dict):
    """The levels of a voxel set (int64 (V, 3), ascending order)."""
    st = strides(s)
    levels = [Level(vox, vox.to(torch.float64), 1)]
    for lvl in range(1, len(st)):
        prev = levels[-1]
        r = st[lvl] // st[lvl - 1]
        c = torch.div(prev.cells, r, rounding_mode="floor")
        dims = c.max(dim=0).values + 1
        ids = c[:, 0] + dims[0] * (c[:, 1] + dims[1] * c[:, 2])
        uniq, cluster = torch.unique(ids, sorted=True, return_inverse=True)
        m = uniq.shape[0]
        cells = torch.zeros((m, 3), dtype=torch.int64, device=vox.device)
        cells[cluster] = c
        prev.cluster = cluster
        lv = Level(cells, _mean_rows(prev.pos, cluster, m), st[lvl])
        lv.down = knn(prev.pos, lv.pos, DOWN_K)
        prev.up = knn(lv.pos, prev.pos, s["up_k"])
        d = lv.pos[prev.up] - prev.pos[:, None]
        dist = torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                          + d[..., 2] * d[..., 2])
        w = 1.0 / (dist + INTERP_EPS)
        prev.up_w = (w / w.sum(dim=1, keepdim=True)).float()
        levels.append(lv)
    return levels


def signals(levels, rgb: torch.Tensor) -> list:
    """Per level (n, 6) float32: position in the level's cells and the
    colour signal of the members' mean rgb (``rgb`` the voxels')."""
    col = rgb.to(torch.float64)
    out = []
    for lvl, lv in enumerate(levels):
        if lvl:
            below = levels[lvl - 1]
            col = _mean_rows(col, below.cluster, lv.n)
        out.append(torch.cat([(lv.pos / lv.stride).float(),
                              ((2.0 * col - 1.0) / COLOR_DIV).float()], 1))
    return out


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def table_lengths(s: dict, lvl: int):
    """(position bins, colour bins) of a level's tables."""
    q = s["quant_size"]
    return 2 * s["window_sizes"][lvl] * q, 2 * COLOR_WINDOW * 2 * q


def param_specs(s: dict, feat_dim: int):
    """(name, shape, kind, fan-in) of every parameter and statistic, by the
    program module's ``state_dict`` keys; kinds as ``ptv3.param_specs``
    (Linear weights in torch's (out, in) layout), and "table" (a cRSE
    table, N(0, TABLE_STD^2))."""
    out = []

    def linear(p, cin, cout, bias=True):
        out.append((p + ".weight", (cout, cin), "weight", cin))
        if bias:
            out.append((p + ".bias", (cout,), "bias", cin))

    def layer_norm(p, c):
        out.extend([(p + ".weight", (c,), "gain", 1),
                    (p + ".bias", (c,), "shift", 1)])

    def batch_norm(p, c):
        layer_norm(p, c)
        out.extend([(p + ".running_mean", (c,), "shift", 1),
                    (p + ".running_var", (c,), "var", 1)])

    def block(p, c, heads, lvl):
        lp, lc = table_lengths(s, lvl)
        layer_norm(p + "norm1", c)
        for kind in ("query", "key", "value"):
            out.append((p + f"attn.{kind}_xyz_table",
                        (3, lp, heads, c // heads), "table", 1))
            out.append((p + f"attn.{kind}_rgb_table",
                        (3, lc, heads, c // heads), "table", 1))
        linear(p + "attn.qkv", c, 3 * c)
        linear(p + "attn.proj", c, c)
        layer_norm(p + "norm2", c)
        linear(p + "mlp.fc1", c, MLP_RATIO * c)
        linear(p + "mlp.fc2", MLP_RATIO * c, c)

    ch, heads = s["channels"], s["num_heads"]
    top = len(ch) - 1
    out.append(("stem_layer.conv.kernel", (27, s["in_channels"], ch[0]),
                "weight", 27 * s["in_channels"]))
    batch_norm("stem_layer.norm", ch[0])
    for i in range(len(ch)):
        for b in range(s["depths"][i]):
            block(f"layers.{i}.blocks.{b}.", ch[i], heads[i], i)
        if i < top:
            layer_norm(f"layers.{i}.downsample.norm", ch[i])
            linear(f"layers.{i}.downsample.linear", ch[i], ch[i + 1],
                   bias=False)
    for u, i in enumerate(range(top, 0, -1)):
        p = f"upsamples.{u}."
        layer_norm(p + "linear1.0", ch[i - 1])
        linear(p + "linear1.1", ch[i - 1], ch[i - 1])
        layer_norm(p + "linear2.0", ch[i])
        linear(p + "linear2.1", ch[i], ch[i - 1])
        block(p + "block.blocks.0.", ch[i - 1], heads[i - 1], i - 1)
    linear("classifier.0", ch[0], ch[0])
    batch_norm("classifier.1", ch[0])
    out.extend([("classifier.3.weight", (feat_dim, ch[0]), "head", ch[0]),
                ("classifier.3.bias", (feat_dim,), "zero", 1)])
    return out


def make_weights(s: dict, feat_dim: int, generator: torch.Generator,
                 device) -> dict:
    """Seeded weights and statistics, drawn in one call on ``device``:
    normal at PyTorch's default variance for a Linear, 1 / (3 fan-in),
    weights and biases; the classifier's rotation and scale rows at
    ``HEAD_SHAPE_GAIN`` of it and its bias zero (as ``ptv3``); LayerNorm and
    BatchNorm gains 1 + N(0, 0.1), shifts and means N(0, 0.1), variances
    exp(N(0, 0.2)); the cRSE tables N(0, TABLE_STD^2)."""
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
        elif kind == "table":
            out[name] = TABLE_STD * z
        else:
            out[name] = torch.exp(0.2 * z)
    return out


# --------------------------------------------------------------------------
# the network
# --------------------------------------------------------------------------


def attn_least_ops(pairs: int, heads: int, d: int) -> int:
    """The least operations of one window attention over ``pairs`` (query,
    key) pairs: per pair and head 2 d (q'.k), 2 d (the weighted sum of v),
    1 (exp), 12 (adding the six q' and six k table terms to the logit) and
    6 (the six value-table terms, added to a per-bin sum or to the output,
    at least once each)."""
    return pairs * heads * (4 * d + 19)


def attn_least_bytes(n: int, windows_: int, c: int, rows: int) -> int:
    """q, k, v read and the output written once per point in float32, the
    six signals and the partition (a row per point, an offset per window)
    once, and the three tables once."""
    return 4 * (4 * n * c + 6 * n + n + windows_ + 1 + 3 * rows * c)


class Net:
    """One pass over a hierarchy, counting its flops and attention work."""

    def __init__(self, w: dict, levels, sig, s: dict):
        self.w, self.lv, self.sig, self.s = w, levels, sig, s
        self.flops = 0
        self.launches = []  # (n, windows, pairs, heads, d, rows) per attention
        self._windows = {}

    def linear(self, p, x):
        w = self.w[p + ".weight"]
        self.flops += 2 * x.shape[0] * w.shape[0] * w.shape[1]
        y = x @ w.T
        b = self.w.get(p + ".bias")
        return y if b is None else y + b

    def layer_norm(self, p, x):
        return F.layer_norm(x, (x.shape[1],), self.w[p + ".weight"],
                            self.w[p + ".bias"], LN_EPS)

    def batch_norm(self, p, x):
        w = self.w
        return ((x - w[p + ".running_mean"])
                / torch.sqrt(w[p + ".running_var"] + BN_EPS)
                * w[p + ".weight"] + w[p + ".bias"])

    def windows(self, lvl: int, shift: int):
        key = (lvl, shift)
        if key not in self._windows:
            rows, counts = windows(self.lv[lvl].cells,
                                   self.s["window_sizes"][lvl], shift)
            self._windows[key] = (rows, counts.tolist())
        return self._windows[key]

    def attention(self, p, x, lvl: int, heads: int, shift: int):
        n, c = x.shape
        d = c // heads
        lp, lc = table_lengths(self.s, lvl)
        q_ = self.s["quant_size"]
        axes = [(a * lp, lp, float(q_)) for a in range(3)] + [
            (3 * lp + a * lc, lc, float(2 * q_)) for a in range(3)]
        tab = {kind: torch.cat([self.w[f"{p}.{kind}_xyz_table"].flatten(0, 1),
                                self.w[f"{p}.{kind}_rgb_table"].flatten(0, 1)])
               for kind in ("query", "key", "value")}
        qkv = self.linear(p + ".qkv", x).view(n, 3, heads, d)
        q, k, v = qkv[:, 0] * d ** -0.5, qkv[:, 1], qkv[:, 2]
        sig = self.sig[lvl]
        rows, counts = self.windows(lvl, shift)
        out = torch.empty((n, c), device=x.device)
        w0 = 0
        while w0 < len(counts):
            m, w1 = counts[w0], w0 + 1
            while w1 < len(counts):
                mm = max(m, counts[w1])
                if (w1 - w0 + 1) * mm * mm * c > PAIR_BUDGET:
                    break
                m, w1 = mm, w1 + 1
            r = rows[w0:w1, :m]
            valid = r >= 0
            r = r.clamp(min=0)
            s_ = sig[r]  # (B, m, 6)
            diff = s_[:, :, None] - s_[:, None, :]  # (B, i, j, 6)
            tq = tk = tv = 0.0
            for a, (off, length, quant) in enumerate(axes):
                b = (torch.floor(diff[..., a] * quant).long()
                     + length // 2).clamp(0, length - 1) + off
                tq = tq + tab["query"][b]  # (B, i, j, H, d)
                tk = tk + tab["key"][b]
                tv = tv + tab["value"][b]
            qb, kb, vb = q[r], k[r], v[r]  # (B, m, H, d)
            e = (torch.einsum("bihd,bjhd->bhij", qb, kb)
                 + torch.einsum("bihd,bijhd->bhij", qb, tq)
                 + torch.einsum("bjhd,bijhd->bhij", kb, tk))
            e = e.masked_fill(~valid[:, None, None, :], float("-inf"))
            e = e.masked_fill(~valid[:, None, :, None], 0.0)
            a_ = torch.softmax(e, dim=-1)
            o = (torch.einsum("bhij,bjhd->bihd", a_, vb)
                 + torch.einsum("bhij,bijhd->bihd", a_, tv))
            out[r[valid]] = o.reshape(w1 - w0, m, c)[valid]
            w0 = w1
        pairs = sum(cnt * cnt for cnt in counts)
        self.flops += attn_least_ops(pairs, heads, d)
        self.launches.append((n, len(counts), pairs, heads, d, tab[
            "query"].shape[0]))
        return self.linear(p + ".proj", out)

    def block(self, p, x, lvl, heads, shift):
        h = self.attention(p + "attn", self.layer_norm(p + "norm1", x), lvl,
                           heads, shift)
        x = x + h
        h = self.linear(p + "mlp.fc1", self.layer_norm(p + "norm2", x))
        return x + self.linear(p + "mlp.fc2", F.gelu(h))

    def stage(self, p, x, lvl, depth):
        w = self.s["window_sizes"][lvl]
        for b in range(depth):
            x = self.block(f"{p}.blocks.{b}.", x, lvl,
                           self.s["num_heads"][lvl], (w // 2) * (b % 2))
        return x

    def conv(self, x, pairs, kernel):
        out = torch.zeros((x.shape[0], kernel.shape[2]), device=x.device)
        for o, (rows, nbr) in enumerate(pairs):
            out.index_add_(0, rows, x[nbr] @ kernel[o])
            self.flops += 2 * rows.numel() * kernel.shape[1] * kernel.shape[2]
        return out

    def __call__(self, feats, stem_pairs):
        s, lv = self.s, self.lv
        top = len(s["channels"]) - 1
        x = self.conv(feats, stem_pairs, self.w["stem_layer.conv.kernel"])
        x = F.relu(self.batch_norm("stem_layer.norm", x))
        skips = []
        for i in range(top + 1):
            x = self.stage(f"layers.{i}", x, i, s["depths"][i])
            skips.append(x)
            if i < top:
                p = f"layers.{i}.downsample."
                y = self.linear(p + "linear", self.layer_norm(p + "norm", x))
                x = y[lv[i + 1].down].amax(dim=1)
        for u, i in enumerate(range(top, 0, -1)):
            p = f"upsamples.{u}."
            z = self.linear(p + "linear2.1", self.layer_norm(p + "linear2.0",
                                                             x))
            f = self.linear(p + "linear1.1", self.layer_norm(p + "linear1.0",
                                                             skips[i - 1]))
            x = f + (lv[i - 1].up_w[..., None] * z[lv[i - 1].up]).sum(1)
            x = self.stage(f"upsamples.{u}.block", x, i - 1, 1)
        return x


def backbone(coords, rgb, weights: dict, s: dict, scale_factor: float,
             offset: float = 512.0):
    """(voxels (V, 3) int64, input features (V, 9), backbone output (V,
    channels[0]), the pass's ``Net`` with its counts, the levels)."""
    vox, feats = voxelize(coords, input_features(coords, rgb, scale_factor,
                                                 offset))
    levels = hierarchy(vox, s)
    net = Net(weights, levels, signals(levels, feats[:, -3:]), s)
    return vox, feats, net(feats, neighbour_pairs(vox, 3)), net, levels


def splats(coords, rgb, weights: dict, s: dict, scale_factor: float,
           offset: float = 512.0) -> dict:
    """The learned splats of a cloud in grid units, in the form of
    ``network.splats``, and the pass's counts."""
    vox, feats, x, net, _ = backbone(coords, rgb, weights, s, scale_factor,
                                     offset)
    h = F.relu(net.batch_norm("classifier.1", net.linear("classifier.0", x)))
    f = net.linear("classifier.3", h)
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
        "attn_pairs": sum(pr * h for _, _, pr, h, _, _ in net.launches),
    }


def attention_work(coords, s: dict) -> list:
    """[ops, bytes] of every window attention of one pass, in the
    network's order, from this reference's own levels and windows of the
    cloud (the least work: ``attn_least_ops`` and ``attn_least_bytes``)."""
    vox, _ = voxelize(coords, coords[:, :1])
    st = strides(s)
    cells = [vox]
    for lvl in range(1, len(st)):
        c = torch.div(cells[-1], st[lvl] // st[lvl - 1],
                      rounding_mode="floor")
        cells.append(torch.unique(c, dim=0))
    top = len(st) - 1
    order = [(i, b) for i in range(top + 1) for b in range(s["depths"][i])]
    order += [(i - 1, 0) for i in range(top, 0, -1)]
    work = []
    for lvl, b in order:
        w = s["window_sizes"][lvl]
        _, counts = windows(cells[lvl], w, (w // 2) * (b % 2))
        c, heads = s["channels"][lvl], s["num_heads"][lvl]
        lp, lc = table_lengths(s, lvl)
        pairs = int((counts * counts).sum())
        work.append([attn_least_ops(pairs, heads, c // heads),
                     attn_least_bytes(cells[lvl].shape[0], counts.shape[0],
                                      c, 3 * lp + 3 * lc)])
    return work
