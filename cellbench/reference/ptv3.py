"""Plain PyTorch reference of Point Transformer V3 as the learned renderer's
backbone, written from the published description (Wu et al., "Point
Transformer V3: Simpler, Faster, Stronger", CVPR 2024; Pointcept's
``point_transformer_v3m1_base.py`` and its serialization code) and imported
by nothing of the program. Float32 on the inputs' device; callers pin TF32
off.

- voxelisation and input features: ``network.voxelize`` and
  ``network.input_features`` (the renderer's 9 channels, averaged per
  voxel); grid coordinates ``g = voxel - min`` per axis (``GridSample``),
  serialization depth ``D = bit_length(max g)``;
- serialization: per order of ``ORDERS`` a code per voxel: ``z`` the Morton
  code (bit i of x at 3i + 2, of y at 3i + 1, of z at 3i), ``hilbert`` the
  Hilbert code of PrincetonLIPS' ``numpy-hilbert-curve`` on a bit array,
  ``-trans`` the same on ``g[:, [1, 0, 2]]``; ``order = argsort(code)``;
- levels: level l + 1 clusters level l by ``code_z >> 3`` (the parents
  ``g >> 1``), its voxels in ascending cluster code (Pointcept's order),
  every order's code the children's code ``>> 3``;
- the stem: a submanifold 5^3 convolution (no bias), BatchNorm, GELU; the
  block: CPE (submanifold 3^3 convolution with bias, Linear, LayerNorm) and
  pre-norm patch attention and MLP, each a residual; patch attention over
  ``min(patch_size, N)`` consecutive points of the block's order (order
  ``i % 4`` for block i of a stage), the last patch the last K points of
  the order, of which only the points no earlier patch holds keep their
  outputs; pooling: Linear, segment max per cluster, BatchNorm, GELU;
  unpooling: BN and GELU after a Linear on both the skip and the coarse
  features, summed at each fine voxel's parent; the head a Linear;
- the splat split as ``network.splats``.

Departures from Pointcept, all fixed by the renderer or by determinism:
``shuffle_orders`` is off (the published order tuple is kept, in order);
attention is computed in float32 with the softmax upcast (the published
non-flash path), never in fp16; no relative position bias
(``enable_rpe=False``); BatchNorm runs with its seeded running statistics
(evaluation); 9 input channels and a 13-channel head (the renderer's
features and splat parameters, where ScanNet has 6 and 20); one cloud, no
batch bits in the codes; drop path and dropout are identities.

Kernel offsets: the first axis varies fastest, offset o = ix + k iy + k^2
iz with displacement (ix, iy, iz) - k // 2, so a (k^3, Cin, Cout) kernel
reads W[o]. ``flops`` counts the useful multiply-adds of one pass:
attention 4 d K per query kept and head (the two products over its
patch's K keys; the last patch's shared queries are not counted), 2 in out
per row and Linear, 2 Cin Cout per existing map pair.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .network import SH_C0, input_features, voxelize

# fixed by Pointcept's base configuration; the widths are ``BASE``'s
ORDERS = ("z", "z-trans", "hilbert", "hilbert-trans")
STEM_KERNEL, MLP_RATIO = 5, 4
LN_EPS = 1e-5
BN_EPS = 1e-3
SCORE_BUDGET = 1 << 27  # float32 scores per block of patches (512 MiB)
# The splat head (13 rows: rotation 4, scale 3, offset 3, normal 3). The
# rasterizer takes quaternions as given, so |q|^2 scales each splat, and
# the backbone's mean output, which differs from seed to seed, shifts every
# splat of a cloud alike through the head: at the default scale the head's
# outputs have std ~2 and splats reach across much of a view. The rotation
# and scale rows are drawn at HEAD_SHAPE_GAIN of the default (splats near
# the identity rotation and unit scale, their footprint within a few % from
# seed to seed, like the U-Net cell's), the offset and normal rows at the
# default, so that the images follow the network; the bias is zero, as the
# U-Net cell's biases are.
HEAD_SHAPE_ROWS, HEAD_SHAPE_GAIN = 7, 0.01

# the published base configuration (configs/scannet/semseg-pt-v3m1-0-base.py)
BASE = {
    "in_channels": 9, "patch_size": 1024,
    "enc_channels": [32, 64, 128, 256, 512], "enc_heads": [2, 4, 8, 16, 32],
    "enc_depths": [2, 2, 2, 6, 2],
    "dec_channels": [64, 64, 128, 256], "dec_heads": [4, 4, 8, 16],
    "dec_depths": [2, 2, 2, 2],
}


def settings(info: dict) -> dict:
    """The backbone's settings from a ``pcml_info`` dict, base values for
    keys it does not give."""
    return {k: info.get(k, v) for k, v in BASE.items()}


# --------------------------------------------------------------------------
# serialization
# --------------------------------------------------------------------------


def morton(g: torch.Tensor, depth: int) -> torch.Tensor:
    """(N, 3) int64 -> (N,) Morton code, OCNN's ``xyz2key``."""
    code = torch.zeros(g.shape[0], dtype=torch.int64, device=g.device)
    for i in range(depth):
        for axis, at in ((0, 2), (1, 1), (2, 0)):
            code |= ((g[:, axis] >> i) & 1) << (3 * i + at)
    return code


def hilbert(g: torch.Tensor, depth: int) -> torch.Tensor:
    """(N, 3) int64 -> (N,) Hilbert code on a (N, 3, depth) bit array, most
    significant bit first: per bit and axis, where the axis' bit is set the
    lower bits of axis 0 are inverted, else the lower bits of axes 0 and d
    are exchanged where they differ; then the bits are interleaved (x, y,
    z per bit) and Gray-decoded by a prefix XOR."""
    shifts = torch.arange(depth - 1, -1, -1, device=g.device)
    bits = ((g[:, :, None] >> shifts) & 1).bool()  # (N, 3, depth)
    for b in range(depth):
        for d in range(3):
            on = bits[:, d, b][:, None]
            low0 = bits[:, 0, b + 1:]
            bits[:, 0, b + 1:] = torch.where(on, ~low0, low0)
            low0, lowd = bits[:, 0, b + 1:], bits[:, d, b + 1:]
            flip = ~on & (low0 ^ lowd)
            bits[:, d, b + 1:] = lowd ^ flip
            bits[:, 0, b + 1:] = bits[:, 0, b + 1:] ^ flip
    gray = bits.transpose(1, 2).reshape(g.shape[0], 3 * depth)
    binary = torch.cumsum(gray.long(), dim=1) % 2  # prefix XOR
    weights = 1 << torch.arange(3 * depth - 1, -1, -1, device=g.device)
    return (binary * weights).sum(dim=1)


def encode(g: torch.Tensor, order: str, depth: int) -> torch.Tensor:
    if order.endswith("-trans"):
        g = g[:, [1, 0, 2]]
        order = order[:-len("-trans")]
    if order == "z":
        return morton(g, depth)
    if order == "hilbert":
        return hilbert(g, depth)
    raise ValueError(f"unknown order {order!r}")


# --------------------------------------------------------------------------
# the hierarchy
# --------------------------------------------------------------------------


def offsets(k: int, device) -> torch.Tensor:
    """(k^3, 3) displacements, the first axis fastest."""
    r = torch.arange(k, device=device) - k // 2
    iz, iy, ix = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([ix, iy, iz], -1).reshape(-1, 3)


def neighbour_pairs(g: torch.Tensor, k: int):
    """Per offset of a submanifold k^3 convolution over voxels ``g``: (rows,
    neighbour rows) of the pairs that exist."""
    span = int(g.max()) + k + 1
    shift = k // 2

    def key(c):
        c = c + shift
        return (c[:, 0] * span + c[:, 1]) * span + c[:, 2]

    keys = key(g)
    sk, perm = torch.sort(keys)
    out = []
    for off in offsets(k, g.device):
        q = key(g + off)
        pos = torch.searchsorted(sk, q).clamp(max=g.shape[0] - 1)
        hit = (sk[pos] == q) & ((g + off) >= 0).all(1)
        rows = torch.nonzero(hit)[:, 0]
        out.append((rows, perm[pos[rows]]))
    return out


class Level:
    """One level: voxels ``g``, per order its code, order and patches."""

    def __init__(self, g, codes, patch_size):
        self.g = g
        self.n = g.shape[0]
        self.codes = codes  # (n_orders, n)
        self.order = [torch.argsort(c) for c in codes]
        self.k = min(patch_size, self.n)
        self.patches = -(-self.n // self.k)
        self.parent = None  # (n,) cluster of each voxel at the next level
        self._pairs3 = None

    def pairs3(self):
        """The 3^3 submanifold pairs, built at the first call."""
        if self._pairs3 is None:
            self._pairs3 = neighbour_pairs(self.g, 3)
        return self._pairs3


def hierarchy(vox: torch.Tensor, s: dict):
    """The levels of a voxel set (int64 (V, 3), the network's input
    order)."""
    g = vox - vox.min(0).values
    depth = int(g.max()).bit_length()
    codes = torch.stack([encode(g, o, depth) for o in ORDERS])
    levels = [Level(g, codes, s["patch_size"])]
    for _ in range(len(s["enc_channels"]) - 1):
        lv = levels[-1]
        zc = lv.codes[ORDERS.index("z")] >> 3
        _, cluster = torch.unique(zc, sorted=True, return_inverse=True)
        m = int(cluster.max()) + 1
        head = torch.full((m,), lv.n, dtype=torch.int64, device=g.device)
        head.scatter_reduce_(0, cluster, torch.arange(lv.n, device=g.device),
                             "amin")
        lv.parent = cluster
        levels.append(Level(lv.g[head] >> 1, lv.codes[:, head] >> 3,
                            s["patch_size"]))
    return levels, depth


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def param_specs(s: dict, feat_dim: int):
    """(name, shape, kind, fan-in) of every parameter and statistic, by the
    program module's ``state_dict`` keys. kind: "weight" and "bias" (normal
    with PyTorch's default variance for a Linear or a convolution, 1 / (3
    fan-in); Linear weights in torch's (out, in) layout, kernels (k^3, Cin,
    Cout)), "head" (the splat head's weight: the same, its first
    ``HEAD_SHAPE_ROWS`` rows times ``HEAD_SHAPE_GAIN``; its bias is "zero"),
    "gain" (1 + N(0, 0.1)), "shift" (N(0, 0.1)), "var" (exp(N(0,
    0.2)))."""
    out = []

    def linear(p, cin, cout):
        out.extend([(p + ".weight", (cout, cin), "weight", cin),
                    (p + ".bias", (cout,), "bias", cin)])

    def layer_norm(p, c):
        out.extend([(p + ".weight", (c,), "gain", 1),
                    (p + ".bias", (c,), "shift", 1)])

    def batch_norm(p, c):
        layer_norm(p, c)
        out.extend([(p + ".running_mean", (c,), "shift", 1),
                    (p + ".running_var", (c,), "var", 1)])

    def block(p, c):
        out.extend([(p + "cpe.conv.kernel", (27, c, c), "weight", 27 * c),
                    (p + "cpe.conv.bias", (c,), "bias", 27 * c)])
        linear(p + "cpe.linear", c, c)
        layer_norm(p + "cpe.norm", c)
        layer_norm(p + "norm1", c)
        linear(p + "attn.qkv", c, 3 * c)
        linear(p + "attn.proj", c, c)
        layer_norm(p + "norm2", c)
        linear(p + "mlp.fc1", c, MLP_RATIO * c)
        linear(p + "mlp.fc2", MLP_RATIO * c, c)

    enc, dec = s["enc_channels"], s["dec_channels"]
    k3 = STEM_KERNEL ** 3
    out.append(("embedding.conv.kernel", (k3, s["in_channels"], enc[0]),
                "weight", k3 * s["in_channels"]))
    batch_norm("embedding.norm", enc[0])
    for st, c in enumerate(enc):
        if st:
            linear(f"enc.{st}.pool.proj", enc[st - 1], c)
            batch_norm(f"enc.{st}.pool.norm", c)
        for i in range(s["enc_depths"][st]):
            block(f"enc.{st}.blocks.{i}.", c)
    wide = list(dec) + [enc[-1]]
    for st in range(len(dec)):
        c = dec[st]
        linear(f"dec.{st}.unpool.proj", wide[st + 1], c)
        batch_norm(f"dec.{st}.unpool.proj_norm", c)
        linear(f"dec.{st}.unpool.skip", enc[st], c)
        batch_norm(f"dec.{st}.unpool.skip_norm", c)
        for i in range(s["dec_depths"][st]):
            block(f"dec.{st}.blocks.{i}.", c)
    out.extend([("seg_head.weight", (feat_dim, dec[0]), "head", dec[0]),
                ("seg_head.bias", (feat_dim,), "zero", 1)])
    return out


def make_weights(s: dict, feat_dim: int, generator: torch.Generator,
                 device) -> dict:
    """Seeded weights and statistics, drawn in one call on ``device``."""
    specs = param_specs(s, feat_dim)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for (name, shape, kind, fan_in), n in zip(specs, sizes):
        z = flat[at:at + n].view(shape)
        at += n
        if kind in ("weight", "bias"):
            out[name] = z * math.sqrt(1.0 / (3 * fan_in))
        elif kind == "head":
            out[name] = z * math.sqrt(1.0 / (3 * fan_in))
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


class Net:
    """One pass over a hierarchy, counting its flops and attention work."""

    def __init__(self, w: dict, levels, s: dict):
        self.w, self.lv, self.s = w, levels, s
        self.flops = 0
        self.attn_pairs = 0
        self.attn_patches = 0
        self.launches = []  # (N, K, patches, heads, d) per attention

    def linear(self, p, x):
        w = self.w[p + ".weight"]
        self.flops += 2 * x.shape[0] * w.shape[0] * w.shape[1]
        return x @ w.T + self.w[p + ".bias"]

    def layer_norm(self, p, x):
        return F.layer_norm(x, (x.shape[1],), self.w[p + ".weight"],
                            self.w[p + ".bias"], LN_EPS)

    def batch_norm(self, p, x):
        w = self.w
        return ((x - w[p + ".running_mean"])
                / torch.sqrt(w[p + ".running_var"] + BN_EPS)
                * w[p + ".weight"] + w[p + ".bias"])

    def conv(self, x, pairs, kernel, bias=None):
        out = torch.zeros((x.shape[0], kernel.shape[2]), device=x.device)
        for o, (rows, nbr) in enumerate(pairs):
            out.index_add_(0, rows, x[nbr] @ kernel[o])
            self.flops += 2 * rows.numel() * kernel.shape[1] * kernel.shape[2]
        return out if bias is None else out + bias

    def attention(self, p, x, lv: Level, heads: int, order_index: int):
        n, c = x.shape
        d = c // heads
        k, patches = lv.k, lv.patches
        qkv = self.linear(p + ".qkv", x)
        order = lv.order[order_index]
        start = torch.clamp(torch.arange(patches, device=x.device) * k,
                            max=n - k)
        out = torch.empty((n, c), device=x.device)
        per = max(1, SCORE_BUDGET // (heads * k * k))
        for b0 in range(0, patches, per):
            st = start[b0:b0 + per]
            pos = st[:, None] + torch.arange(k, device=x.device)
            rows = order[pos]  # (B, K)
            t = qkv[rows].view(-1, k, 3, heads, d).permute(2, 0, 3, 1, 4)
            q, kk, v = t[0], t[1], t[2]  # (B, H, K, d)
            attn = torch.softmax((q * d ** -0.5) @ kk.transpose(-2, -1), -1)
            o = (attn @ v).transpose(1, 2).reshape(-1, k, c)
            first = (torch.arange(b0, b0 + st.numel(), device=x.device)
                     * k)[:, None]
            keep = pos >= first  # the last patch's shared points are not its
            out[rows[keep]] = o[keep]
        self.flops += 4 * d * k * n * heads  # every kept query, K keys
        self.attn_pairs += patches * heads * k * k
        self.attn_patches += patches
        self.launches.append((n, k, patches, heads, d))
        return self.linear(p + ".proj", out)

    def block(self, p, x, lv: Level, heads: int, i: int):
        h = self.conv(x, lv.pairs3(), self.w[p + "cpe.conv.kernel"],
                      self.w[p + "cpe.conv.bias"])
        x = x + self.layer_norm(p + "cpe.norm",
                                self.linear(p + "cpe.linear", h))
        h = self.attention(p + "attn", self.layer_norm(p + "norm1", x), lv,
                           heads, i % len(ORDERS))
        x = x + h
        h = self.linear(p + "mlp.fc1", self.layer_norm(p + "norm2", x))
        return x + self.linear(p + "mlp.fc2", F.gelu(h))

    def __call__(self, feats, stem_pairs):
        s, lv = self.s, self.lv
        x = self.conv(feats, stem_pairs, self.w["embedding.conv.kernel"])
        x = F.gelu(self.batch_norm("embedding.norm", x))
        skips = []
        for st in range(len(s["enc_channels"])):
            if st:
                prev = lv[st - 1]
                h = self.linear(f"enc.{st}.pool.proj", x)
                pooled = torch.full((lv[st].n, h.shape[1]), float("-inf"),
                                    device=h.device)
                pooled.scatter_reduce_(
                    0, prev.parent[:, None].expand_as(h), h, "amax")
                x = F.gelu(self.batch_norm(f"enc.{st}.pool.norm", pooled))
            for i in range(s["enc_depths"][st]):
                x = self.block(f"enc.{st}.blocks.{i}.", x, lv[st],
                               s["enc_heads"][st], i)
            skips.append(x)
        for st in reversed(range(len(s["dec_channels"]))):
            p = f"dec.{st}.unpool."
            up = F.gelu(self.batch_norm(p + "proj_norm",
                                        self.linear(p + "proj", x)))
            skip = F.gelu(self.batch_norm(p + "skip_norm",
                                          self.linear(p + "skip", skips[st])))
            x = skip + up[lv[st].parent]
            for i in range(s["dec_depths"][st]):
                x = self.block(f"dec.{st}.blocks.{i}.", x, lv[st],
                               s["dec_heads"][st], i)
        return x


def backbone(coords, rgb, weights: dict, s: dict, scale_factor: float,
             offset: float = 512.0):
    """(voxels (V, 3) int64, input features (V, 9), backbone output (V,
    dec_channels[0]), the pass's ``Net`` with its counts)."""
    vox, feats = voxelize(coords, input_features(coords, rgb, scale_factor,
                                                 offset))
    levels, _ = hierarchy(vox, s)
    net = Net(weights, levels, s)
    stem = neighbour_pairs(levels[0].g, STEM_KERNEL)
    return vox, feats, net(feats, stem), net


def splats(coords, rgb, weights: dict, s: dict, scale_factor: float,
           offset: float = 512.0) -> dict:
    """The learned splats of a cloud in grid units, in the form of
    ``network.splats``, and the pass's attention counts."""
    vox, feats, x, net = backbone(coords, rgb, weights, s, scale_factor,
                                  offset)
    f = net.linear("seg_head", x)
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
        "attn_pairs": net.attn_pairs,
        "attn_patches": net.attn_patches,
    }


def attention_work(coords, s: dict) -> list:
    """[ops, bytes] of every attention of one pass, from this reference's
    own hierarchy of the cloud: ops (4 d + 1) K per query and head (the
    two products over its patch's K keys and the exponentials), N queries
    (the last patch's K - r shared rows are computed by the patch before:
    no output needs them again); bytes the queries read and the outputs
    written once, k and v of every patch read once, in float32."""
    vox, _ = voxelize(coords, coords[:, :1])
    levels, _ = hierarchy(vox, s)
    work = []
    for depths, heads, chans in (
            (s["enc_depths"], s["enc_heads"], s["enc_channels"]),
            (s["dec_depths"], s["dec_heads"], s["dec_channels"])):
        for st, depth in enumerate(depths):
            lv = levels[st]
            d = chans[st] // heads[st]
            for _ in range(depth):
                ops = (4 * d + 1) * lv.k * lv.n * heads[st]
                nbytes = 4 * heads[st] * d * (2 * lv.patches * lv.k
                                              + 2 * lv.n)
                work.append([ops, nbytes])
    return work
