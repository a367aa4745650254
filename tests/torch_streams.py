"""Seeded tile streams for the port's blend-kernel tests
(``test_torch_gpu.py`` on the card, ``test_torch_stream_vjp.py`` on the
CPU), and the seeded splats of the preprocess tests
(``test_torch_gpu.py``, ``test_torch_render.py``). Imports no JAX."""

import numpy as np
import torch


def tile_stream(counts, seed, channels=3, grid_x=3, sigma=(1.0, 6.0),
                edges=False, faint=False, opaque=0.4):
    """A stream whose tiles hold exactly ``counts`` entries (CPU tensors):
    rotated conics with axes of ``sigma`` px, a share ``opaque`` of
    opacities in [0.9, 0.999) (pixels stop after a few of them), the rest
    in [0.002, 0.9). ``edges`` puts the means within a pixel of the 8x4
    block edges of the serving kernel's warps; ``faint`` gives half the
    entries an opacity just above 1/255."""
    rng = np.random.RandomState(seed)
    rows = []
    for tile, n in enumerate(counts):
        x0, y0 = tile % grid_x * 16, tile // grid_x * 16
        sig = rng.uniform(sigma[0], sigma[1], (n, 2))
        th = rng.uniform(0, np.pi, n)
        cs, sn = np.cos(th), np.sin(th)
        cxx = cs * cs * sig[:, 0] ** 2 + sn * sn * sig[:, 1] ** 2
        cyy = sn * sn * sig[:, 0] ** 2 + cs * cs * sig[:, 1] ** 2
        cxy = cs * sn * (sig[:, 0] ** 2 - sig[:, 1] ** 2)
        det = cxx * cyy - cxy ** 2
        op = np.where(rng.rand(n) < opaque, rng.uniform(0.9, 0.999, n),
                      rng.uniform(0.002, 0.9, n))
        if faint:
            op = np.where(rng.rand(n) < 0.5,
                          (1 + rng.uniform(0, 1e-3, n)) / 255, op)
        if edges:
            mx = x0 + rng.choice([0, 7, 8, 15, 16], n) + rng.uniform(-1, 1, n)
            my = y0 + rng.choice([0, 3, 4, 7, 8, 11, 12, 15, 16], n) \
                + rng.uniform(-1, 1, n)
        else:
            mx = x0 + rng.uniform(-4, 20, n)
            my = y0 + rng.uniform(-4, 20, n)
        rows.append(np.concatenate([
            np.stack([mx, my, cyy / det, -cxy / det, cxx / det, op,
                      np.zeros(n), np.zeros(n)], 1),
            rng.rand(n, channels)], 1))
    stream = torch.from_numpy(np.concatenate(rows).astype(np.float32))
    starts = torch.from_numpy(
        np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    return stream, starts


def split_tile_rows(n, seed, x0=0.0, y0=0.0, channels=3):
    """``n`` stream rows (numpy, 8 + channels columns) of one tile at pixel
    origin (x0, y0) on which the left 8x4 blocks' pixels (x < 8) stop in
    the first 48 entries and the right ones (x >= 8) never stop: first
    six opaque splats per pixel column x = 0..7, each sharp in x (sigma
    0.28 px: alpha 0.8-0.99 on its column, below 1/255 one column over)
    and long in y; then faint wide splats (opacity 0.004-0.006) over the
    right half, which take off at most a few percent of T."""
    rng = np.random.RandomState(seed)
    k = min(n, 48)
    cols = np.tile(np.arange(8.0), 6)[:k]
    sx, sy = 0.28, 12.0
    head = np.stack([x0 + cols, y0 + 7.5 + np.zeros(k),
                     np.full(k, 1 / sx ** 2), np.zeros(k),
                     np.full(k, 1 / sy ** 2), np.full(k, 0.99),
                     np.zeros(k), np.zeros(k)], 1)
    m = n - k
    sig = rng.uniform(2.0, 6.0, m)
    tail = np.stack([x0 + rng.uniform(9, 15, m), y0 + rng.uniform(0, 15, m),
                     1 / sig ** 2, np.zeros(m), 1 / sig ** 2,
                     rng.uniform(0.004, 0.006, m), np.zeros(m),
                     np.zeros(m)], 1)
    rows = np.concatenate([head, tail])
    return np.concatenate([rows, rng.rand(n, channels)], 1)


def ring_tiles(lengths, seed, channels, split=()):
    """A stream of tiles on a grid 3 wide holding exactly ``lengths``
    entries each (CPU tensors): ``tile_stream``'s random splats, or
    ``split_tile_rows`` for the tile ids in ``split``."""
    rows = []
    for tile, n in enumerate(lengths):
        if tile in split:
            rows.append(split_tile_rows(n, seed + tile, tile % 3 * 16.0,
                                        tile // 3 * 16.0, channels))
        else:
            s, _ = tile_stream([0] * tile + [n], seed + tile,
                               channels=channels, sigma=(1.0, 6.0))
            rows.append(s.numpy().astype(np.float64))
    stream = torch.from_numpy(np.concatenate(rows).astype(np.float32))
    starts = torch.from_numpy(
        np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32))
    return stream, starts


def aligned_layout(stream, starts, chunk, channels):
    """The chunk-aligned layout (``rasterize_aligned.tile_bin_aligned``'s)
    of a stream's tiles: (chunk_starts (T + 1,) i32, scal (Kc, 6, chunk),
    feat (Kc, C, chunk)), each tile padded to whole chunks with zero
    slots."""
    counts = (starts[1:] - starts[:-1]).long()
    nch = (counts + chunk - 1) // chunk
    cstarts = torch.cat([torch.zeros(1, dtype=torch.long), nch.cumsum(0)])
    slots = torch.zeros((int(cstarts[-1]) * chunk, 6 + channels))
    for t in range(counts.numel()):
        s, e = int(starts[t]), int(starts[t + 1])
        a = int(cstarts[t]) * chunk
        slots[a:a + e - s, :6] = stream[s:e, :6]
        slots[a:a + e - s, 6:] = stream[s:e, 8:8 + channels]
    slots = slots.reshape(-1, chunk, 6 + channels).transpose(1, 2)
    return (cstarts.to(torch.int32), slots[:, :6].contiguous(),
            slots[:, 6:].contiguous())


def preprocess_scene(layout, degree, device, n=4000, res=128, seed=5):
    """Seeded splats of one view (``ops/preprocess.py::preprocess_view``'s
    arguments after ``settings``, on ``device``): (settings, means, scales,
    rotations, opacity, shs, normal, valid, config, with_normal).

    ``layout`` "learned": C = 12 with normals, opacity-aware rects,
    (n, (degree + 1)², 3) SH; "analytic": C = 9, no normals, (n, 13, 3) SH
    (more when the degree needs them) and the last splat's rotation
    expanded to all. Camera at the origin looking down +z (tanfov 1,
    ``res``²). Every scene holds splats behind the near plane, off
    screen, masked out, of opacity <= 1/255, and last a rank-one
    covariance along x = y at the centre whose projected determinant is
    exactly 0."""
    from gpcr_tpu_torch.ops import rasterize as R

    rng = np.random.RandomState(seed + degree)
    means = (rng.randn(n, 3) * 0.4 + (0, 0, 2.5)).astype(np.float32)
    tenth = n // 10
    means[:tenth, 2] = rng.uniform(-1.0, 0.25, tenth)  # behind the near plane
    means[tenth:2 * tenth, 0] += 5.0  # off screen
    scales = (rng.rand(n, 3) * 0.05 + 0.001).astype(np.float32)
    rots = rng.randn(n, 4).astype(np.float32)
    means[-1], scales[-1] = (0, 0, 2.5), (1e3, 0, 0)
    rots[-1] = (0.5, 0, 0, 0.5)
    op = rng.rand(n).astype(np.float32)
    op[2 * tenth:3 * tenth] = rng.uniform(0, 1 / 255, tenth)
    k = (degree + 1) ** 2
    if layout == "analytic":
        k = max(13, k)
    shs = (rng.randn(n, k, 3) * 0.5).astype(np.float32)
    normal = rng.randn(n, 3).astype(np.float32)
    valid = rng.rand(n) > 0.1
    valid[-1] = True
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = P[1, 1] = 1.0
    P[3, 2] = 1.0
    P[2, 2] = 100.0 / (100.0 - 0.01)
    P[2, 3] = -(100.0 * 0.01) / (100.0 - 0.01)

    def t(x):
        return torch.from_numpy(x).to(device)

    with_normal = layout == "learned"
    settings = R.GaussianRasterizationSettings(
        image_height=res, image_width=res, tanfovx=1.0, tanfovy=1.0,
        bg=torch.zeros(12 if with_normal else 9, device=device),
        scale_modifier=1.0, viewmatrix=torch.eye(4, device=device),
        projmatrix=t(P.T.copy()), sh_degree=degree,
        campos=torch.zeros(3, device=device))
    # analytic: the last splat's rotation, stride 0
    rotations = t(rots) if with_normal else t(rots[-1]).expand(n, 4)
    config = R.RasterizeConfig(opacity_radius=with_normal)
    return (settings, t(means), t(scales), rotations, t(op), t(shs),
            t(normal), t(valid), config, with_normal)
