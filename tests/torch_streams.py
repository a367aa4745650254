"""Seeded tile streams for the port's blend-kernel tests
(``test_torch_gpu.py`` on the card, ``test_torch_stream_vjp.py`` on the
CPU). Imports no JAX."""

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
