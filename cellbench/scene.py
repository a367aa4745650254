"""The one general generator of the benchmark's inputs, driven by the data
files of a cell and by ``--seed``:

- ``cloud``: a configuration's ``cloud`` block made on the device: points
  on a sphere stretched along y, scaled, jittered by Gaussian noise and
  laid on the voxel grid (x * scale_factor + offset, clamped to the grid),
  with uniform colours;
- ``Cameras``: a traffic mix's ring of views per request. Each request is
  ``views`` look-at-origin cameras evenly spaced on a horizontal ring of
  ``ring_radius``, the ring turned by an angle drawn per request, so that
  no camera repeats. Poses are drawn in blocks of ``BLOCK`` requests (one
  copy to the device per block), so a window of any length never runs
  out.

Every draw comes from its own generator seeded by (seed, stream), so the
same seed gives the same inputs whatever else a run draws.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 256
STREAM_CLOUD, STREAM_WEIGHTS, STREAM_CAMERAS, STREAM_SAMPLE = 1, 2, 3, 4


def generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) << 3) + stream)
    return g


def cloud(params: dict, seed: int, device):
    """(xyz (n, 3) f32 grid coordinates, rgb (n, 3) f32) on ``device``."""
    g = generator(seed, STREAM_CLOUD, device)
    n = params["points"]
    v = torch.randn((n, 3), generator=g, device=device)
    v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    v = v * torch.tensor([1.0, params["stretch_y"], 1.0], device=device)
    v = v * params["radius"]
    v = v + torch.randn((n, 3), generator=g, device=device) * params["noise"]
    xyz = torch.clamp(v * params["scale_factor"] + params["offset"], 0,
                      params["grid"] - 1)
    rgb = torch.rand((n, 3), generator=g, device=device)
    return xyz.contiguous(), rgb


def ring_poses(angles: np.ndarray, views: int, radius: float) -> np.ndarray:
    """(R,) ring angles -> (R, views, 4, 4) float32 camera-to-world poses:
    x right, y down (world -y), z towards the origin."""
    theta = angles[:, None] + 2 * math.pi * np.arange(views)[None] / views
    pos = np.stack([radius * np.cos(theta), np.zeros_like(theta),
                    radius * np.sin(theta)], -1)
    z = -pos / radius
    y = np.broadcast_to(np.array([0.0, -1.0, 0.0]), z.shape)
    x = np.cross(y, z)
    pose = np.zeros(theta.shape + (4, 4))
    pose[..., :3, 0], pose[..., :3, 1], pose[..., :3, 2] = x, y, z
    pose[..., :3, 3] = pos
    pose[..., 3, 3] = 1.0
    return pose.astype(np.float32)


class Cameras:
    """Per-request poses of a traffic mix: ``request(i)`` (views, 4, 4)
    on the device for window request i, ``warm(i)`` for warm-up request
    i (drawn apart, so the window's cameras are the same with any
    number of warm requests)."""

    def __init__(self, traffic: dict, seed: int, device):
        self.t = traffic
        self.seed = int(seed)
        self.device = device
        self._blocks: dict = {}

    def _block(self, kind: int, b: int) -> torch.Tensor:
        key = (kind, b)
        if key not in self._blocks:
            rng = np.random.default_rng([self.seed, STREAM_CAMERAS, kind, b])
            poses = ring_poses(rng.uniform(0, 2 * math.pi, BLOCK),
                               self.t["views"], self.t["ring_radius"])
            self._blocks = {key: torch.as_tensor(poses, device=self.device)}
        return self._blocks[key]

    def request(self, i: int) -> torch.Tensor:
        return self._block(0, i // BLOCK)[i % BLOCK]

    def warm(self, i: int) -> torch.Tensor:
        return self._block(1, i // BLOCK)[i % BLOCK]
