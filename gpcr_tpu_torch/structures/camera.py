"""Batched pinhole cameras (port of the render- and training-path part
of ``gpcr_tpu/structures/camera.py``).

``H_c2w`` is (b, q, 4, 4) camera-to-world with image y pointing down;
``intrinsic`` is (b, q, 3, 3) with f = 0.5 * width / tan(fov/2). Rays
leave pixel centers: uv + 0.5, direction = H_c2w[:3,:3] @ inv(K) @
[u, v, 1], normalized.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def derive_camera_intrinsics(width_px: int, height_px: int, fov: float,
                             device=None) -> torch.Tensor:
    """3x3 intrinsics from fov in degrees."""
    f = 0.5 * float(width_px) / np.tan(0.5 * fov / 180.0 * np.pi)
    return torch.tensor(
        [[f, 0.0, width_px * 0.5], [0.0, f, height_px * 0.5], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def generate_camera_rays_from_uv(cam_poses, intrinsics, uv):
    """Rays in world coordinates through given sensor uv points.

    cam_poses (m, 4, 4) H_c2w; intrinsics (m, 3, 3); uv (m, *p, 2) with u in
    [0, w], v in [0, h], origin top-left. Returns (origins (m, *p, 3),
    directions (m, *p, 3) unit-norm).
    """
    m = cam_poses.shape[0]
    ones = [1] * (uv.dim() - 2)
    uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    inv_K = torch.linalg.inv(intrinsics).reshape(m, *ones, 3, 3)
    dirs_c = (inv_K @ uv1[..., None])[..., 0]
    R = cam_poses[:, :3, :3].reshape(m, *ones, 3, 3)
    dirs_w = (R @ dirs_c[..., None])[..., 0]
    dirs_w = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    origins = cam_poses[:, :3, 3].reshape(m, *ones, 3).expand_as(dirs_w)
    return origins, dirs_w


@dataclasses.dataclass(frozen=True)
class Camera:
    """(b, q) batch of pinhole cameras."""

    H_c2w: torch.Tensor  # (b, q, 4, 4)
    intrinsic: torch.Tensor  # (b, q, 3, 3)
    width_px: int
    height_px: int

    @property
    def device(self) -> torch.device:
        return self.H_c2w.device

    def get_H_w2c(self) -> torch.Tensor:
        """Closed-form rigid inverse of ``H_c2w``."""
        from ..utils.rigid_motion import inv_homogeneous

        return inv_homogeneous(self.H_c2w)

    def generate_camera_rays(self, subsample: int = 1, offsets="center"):
        """Per-pixel rays. Returns (origins, dirs): (b, q, h', w', 3).

        ``offsets='center'`` gives pixel-center rays (+0.5); a float or
        (..., 2) array adds a custom sensor offset.
        """
        b, q = self.H_c2w.shape[:2]
        f32 = dict(dtype=torch.float32, device=self.device)
        u = torch.arange(0, self.width_px, subsample, **f32) + 0.5
        v = torch.arange(0, self.height_px, subsample, **f32) + 0.5
        uu, vv = torch.meshgrid(u, v, indexing="xy")
        uv = torch.stack([uu, vv], dim=-1)  # (h', w', 2)
        if isinstance(offsets, str):
            if offsets != "center":
                raise NotImplementedError(offsets)
        else:
            uv = uv + torch.as_tensor(np.asarray(offsets, np.float32), **f32)
        uv = uv.expand(b * q, *uv.shape)
        o, d = generate_camera_rays_from_uv(
            self.H_c2w.reshape(b * q, 4, 4),
            self.intrinsic.reshape(b * q, 3, 3), uv)
        hw = uv.shape[1:3]
        return o.reshape(b, q, *hw, 3), d.reshape(b, q, *hw, 3)

    def __getitem__(self, ib) -> "Camera":
        if isinstance(ib, int):
            ib = slice(ib, ib + 1)
        return dataclasses.replace(
            self, H_c2w=self.H_c2w[ib], intrinsic=self.intrinsic[ib])

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, H_c2w=self.H_c2w.to(device),
            intrinsic=self.intrinsic.to(device))
