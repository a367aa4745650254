"""Batched pinhole cameras (port of the render-path part of
``gpcr_tpu/structures/camera.py``).

``H_c2w`` is (b, q, 4, 4) camera-to-world with image y pointing down;
``intrinsic`` is (b, q, 3, 3) with f = 0.5 * width / tan(fov/2).
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

    def __getitem__(self, ib) -> "Camera":
        if isinstance(ib, int):
            ib = slice(ib, ib + 1)
        return dataclasses.replace(
            self, H_c2w=self.H_c2w[ib], intrinsic=self.intrinsic[ib])

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, H_c2w=self.H_c2w.to(device),
            intrinsic=self.intrinsic.to(device))
