"""SE(3) / SO(3) helpers the camera path needs (port of the matching
functions of ``gpcr_tpu/utils/rigid_motion.py``)."""

from __future__ import annotations

import torch


def cross_product_matrix(v: torch.Tensor) -> torch.Tensor:
    """(*, 3) -> (*, 3, 3) skew matrix [v]_x."""
    zero = torch.zeros_like(v[..., 0])
    rows = [
        torch.stack([zero, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zero, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def get_min_R(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Rotation taking unit vector v1 onto v2 (Rodrigues); -I for
    antipodal vectors."""
    k = torch.linalg.cross(v1, v2)
    cos_theta = torch.sum(v1 * v2, dim=-1)
    eye3 = torch.eye(3, dtype=v1.dtype, device=v1.device).expand(
        *v1.shape[:-1], 3, 3)
    Kx = cross_product_matrix(k)
    denom = torch.clamp(1.0 + cos_theta, min=1e-12)
    R = eye3 + Kx + (Kx @ Kx) / denom[..., None, None]
    return torch.where(cos_theta[..., None, None] > -1.0 + 1e-9, R, -eye3)


def construct_coord_frame(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(*, 3, 3) rotation with columns [x, y, z] from a z-axis and an
    approximate y-axis (Gram-Schmidt)."""
    x = torch.linalg.cross(y, z)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    y = y - torch.sum(y * z, dim=-1, keepdim=True) * z
    y = y / torch.linalg.norm(y, dim=-1, keepdim=True)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True)
    return torch.stack([x, y, z], dim=-1)


def inv_homogeneous(Hs: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of rigid homogeneous matrices (*, 4, 4)."""
    Rt = Hs[..., :3, :3].transpose(-2, -1)
    t = -(Rt @ Hs[..., :3, 3:4])
    inv = torch.zeros_like(Hs)
    inv[..., :3, :3] = Rt
    inv[..., :3, 3:4] = t
    inv[..., 3, 3] = 1.0
    return inv
