"""SE(3) / SO(3) helpers the camera path needs (port of the matching
functions of ``gpcr_tpu/utils/rigid_motion.py``: the circle path, the
rigid inverse, and the geodesic interpolation behind
``Camera.uniformly_sample``)."""

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


def log_rotation(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SO(3) log map: (*, 3, 3) -> (*, 3) axis * angle."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_theta = torch.sin(theta)
    scale = torch.where(
        sin_theta.abs() < eps, torch.full_like(theta, 0.5),
        theta / (2.0 * torch.clamp(sin_theta, min=eps)))
    return w * scale[..., None]


def exp_skew_symmetric(w: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SO(3) exp map: (*, 3) axis * angle -> (*, 3, 3) rotation."""
    theta = torch.linalg.norm(w, dim=-1, keepdim=True)
    K = cross_product_matrix(w / torch.clamp(theta, min=eps))
    s = torch.sin(theta)[..., None]
    c = (1.0 - torch.cos(theta))[..., None]
    eye3 = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = eye3 + s * K + c * (K @ K)
    return torch.where(theta[..., None] < eps, eye3, R)


def interp_homogeneous(H0: torch.Tensor, H1: torch.Tensor, t) -> torch.Tensor:
    """Geodesic interpolation between rigid poses H0, H1 (*, 4, 4) at t
    (scalar or (*,)) in [0, 1]."""
    t = torch.as_tensor(t, dtype=torch.float32, device=H0.device)
    R0, R1 = H0[..., :3, :3], H1[..., :3, :3]
    w = log_rotation(R0.transpose(-2, -1) @ R1)
    Rt = R0 @ exp_skew_symmetric(w * t[..., None])
    pt = (1.0 - t[..., None]) * H0[..., :3, 3] + t[..., None] * H1[..., :3, 3]
    H = torch.zeros_like(H0)
    H[..., :3, :3] = Rt
    H[..., :3, 3] = pt
    H[..., 3, 3] = 1.0
    return H
