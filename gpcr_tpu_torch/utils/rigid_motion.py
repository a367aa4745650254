"""SE(3) / SO(3) helpers (port of ``gpcr_tpu/utils/rigid_motion.py``):
Rodrigues minimal rotation, Gram-Schmidt frames, look-at poses, the rigid
inverse, geodesic pose interpolation and random camera poses on a
spherical shell."""

from __future__ import annotations

import math
import typing as T

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


def get_H_c2w_lookat(pinhole_location_w, look_at_w, up_w,
                     invert_y: bool = True) -> torch.Tensor:
    """Camera pose (*, 4, 4) H_c2w from eye / look-at / up (each (*, 3),
    broadcast together; tensors or arrays). ``invert_y`` flips the y axis
    to image coordinates (x right, y down). The pose lies on the eye's
    device when the eye is a tensor."""
    dev = (pinhole_location_w.device
           if isinstance(pinhole_location_w, torch.Tensor) else None)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    eye, look, up = f32(pinhole_location_w), f32(look_at_w), f32(up_w)
    eye, look, up = torch.broadcast_tensors(eye, look, up)
    R = construct_coord_frame(z=look - eye, y=(-up if invert_y else up))
    H = torch.zeros((*R.shape[:-2], 4, 4), dtype=torch.float32, device=dev)
    H[..., :3, :3] = R
    H[..., :3, 3] = eye
    H[..., 3, 3] = 1.0
    return H


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


def generate_random_camera_poses(
    n: int,
    min_r: float,
    max_r: float,
    max_angle: float = 180.0,
    local_max_angle: float = 3.0,
    max_translate_ratio: float = 1.0,
    generator: T.Optional[torch.Generator] = None,
    device=None,
) -> torch.Tensor:
    """Random look-at camera poses (n, 4, 4) H_c2w on a spherical shell:
    radius uniform in [min_r, max_r), azimuth in [0, 2 pi), elevation
    within +-max_angle / 2 degrees (max_angle clipped to [0, 180]), looking
    at a point uniform in +-deg2rad(local_max_angle) * max_translate_ratio
    per axis, up +y. The draws come from ``generator`` (on the CPU) and
    differ from the JAX package's ``jax.random`` bits; their ranges do
    not."""
    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    r = uniform((n,), min_r, max_r)
    theta = uniform((n,), 0.0, 2 * math.pi)
    max_phi = math.radians(min(max(max_angle, 0.0), 180.0)) / 2.0
    phi = uniform((n,), -max_phi, max_phi)
    eye = torch.stack([r * torch.cos(phi) * torch.cos(theta),
                       r * torch.cos(phi) * torch.sin(theta),
                       r * torch.sin(phi)], dim=-1)
    jitter = math.radians(local_max_angle)
    look = uniform((n, 3), -jitter, jitter) * max_translate_ratio
    return get_H_c2w_lookat(eye.to(device), look.to(device),
                            torch.tensor([0.0, 1.0, 0.0], device=device))
