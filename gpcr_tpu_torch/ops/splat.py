"""Analytic 3D-Gaussian splat math (port of ``gpcr_tpu/ops/splat.py``).

The per-Gaussian preprocessing of the reference CUDA rasterizer
(``forward.cu:20-259`` + ``auxiliary.h``), float32, same numerics:
quaternions not normalized, +0.3 cov2D low-pass, the ±1.3·tanfov clamp
before the EWA Jacobian, near cull at z <= 0.2, radius =
ceil(3·sqrt(λmax)) with the max(0.1, ·) guard, ndc2Pix(v, S) =
((v+1)·S − 1)/2.

``viewmatrix`` / ``projmatrix`` are the TRANSPOSED world-to-camera / full
projection matrices, so points transform as ``[p, 1] @ M``.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion -> (..., 3, 3) rotation, NOT normalized."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], -1)
    row1 = torch.stack(
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], -1)
    row2 = torch.stack(
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def compute_cov3d(scales: torch.Tensor, scale_modifier: float,
                  quats: torch.Tensor) -> torch.Tensor:
    """Σ = R·diag(s²)·Rᵀ packed (..., 6) as (xx, xy, xz, yy, yz, zz)."""
    r, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    ) * (scales * scale_modifier).repeat(*([1] * (scales.dim() - 1)), 3)
    m00, m01, m02 = m[..., 0], m[..., 1], m[..., 2]
    m10, m11, m12 = m[..., 3], m[..., 4], m[..., 5]
    m20, m21, m22 = m[..., 6], m[..., 7], m[..., 8]
    return torch.stack(
        [
            m00 * m00 + m01 * m01 + m02 * m02,
            m00 * m10 + m01 * m11 + m02 * m12,
            m00 * m20 + m01 * m21 + m02 * m22,
            m10 * m10 + m11 * m11 + m12 * m12,
            m10 * m20 + m11 * m21 + m12 * m22,
            m20 * m20 + m21 * m21 + m22 * m22,
        ],
        dim=-1,
    )


def transform_point_4x3(p: torch.Tensor, matrix_t: torch.Tensor) -> torch.Tensor:
    """[p, 1] @ M[:, :3]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    cols = [
        x * matrix_t[0, j] + y * matrix_t[1, j] + z * matrix_t[2, j]
        + matrix_t[3, j]
        for j in range(3)
    ]
    return torch.stack(cols, dim=-1)


def transform_point_4x4(p: torch.Tensor, matrix_t: torch.Tensor) -> torch.Tensor:
    """[p, 1] @ M."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    cols = [
        x * matrix_t[0, j] + y * matrix_t[1, j] + z * matrix_t[2, j]
        + matrix_t[3, j]
        for j in range(4)
    ]
    return torch.stack(cols, dim=-1)


def compute_cov2d(mean3d, focal_x, focal_y, tan_fovx, tan_fovy, cov3d,
                  viewmatrix):
    """EWA 3D→2D covariance projection; returns (N, 3) (xx, xy, yy) with
    the +0.3 diagonal low-pass."""
    t = transform_point_4x3(mean3d, viewmatrix)
    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    tz = t[..., 2]
    txtz = t[..., 0] / tz
    tytz = t[..., 1] / tz
    tx = torch.clamp(txtz, -limx, limx) * tz
    ty = torch.clamp(tytz, -limy, limy) * tz

    # focal lengths as float32 tensors: ``scalar / tensor`` in torch is
    # reciprocal-then-multiply (two roundings), not a true division
    focal_x = torch.full_like(tz, focal_x)
    focal_y = torch.full_like(tz, focal_y)
    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)

    w = viewmatrix  # w[j][i] = R_w2c[i, j]
    a0 = j00 * w[0, 0] + j02 * w[0, 2]
    a1 = j00 * w[1, 0] + j02 * w[1, 2]
    a2 = j00 * w[2, 0] + j02 * w[2, 2]
    b0 = j11 * w[0, 1] + j12 * w[0, 2]
    b1 = j11 * w[1, 1] + j12 * w[1, 2]
    b2 = j11 * w[2, 1] + j12 * w[2, 2]

    xx, xy, xz = cov3d[..., 0], cov3d[..., 1], cov3d[..., 2]
    yy, yz, zz = cov3d[..., 3], cov3d[..., 4], cov3d[..., 5]
    va0 = xx * a0 + xy * a1 + xz * a2
    va1 = xy * a0 + yy * a1 + yz * a2
    va2 = xz * a0 + yz * a1 + zz * a2
    vb0 = xx * b0 + xy * b1 + xz * b2
    vb1 = xy * b0 + yy * b1 + yz * b2
    vb2 = xz * b0 + yz * b1 + zz * b2
    c00 = a0 * va0 + a1 * va1 + a2 * va2
    c01 = a0 * vb0 + a1 * vb1 + a2 * vb2
    c11 = b0 * vb0 + b1 * vb1 + b2 * vb2
    return torch.stack([c00 + 0.3, c01, c11 + 0.3], dim=-1)


def ndc2pix(v, S):
    """((v + 1)·S − 1)/2."""
    return ((v + 1.0) * S - 1.0) * 0.5


def project_points(mean3d, projmatrix):
    """Full projective transform with the 1e-7-guarded divide; (N, 3) NDC."""
    p_hom = transform_point_4x4(mean3d, projmatrix)
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    return p_hom[..., :3] * p_w[..., None]


def conic_and_radius(cov2d, opacity=None):
    """Invert the 2D covariance and bound the splat extent.

    Returns (conic (N,3), radius (N,), det_valid (N,) bool), plus the
    opacity-aware TIGHT radius (N,) when ``opacity`` is given:
    r = ceil(sqrt(min(9, 2·ln(255·op))·λmax)) + 1, clamped at the 3σ
    radius, and 0 for op <= 1/255 (no pixel can clear the blend's
    α >= 1/255 test). See ``gpcr_tpu.ops.splat.conic_and_radius``.
    """
    det = cov2d[..., 0] * cov2d[..., 2] - cov2d[..., 1] * cov2d[..., 1]
    det_valid = det != 0.0
    det_inv = 1.0 / torch.where(det_valid, det, torch.ones_like(det))
    conic = torch.stack(
        [cov2d[..., 2] * det_inv, -cov2d[..., 1] * det_inv,
         cov2d[..., 0] * det_inv],
        dim=-1,
    )
    mid = 0.5 * (cov2d[..., 0] + cov2d[..., 2])
    disc = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + disc
    lambda2 = mid - disc
    lmax = torch.maximum(lambda1, lambda2)
    radius = torch.ceil(3.0 * torch.sqrt(lmax))
    if opacity is None:
        return conic, radius, det_valid
    thr = 2.0 * torch.log(255.0 * torch.clamp(opacity, min=1e-12))
    r_tight = torch.where(
        thr > 0.0,
        torch.minimum(
            radius,
            torch.ceil(torch.sqrt(torch.clamp(thr, max=9.0) * lmax)) + 1.0,
        ),
        torch.zeros_like(radius),
    )
    return conic, radius, det_valid, r_tight


def get_rect(point_image, radius, grid_x, grid_y, tile_x, tile_y):
    """Tile bounding rectangle (auxiliary.h:46-56); C's float->int cast
    truncates toward zero, reproduced with trunc before the clamp."""
    px, py = point_image[..., 0], point_image[..., 1]
    rmin_x = torch.clamp(torch.trunc((px - radius) / tile_x), 0, grid_x).to(torch.int32)
    rmin_y = torch.clamp(torch.trunc((py - radius) / tile_y), 0, grid_y).to(torch.int32)
    rmax_x = torch.clamp(
        torch.trunc((px + radius + tile_x - 1) / tile_x), 0, grid_x
    ).to(torch.int32)
    rmax_y = torch.clamp(
        torch.trunc((py + radius + tile_y - 1) / tile_y), 0, grid_y
    ).to(torch.int32)
    return rmin_x, rmin_y, rmax_x, rmax_y


def in_frustum(mean3d, viewmatrix):
    """Near cull: view-space z > 0.2. Returns (p_view (N,3), mask (N,))."""
    p_view = transform_point_4x3(mean3d, viewmatrix)
    return p_view, p_view[..., 2] > 0.2
