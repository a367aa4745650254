"""Ray and camera geometry (port of ``gpcr_tpu/utils/geometry.py``), in
torch on the device of the input tensors.

Ray-AABB slab test, point-to-ray distances, the k points nearest to each
ray (by perpendicular distance inside a [t_min, t_max] window, optionally
re-ranked by distance to a point on the ray), pinhole projection, uv
correspondence, bilinear uv sampling with edge clamping, per-pixel capture
geometry and ray-local point coordinates.
"""

from __future__ import annotations

import torch


def ray_aabb_intersection(
    ray_origin, ray_direction, bbox_min_bounds, bbox_max_bounds,
    bbox_scaling_ratio: float = 1.0, t_min: float = 0.0, t_max: float = 1e10,
):
    """Slab test, batched over leading dims. Returns dict(is_intersected,
    t_near, t_far)."""
    center = 0.5 * (bbox_min_bounds + bbox_max_bounds)
    lo = center + (bbox_min_bounds - center) * bbox_scaling_ratio
    hi = center + (bbox_max_bounds - center) * bbox_scaling_ratio
    inv_d = 1.0 / ray_direction
    t1 = (lo - ray_origin) * inv_d
    t2 = (hi - ray_origin) * inv_d
    t_nears = torch.minimum(t1, t2)
    t_fars = torch.maximum(t1, t2)
    t_nears = torch.where(torch.isnan(t_nears), float("-inf"), t_nears)
    t_fars = torch.where(torch.isnan(t_fars), float("inf"), t_fars)
    t_near = torch.clamp(torch.amax(t_nears, dim=-1), min=t_min)
    t_far = torch.clamp(torch.amin(t_fars, dim=-1), max=t_max)
    return {"is_intersected": t_near <= t_far, "t_near": t_near,
            "t_far": t_far}


def compute_point_ray_distance(points, ray_origins, ray_directions):
    """points (*, n, 3); rays (*, m, 3). Returns dict(dists (*, m, n),
    projections (*, m, n, 3), ts (*, m, n))."""
    p = points[..., None, :, :]  # (*, 1, n, 3)
    o = ray_origins[..., :, None, :]  # (*, m, 1, 3)
    d = ray_directions[..., :, None, :]
    ts = torch.sum((p - o) * d, dim=-1, keepdim=True)
    proj = o + ts * d
    dists = torch.linalg.norm(p - proj, dim=-1)
    return {"dists": dists, "projections": proj, "ts": ts[..., 0]}


def _dists_and_ts(points, ray_origins, ray_directions):
    """The dists and ts of ``compute_point_ray_distance`` with the same
    float32 operations, one coordinate at a time: (*, m, n) temporaries
    instead of its (*, m, n, 3) projections."""
    p = [points[..., None, :, c] for c in range(3)]  # (*, 1, n)
    o = [ray_origins[..., :, c, None] for c in range(3)]  # (*, m, 1)
    d = [ray_directions[..., :, c, None] for c in range(3)]
    ts = (p[0] - o[0]) * d[0] + (p[1] - o[1]) * d[1] + (p[2] - o[2]) * d[2]
    sq = None
    for c in range(3):
        e = p[c] - (o[c] + ts * d[c])
        sq = e * e if sq is None else sq + e * e
    return torch.sqrt(sq), ts


def _smallest_k(values: torch.Tensor, k: int):
    """(sorted values, indices) of the k smallest along the last axis,
    equal values in ascending index order (``lax.top_k``'s order on the
    negated values). Non-negative float32 (inf included) sorts by its bit
    pattern, so one int64 key (bits << 32 | index) ranks values and breaks
    ties in one ``topk``; other inputs take a stable sort."""
    n = values.shape[-1]
    if values.dtype == torch.float32 and n < (1 << 31):
        bits = values.contiguous().view(torch.int32).to(torch.int64)
        idx = torch.arange(n, device=values.device)
        key = (bits << 32) | idx
        _, pos = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    else:
        pos = torch.sort(values, dim=-1, stable=True)[1][..., :k]
    return torch.gather(values, -1, pos), pos


def get_k_neighbor_points(
    points, ray_origins, ray_directions, k: int,
    t_min: float = 0.0, t_max: float = 1e10, t_init=None,
):
    """k nearest points to each ray by perpendicular distance, restricted
    to the [t_min, t_max] projection window; points outside it rank at
    +inf. With ``t_init``, finds 2k candidates, then re-ranks them by 3D
    distance to the t_init point on the ray.

    Returns dict(sorted_dists, sorted_idxs, sorted_ts): (*, m, k); equal
    distances (every +inf among them) in ascending point index."""
    dists, ts = _dists_and_ts(points, ray_origins, ray_directions)
    invalid = (ts < t_min) | (ts > t_max)
    dists = torch.where(invalid, float("inf"), dists)

    kk = 2 * k if t_init is not None else k
    kk = min(kk, dists.shape[-1])
    top_dists, idxs = _smallest_k(dists, kk)
    top_ts = torch.gather(ts, -1, idxs)
    if t_init is not None:
        point_d2 = torch.square(top_ts - t_init[..., None]) + torch.square(
            top_dists)
        rr = torch.sort(point_d2, dim=-1, stable=True)[1][..., :min(k, kk)]
        top_dists = torch.gather(top_dists, -1, rr)
        idxs = torch.gather(idxs, -1, rr)
        top_ts = torch.gather(top_ts, -1, rr)
    return {"sorted_dists": top_dists, "sorted_idxs": idxs,
            "sorted_ts": top_ts}


def get_k_neighbor_points_in_chunks(
    points, ray_origins, ray_directions, k: int, chunk_rays: int = 4096,
    **kwargs,
):
    """``get_k_neighbor_points`` over slices of ``chunk_rays`` rays: the
    same result, with (chunk_rays, n) temporaries. ``t_init``, when given,
    is sliced with the rays."""
    m = ray_origins.shape[-2]
    t_init = kwargs.pop("t_init", None)
    parts = []
    for s in range(0, m, chunk_rays):
        sl = slice(s, s + chunk_rays)
        parts.append(get_k_neighbor_points(
            points, ray_origins[..., sl, :], ray_directions[..., sl, :], k,
            t_init=None if t_init is None else t_init[..., sl], **kwargs))
    return {key: torch.cat([p[key] for p in parts], dim=-2)
            for key in parts[0]}


def pinhole_projection(xyz_w, intrinsic, H_c2w):
    """World points -> sensor uv + camera z.

    xyz_w (*, n, 3); intrinsic (*, 3, 3); H_c2w (*, 4, 4). Returns dict(uv
    (*, n, 2) pixel coords, z (*, n), in_front (*, n))."""
    from .rigid_motion import inv_homogeneous

    H_w2c = inv_homogeneous(H_c2w)
    R = H_w2c[..., :3, :3]
    t = H_w2c[..., :3, 3]
    xyz_c = torch.einsum("...ij,...nj->...ni", R, xyz_w) + t[..., None, :]
    z = xyz_c[..., 2]
    uvw = torch.einsum("...ij,...nj->...ni", intrinsic, xyz_c)
    uv = uvw[..., :2] / torch.clamp(uvw[..., 2:3], min=1e-12)
    return {"uv": uv, "z": z, "in_front": z > 0}


def find_corresponding_uv(xyz_w, intrinsic, H_c2w, width_px, height_px):
    """Project world points into a camera and report which land in front
    of it inside the sensor rectangle."""
    out = pinhole_projection(xyz_w, intrinsic, H_c2w)
    uv = out["uv"]
    inside = ((uv[..., 0] >= 0) & (uv[..., 0] < width_px)
              & (uv[..., 1] >= 0) & (uv[..., 1] < height_px)
              & out["in_front"])
    return {"uv": uv, "z": out["z"], "valid": inside}


def uv_sampling(feature_map, uv, height_px=None, width_px=None):
    """Bilinear sampling of (*, h, w, c) maps at uv pixel coordinates
    (pixel centres at +0.5; corners clamped to the edge, weights to
    [0, 1]: not ``F.grid_sample``'s padding).

    uv: (*, n, 2) in pixel units (u in [0, w], v in [0, h]). Returns
    (*, n, c)."""
    h, w = feature_map.shape[-3], feature_map.shape[-2]
    x = uv[..., 0] - 0.5
    y = uv[..., 1] - 0.5
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(x - x0, 0.0, 1.0)[..., None]
    fy = torch.clamp(y - y0, 0.0, 1.0)[..., None]
    x0, x1, y0, y1 = (a.long() for a in (x0, x1, y0, y1))

    def gather(yy, xx):
        if feature_map.dim() == 3:
            return feature_map[yy, xx]
        flat = feature_map.reshape(*feature_map.shape[:-3], h * w,
                                   feature_map.shape[-1])
        idx = (yy * w + xx)[..., None].expand(*yy.shape, flat.shape[-1])
        return torch.gather(flat, -2, idx)

    top = gather(y0, x0) * (1 - fx) + gather(y0, x1) * fx
    bot = gather(y1, x0) * (1 - fx) + gather(y1, x1) * fx
    return top * (1 - fy) + bot * fy


def compute_3d_zdir_and_dps(z_map, intrinsic, H_c2w):
    """Per-pixel capture geometry: the capturing camera's z axis in world
    (``zdir_w``), the distance per sample z / f (``dps``) and that step
    along the camera x / y axes in world (``dps_u_w`` / ``dps_v_w``).

    z_map (*, h, w); intrinsic (*, 3, 3); H_c2w (*, 4, 4). Returns maps
    (*, h, w, 3) and (*, h, w, 1)."""
    fx = intrinsic[..., 0, 0]
    fy = intrinsic[..., 1, 1]
    xaxis = H_c2w[..., :3, 0]
    yaxis = H_c2w[..., :3, 1]
    zaxis = H_c2w[..., :3, 2]
    shp = z_map.shape
    zdir = zaxis[..., None, None, :].expand(*shp, 3)
    z = z_map[..., None]
    dps_u = z / fx[..., None, None, None] * xaxis[..., None, None, :]
    dps_v = z / fy[..., None, None, None] * yaxis[..., None, None, :]
    dps = z / fx[..., None, None, None]
    return {"zdir_w": zdir, "dps": dps, "dps_u_w": dps_u, "dps_v_w": dps_v}


def rectify_points(points, ray_origins, ray_directions):
    """Points in each ray's local frame: t along the ray and the
    perpendicular offset. Returns dict(ts (*, m, n), perp (*, m, n, 3))."""
    dd = compute_point_ray_distance(points, ray_origins, ray_directions)
    perp = points[..., None, :, :] - dd["projections"]
    return {"ts": dd["ts"], "perp": perp}
