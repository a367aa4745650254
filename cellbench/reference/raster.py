"""Plain PyTorch reference of the splat rasterizer (the published 3D
Gaussian splatting forward: ``forward.cu`` / ``rasterizer_impl.cu``, with
the renderer's conventions), imported by nothing of the program.

Per view, from the camera's camera-to-world pose:

- projection: world -> camera by the rigid inverse of the pose, camera ->
  clip by the OpenGL projection (tan(fov / 2), znear 0.01, zfar 100),
  NDC -> pixels by ((v + 1) S - 1) / 2; points with camera z <= 0.2 are
  culled; the EWA covariance uses focal = S / (2 tan(fov)) (the
  renderer's quirk: tan(fov), not tan(fov / 2)), the 1.3 tan(fov) clamp
  of t / t_z, quaternions as given (not normalised), and a 0.3 low-pass
  on the diagonal;
- extent: radius ceil(3 sqrt(lambda_max)), lambda_max from max(0.1,
  mid^2 - det); with ``opacity_radius`` the tighter ceil(sqrt(min(9,
  2 ln(255 op)) lambda_max)) + 1 bins the splat (0 for op <= 1/255);
  tile rects as C truncation of (p -+ r) / 16;
- colour: SH of degree 1 at the unit direction from the camera, + 0.5,
  clamped at 0; the fused channels [rgb | xyz | 1 (| normal facing the
  camera)] share one pass;
- binning: splats in ascending depth (ties by index), each emitting the
  first min(tiles, dup cap) tiles of its rect row by row; entries sorted
  by (tile, depth order); a k budget keeps the first k sorted entries, a
  tile budget renders only the tiles with the most entries (ties by tile
  id); what is cut renders background;
- blend: per pixel (integer pixel coordinates), entries front to back:
  power = -(a dx^2 + c dy^2) / 2 - b dx dy, skip if power > 0; alpha =
  min(0.99, op e^power), skip if alpha < 1/255; stop before the entry
  whose T (1 - alpha) falls under 1e-4; C += alpha T f, T *= 1 - alpha;
  out = C + T bg, then the mean of each 2x2 block.

It also counts, per view, the work a blend of these inputs needs: the
(entry, pixel) pairs walked (every position a pixel evaluates, up to and
including the one where it stops) and live (composited), the stream
entries and the rendered tiles.
"""

from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
TILE = 16


def camera_transforms(pose: torch.Tensor, fov_deg: float):
    """(4, 4) camera-to-world pose -> (world-to-camera (4, 4), world-to-
    clip (4, 4), camera position (3,))."""
    rot, t = pose[:3, :3], pose[:3, 3]
    w2c = torch.eye(4, device=pose.device)
    w2c[:3, :3] = rot.T
    w2c[:3, 3] = -(rot.T @ t)
    tan_half = math.tan(math.radians(fov_deg) / 2)
    zn, zf = 0.01, 100.0
    proj = torch.zeros((4, 4), device=pose.device)
    proj[0, 0] = 1.0 / tan_half
    proj[1, 1] = 1.0 / tan_half
    proj[3, 2] = 1.0
    proj[2, 2] = zf / (zf - zn)
    proj[2, 3] = -(zf * zn) / (zf - zn)
    return w2c, proj @ w2c, t


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    r, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def project(splats: dict, pose, fov_deg: float, height: int, width: int,
            opacity_radius: bool):
    """Per-splat screen quantities of one view: a dict with ``depth``,
    ``mean2d`` (N, 2), ``conic`` (N, 3), ``rect`` (N, 4) tiles and
    ``valid``."""
    means = splats["means"]
    w2c, full, campos = camera_transforms(pose, fov_deg)
    ones = torch.ones_like(means[:, :1])
    hom = torch.cat([means, ones], 1)
    p_cam = hom @ w2c[:3].T
    clip = hom @ full.T
    ndc = clip[:, :3] / (clip[:, 3:4] + 1e-7)
    mean2d = torch.stack([((ndc[:, 0] + 1) * width - 1) / 2,
                          ((ndc[:, 1] + 1) * height - 1) / 2], 1)

    rs = quat_rotation(splats["rotation"]) * splats["scales"][:, None, :]
    cov3 = rs @ rs.transpose(1, 2)
    tanfov = math.tan(math.radians(fov_deg))
    fx, fy = width / (2 * tanfov), height / (2 * tanfov)
    tz = p_cam[:, 2]
    lim = 1.3 * tanfov
    tx = torch.clamp(p_cam[:, 0] / tz, -lim, lim) * tz
    ty = torch.clamp(p_cam[:, 1] / tz, -lim, lim) * tz
    zero = torch.zeros_like(tz)
    jac = torch.stack([torch.stack([fx / tz, zero, -fx * tx / tz ** 2], 1),
                       torch.stack([zero, fy / tz, -fy * ty / tz ** 2], 1)],
                      1)
    m = jac @ w2c[:3, :3]
    cov2 = m @ cov3 @ m.transpose(1, 2)
    a = cov2[:, 0, 0] + 0.3
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + 0.3
    det = a * c - b * b
    det_ok = det != 0
    safe = torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack([c / safe, -b / safe, a / safe], 1)
    mid = 0.5 * (a + c)
    lmax = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lmax))
    valid = (tz > 0.2) & det_ok & splats["valid"]
    if opacity_radius:
        thr = 2.0 * torch.log(255.0 * torch.clamp(splats["opacity"],
                                                  min=1e-12))
        radius = torch.where(
            thr > 0, torch.minimum(radius, torch.ceil(torch.sqrt(
                torch.clamp(thr, max=9.0) * lmax)) + 1.0),
            torch.zeros_like(radius))
        valid = valid & (radius > 0)
    gx, gy = -(-width // TILE), -(-height // TILE)

    def edge(p, r, hi, extra):
        return torch.clamp(torch.trunc((p + r + extra) / TILE), 0, hi).long()

    rect = torch.stack([edge(mean2d[:, 0], -radius, gx, 0),
                        edge(mean2d[:, 1], -radius, gy, 0),
                        edge(mean2d[:, 0], radius, gx, TILE - 1),
                        edge(mean2d[:, 1], radius, gy, TILE - 1)], 1)
    area = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
    return {"depth": p_cam[:, 2], "mean2d": mean2d, "conic": conic,
            "rect": rect, "valid": valid & (area > 0), "campos": campos}


def features(splats: dict, campos, with_normal: bool) -> torch.Tensor:
    """Fused per-splat channels of one view: [rgb | xyz | 1 (| normal)]."""
    means = splats["means"]
    d = means - campos
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    sh = splats["sh"]
    rgb = (SH_C0 * sh[:, 0] - SH_C1 * d[:, 1:2] * sh[:, 1]
           + SH_C1 * d[:, 2:3] * sh[:, 2] - SH_C1 * d[:, 0:1] * sh[:, 3])
    cols = [torch.clamp(rgb + 0.5, min=0.0), means, torch.ones_like(means)]
    if with_normal:
        n = splats["normal"]
        facing = ((d * n).sum(1, keepdim=True) > 0).to(n.dtype) * 2 - 1
        cols.append(-n * facing)
    return torch.cat(cols, 1)


def binned(scr: dict, dup_cap: int, k_budget, chunk: int, grid_x: int):
    """Entries of one view in blend order: (splat index per entry (E,),
    tile per entry (E,), dropped entries)."""
    n = scr["depth"].numel()
    order = torch.sort(torch.where(scr["valid"], scr["depth"],
                                   torch.full_like(scr["depth"], math.inf)),
                       stable=True)[1]
    rect = scr["rect"][order]
    valid = scr["valid"][order]
    w = rect[:, 2] - rect[:, 0]
    area = torch.where(valid, w * (rect[:, 3] - rect[:, 1]), 0)
    kept = torch.clamp(area, max=dup_cap)
    dropped = int((area - kept).sum())
    rank = torch.repeat_interleave(torch.arange(n, device=area.device), kept)
    k = torch.arange(rank.numel(), device=area.device) - (
        torch.cumsum(kept, 0) - kept)[rank]
    wr = torch.clamp(w[rank], min=1)
    tile = ((rect[rank, 1] + k // wr) * grid_x + rect[rank, 0] + k % wr)
    key = torch.sort(tile * (n + 1) + rank)[0]
    tile, rank = key // (n + 1), key % (n + 1)
    if k_budget:
        kb = min(-(-k_budget // chunk) * chunk, n * dup_cap)
        dropped += max(tile.numel() - kb, 0)
        tile, rank = tile[:kb], rank[:kb]
    return order[rank], tile, dropped


def blend(rows: torch.Tensor, feats: torch.Tensor, tile: torch.Tensor,
          num_tiles: int, grid_x: int, bg: torch.Tensor, max_tiles,
          tile_batch: int = 128, chunk: int = 256):
    """Front-to-back blend of entries sorted by (tile, depth). ``rows``
    (E, 6) = [x, y, conic a, b, c, opacity], ``feats`` (E, C). Returns
    ((C, H, W) full-resolution image on the tile grid, walked pairs, live
    pairs, rendered tiles)."""
    dev = rows.device
    ch = feats.shape[1]
    counts = torch.bincount(tile, minlength=num_tiles)
    starts = torch.cumsum(counts, 0) - counts
    busiest = torch.sort(-counts, stable=True)[1]
    rendered = busiest[:max_tiles] if max_tiles else busiest
    acc = torch.zeros((num_tiles, TILE * TILE, ch), device=dev)
    trans = torch.ones((num_tiles, TILE * TILE), device=dev)
    pix = torch.arange(TILE * TILE, device=dev)
    lx, ly = (pix % TILE).float(), (pix // TILE).float()
    walked = live = 0
    todo = rendered[counts[rendered] > 0]
    for b0 in range(0, todo.numel(), tile_batch):
        tiles = todo[b0:b0 + tile_batch]
        s, cnt = starts[tiles], counts[tiles]
        px = ((tiles % grid_x) * TILE).float()[:, None] + lx  # (B, P)
        py = ((tiles // grid_x) * TILE).float()[:, None] + ly
        T = torch.ones_like(px)
        done = torch.zeros_like(px, dtype=torch.bool)
        out = torch.zeros((tiles.numel(), TILE * TILE, ch), device=dev)
        for k0 in range(0, int(cnt.max()), chunk):
            j = k0 + torch.arange(chunk, device=dev)
            inr = j[None] < cnt[:, None]  # (B, K)
            idx = torch.where(inr, s[:, None] + j[None], 0)
            r = rows[idx]  # (B, K, 6)
            dx = r[..., 0, None] - px[:, None]  # (B, K, P)
            dy = r[..., 1, None] - py[:, None]
            power = (-0.5 * (r[..., 2, None] * dx * dx
                             + r[..., 4, None] * dy * dy)
                     - r[..., 3, None] * dx * dy)
            alpha = torch.clamp(r[..., 5, None] * torch.exp(power), max=0.99)
            use = (power <= 0) & (alpha >= 1.0 / 255.0) & inr[..., None]
            alpha = torch.where(use, alpha, 0.0)
            after = torch.cumprod(torch.cat([T[:, None], 1 - alpha], 1), 1)
            before, after = after[:, :-1], after[:, 1:]
            stop = after < 1e-4  # from the stopping entry on
            go = ~done[:, None] & ~stop
            wgt = torch.where(go, alpha * before, 0.0)
            out += torch.bmm(wgt.transpose(1, 2), feats[idx])
            first_stop = stop & ~torch.cat(
                [torch.zeros_like(stop[:, :1]), stop[:, :-1]], 1)
            walked += int(((go | (first_stop & ~done[:, None]))
                           & inr[..., None]).sum())
            live += int((go & use).sum())
            T = torch.where(go, after, T[:, None]).amin(1)
            done = done | stop[:, -1]
            if bool(done.all()):
                break
        acc[tiles] = out
        trans[tiles] = T
    img = acc + trans[..., None] * bg
    gy = num_tiles // grid_x
    img = img.reshape(gy, grid_x, TILE, TILE, ch).permute(4, 0, 2, 1, 3)
    return (img.reshape(ch, gy * TILE, grid_x * TILE), walked, live,
            int(rendered.numel()))


def render_view(splats: dict, pose, fov_deg: float, height: int,
                width: int, raster: dict, bg3: torch.Tensor,
                with_normal: bool):
    """One view at (height, width) inside, downscaled 2x2: ((C, H / 2,
    W / 2) image, work dict)."""
    scr = project(splats, pose, fov_deg, height, width,
                  raster.get("opacity_radius", False))
    grid_x, grid_y = -(-width // TILE), -(-height // TILE)
    gidx, tile, dropped = binned(scr, raster["dup_cap"],
                                 raster.get("k_budget"), raster["chunk"],
                                 grid_x)
    feats = features(splats, scr["campos"], with_normal)
    rows = torch.cat([scr["mean2d"], scr["conic"],
                      splats["opacity"][:, None]], 1)[gidx]
    bg = bg3.repeat(feats.shape[1] // 3)
    img, walked, live, tiles = blend(
        rows, feats[gidx], tile, grid_x * grid_y, grid_x, bg,
        raster.get("max_active"))
    img = img[:, :height, :width]
    img = img.reshape(img.shape[0], height // 2, 2, width // 2, 2).mean((2, 4))
    work = {"entries": int(tile.numel()), "channels": int(feats.shape[1]),
            "walked": walked, "live": live, "tiles": tiles,
            "dropped": dropped}
    return img, work
