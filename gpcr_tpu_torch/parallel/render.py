"""Multi-GPU rendering: views or tile windows over the ranks of a mesh
axis (port of ``gpcr_tpu/parallel/render.py``).

A frame too large or too slow for one card is split in tile space: every
rank holds the (small) per-gaussian arrays, preprocesses them all, bins
and blends one contiguous window of the tile grid through the serving
kernel (``ops/rasterize_stream.py::blend_stream`` with a window, whose
kernel takes the window's base tile), and the image is assembled from one ``all_gather``
of the windows' (acc, T) blocks. Views split over the ranks need no
collective until the finished images are gathered.
"""

from __future__ import annotations

import torch

from ..ops import rasterize as R
from ..ops import rasterize_stream as RS
from ..render import renderer as RR
from .sharding import Mesh


def window_of(num_tiles: int, n: int, d: int):
    """(base, count) of window ``d`` of an ``n``-way split of ``num_tiles``
    tiles: ceil(num_tiles / n) tiles each, trailing windows running past
    the end of the grid (their tiles have no entries)."""
    per = -(-num_tiles // n)
    return d * per, per


def rasterize_tile_sharded(
    means3d,
    opacities,
    settings: R.GaussianRasterizationSettings,
    mesh: Mesh,
    axis: str = "sp",
    scales=None,
    rotations=None,
    cov3d_precomp=None,
    shs=None,
    colors_precomp=None,
    valid_mask=None,
    config: R.RasterizeConfig = R.RasterizeConfig(),
):
    """One frame with its tile grid split over ``axis``: returns (color
    (C, H, W), radii (N,) i32, T image (H, W), overflow () i64) on every
    rank of the axis (H, W halved with ``config.downscale`` 2).

    Preprocess runs on every rank (elementwise over the gaussians); rank
    ``d`` bins and blends window ``d`` (``window_of``); one ``all_gather``
    per output brings the (acc, T) blocks together, the background is
    composited and the padded tiles are dropped. The overflow is the MAX
    of the windows' overflows: exact for the dup cap (the whole frame's,
    the same on every rank), conservative for a per-window ``k_budget`` or
    ``max_active_tiles``, as in ``gpcr_tpu``."""
    H, W = settings.image_height, settings.image_width
    grid_x = -(-W // config.tile_x)
    grid_y = -(-H // config.tile_y)
    num_tiles = grid_x * grid_y
    ds = config.downscale
    if ds > 1 and (H % ds or W % ds or config.tile_x % ds
                   or config.tile_y % ds):
        raise ValueError("downscale requires even H/W/tile dims")
    base, count = window_of(num_tiles, mesh.shape[axis], mesh.coords[axis])

    prep = R.preprocess(
        means3d, opacities, settings, config,
        scales=scales, rotations=rotations, cov3d_precomp=cov3d_precomp,
        shs=shs, colors_precomp=colors_precomp, valid_mask=valid_mask,
    )
    channels = prep.features.shape[-1]
    acc, t_run, overflow = RS.blend_stream(prep, None, num_tiles, grid_x,
                                           config, channels, base, count)
    acc = mesh.all_gather(acc, axis)[:num_tiles]
    t_run = mesh.all_gather(t_run, axis)[:num_tiles]
    overflow = mesh.all_reduce(overflow, "max", (axis,))
    out = acc + t_run[..., None] * settings.bg.to(acc.dtype)[None, None, :]
    acfg = config._replace(tile_x=config.tile_x // ds,
                           tile_y=config.tile_y // ds)
    color, t_img = RS.assemble_tiles(out, t_run, H // ds, W // ds, acfg)
    R.check_debug(settings, prep, color)
    return color, prep.radius.to(torch.int32), t_img, overflow


def render_views_sharded(
    mesh: Mesh,
    mode: str,  # 'views' | 'tiles'
    view_ts, full_ts, camposes,  # (q, 4, 4), (q, 4, 4), (q, 3)
    means3d, scales, rotations, opacity, shs, normal, valid,
    bg3, tanfov,
    height: int, width: int, out_h: int, out_w: int, sh_degree: int,
    config: R.RasterizeConfig, with_normal: bool,
    axis: str = "sp",
) -> dict:
    """Multi-GPU ``render.renderer.render_views_fused``, the entry that the
    benchmark CLI's ``--shard views|tiles`` reaches; the same dict on
    every rank of ``axis``.

    - ``'views'``: rank d renders views [d q', (d + 1) q') of the q views
      padded to q' n by repeating the last one, through
      ``render_views_fused``; one ``all_gather`` per output, cut back to q.
    - ``'tiles'``: every view is rendered by all ranks together
      (``rasterize_tile_sharded``) at (height, width), then resized to
      (out_h, out_w), as ``gpcr_tpu`` does (no downscale fold).
    """
    RR.pin_fp32()
    n = mesh.shape[axis]
    if mode == "views":
        q = view_ts.shape[0]
        per = -(-q // n)
        idx = torch.clamp(torch.arange(per * mesh.coords[axis],
                                       per * (mesh.coords[axis] + 1)),
                          max=q - 1).to(view_ts.device)
        local = RR.render_views_fused(
            view_ts[idx], full_ts[idx], camposes[idx], means3d, scales,
            rotations, opacity, shs, normal, valid, bg3, tanfov,
            height=height, width=width, out_h=out_h, out_w=out_w,
            sh_degree=sh_degree, config=config, with_normal=with_normal)
        return {k: (mesh.all_gather(v, axis)[:q] if v is not None else None)
                for k, v in local.items()}
    if mode != "tiles":
        raise ValueError(f"unknown shard mode {mode!r}")

    colors, overflows = [], []
    for vt, ft, cp in zip(view_ts, full_ts, camposes):
        features, bg = RR.fuse_view_features(
            cp, means3d, shs, normal, bg3, sh_degree, with_normal)
        settings = R.GaussianRasterizationSettings(
            image_height=height, image_width=width, tanfovx=tanfov,
            tanfovy=tanfov, bg=bg, scale_modifier=1.0, viewmatrix=vt,
            projmatrix=ft, sh_degree=sh_degree, campos=cp,
        )
        color, _radii, _t, ovf = rasterize_tile_sharded(
            means3d, opacity, settings, mesh, axis=axis, scales=scales,
            rotations=rotations, colors_precomp=features, valid_mask=valid,
            config=config,
        )
        colors.append(color)
        overflows.append(ovf)
    colors = RR.bilinear_resize(torch.stack(colors), out_h, out_w)
    return {
        "rgb": colors[:, 0:3].permute(0, 2, 3, 1),
        "xyz_w": colors[:, 3:6].permute(0, 2, 3, 1),
        "hitmap": colors[:, 6:9].permute(0, 2, 3, 1),
        "normal": (colors[:, 9:12].permute(0, 2, 3, 1) if with_normal
                   else None),
        "dup_overflow": torch.stack(overflows),
    }
