"""The stream-blend kernels' inputs at their main-path shapes, each built
from a seed, and the per-tile work they give the kernels:

- learned view 0: a cloud through ``PCEncoder`` with the ``pcrender``
  CLI's first camera (512² x2), dup cap 256, chunk 256, downscale 2: the
  serving blend (``learned_splats``, ``view0_stream``);
- training view 0: a trainer's network on the first example of the
  ``train`` CLI's loader: the contributor-count forward and the replay
  backward (``train_view0``);
- analytic: isotropic gaussians on a stretched sphere at 1024², C = 3,
  dup cap 8, chunk 128 (``analytic_scene``, ``analytic_view0``);
- aligned view 0: the learned view 0's entries in the chunk-aligned
  layout of the aligned all-tiles blend (``aligned_view0``);
- benchmark view 0: view 0 of a ``scripts/bench_matrix`` scene (the
  headline, c1 / c3a / c4 / c5) as the binning (``bench_view0_prep``) and
  the serving blend (``bench_view0_stream``) get it.

``chip_smoke.py`` and ``cli/profile_blend.py`` build their shapes here.
"""

from __future__ import annotations

import torch

from ..ops import preprocess as P
from ..ops import rasterize as R
from ..ops import rasterize_stream as RS
from ..render import renderer as RD
from ..structures.pointcloud import PointCloud


def bin_view(prep, res: int, config: R.RasterizeConfig):
    """Bin one view's preprocessed splats; tiles in descending entry
    count, as ``render_order`` gives them: (stream, starts, order,
    num_tiles, grid_x)."""
    grid_x = -(-res // 16)
    num_tiles = grid_x * grid_x
    stream, starts, _ = RS.bin_sorted_stream(prep, num_tiles, grid_x, config)
    counts = starts[1:] - starts[:-1]
    order = torch.argsort(-counts, stable=True).to(torch.int32)
    return stream, starts, order, num_tiles, grid_x


def learned_splats(rdr: RD.PCMLRender, pcd: PointCloud, dup_cap: int = 256):
    """The learned cell's splats and raster parameters as the ``pcrender``
    CLI builds them (its first camera ring, 512² x2, dup cap ``dup_cap``,
    no k_budget): a dict of ``render_views_fused``'s arguments plus
    ``config``."""
    from ..cli import benchmark as B

    args = B.build_parser().parse_args(
        ["pcrender", "--skip_mesh", "--voxelized", "--dup_cap", str(dup_cap)])
    dev = rdr.device
    with torch.no_grad():
        sp, _, _ = rdr.encode(pcd)
        cam, _ = B._camera_for(args, "pcrender", dev)
        bg3 = torch.ones(3, device=dev)
        rp = RD.get_rasterize_param_from_camera(cam, 45, bg=bg3, sh_degree=1)
    s = RD.world_splats(sp, 512, 448)
    return dict(
        rp=rp, config=B._raster_config(args)._replace(k_budget=None),
        bg3=bg3, means=s.means, scales=s.scales, rotation=s.rotations,
        opacity=s.opacity, sh=s.shs, normal=s.normal, valid=s.valid)


def view0_prep(sp: dict):
    """View 0 of ``learned_splats``' cameras, preprocessed (what both
    binnings take): (prep, channels, raster size)."""
    rp = sp["rp"]
    with torch.no_grad():
        feats = P.fuse_view_features(rp["campos"][0], sp["means"], sp["sh"],
                                     sp["normal"], 1, True)
        bg = P.view_background(sp["bg3"], True)
        settings = R.GaussianRasterizationSettings(
            rp["height"], rp["width"], rp["tanfov"], rp["tanfov"], bg, 1.0,
            rp["view_t"][0], rp["full_t"][0], 1, rp["campos"][0])
        prep = R.preprocess(sp["means"], sp["opacity"], settings, sp["config"],
                            scales=sp["scales"], rotations=sp["rotation"],
                            colors_precomp=feats)
    return prep, feats.shape[1], rp["height"]


def view0_stream(sp: dict):
    """The serving blend's inputs at view 0 (downscale 2, as the renderer
    sets it): (stream, starts, order, num_tiles, grid_x, channels,
    config)."""
    config = sp["config"]._replace(downscale=2)
    prep, channels, res = view0_prep(sp)
    with torch.no_grad():
        return (*bin_view(prep, res, config), channels, config)


def aligned_view0(sp: dict):
    """The aligned blend's inputs at view 0 (``tile_bin_aligned`` of the
    same preprocessed splats, chunk 256, all tiles): (chunk_starts, scal,
    feat, num_tiles, grid_x, channels, config)."""
    from ..ops import rasterize_aligned as RA

    config = sp["config"]
    prep, channels, res = view0_prep(sp)
    grid_x = -(-res // 16)
    num_tiles = grid_x * grid_x
    with torch.no_grad():
        scal, feat, cstarts, _ = RA.tile_bin_aligned(prep, num_tiles, grid_x,
                                                     config)
    return cstarts, scal, feat, num_tiles, grid_x, channels, config


def train_view0(trainer, n_points: int, hw: int, scale_factor: int = 448):
    """The training kernels' inputs at view 0 of the first example of the
    ``train`` CLI's loader (seed 0; the synthetic scenes quantized at
    ``scale_factor``), through ``trainer``'s network and raster config:
    (stream, starts, order, num_tiles, grid_x, channels, config,
    splats)."""
    from ..train.data import DataLoader

    dev = trainer.device
    batch = DataLoader(batch_size=1, n_points=n_points, n_views=2, hw=hw,
                       scale_factor=scale_factor, seed=0,
                       device=dev).next_batch()
    # tile_batch only sizes the plain versions' steps
    config = trainer.config._replace(downscale=1, tile_batch=256)
    with torch.no_grad():
        (means, scales, rotation, opacity, sh, normal, valid,
         with_normal) = trainer._encode_splats(
             batch["coords"][0], batch["rgb"][0], batch["valid"][0])
        campos = batch["campos"][0, 0]
        feats = P.fuse_view_features(campos, means, sh, normal,
                                     trainer.info.sh_deg, with_normal)
        bg = P.view_background(torch.zeros(3, device=dev), with_normal)
        settings = R.GaussianRasterizationSettings(
            hw, hw, batch["tanfov"], batch["tanfov"], bg, 1.0,
            batch["view_t"][0, 0], batch["full_t"][0, 0], trainer.info.sh_deg,
            campos)
        prep = R.preprocess(means, opacity, settings, config, scales=scales,
                            rotations=rotation, colors_precomp=feats,
                            valid_mask=valid)
        return (*bin_view(prep, hw, config), feats.shape[1], config,
                int(means.shape[0]))


def analytic_scene(n: int, device, res: int = 512):
    """``n`` isotropic gaussians (sigma 1 / 448, opacity 0.9, random RGB)
    on the stretched sphere of ``scripts/bench_matrix.make_cloud`` (448
    grid, seed 0), seen by the first of a 2-camera ring at ``res``² x2
    (the scene of ``scripts/bench_train_step.py``), dup cap 8, chunk 128:
    (leaves [means, scales, rotations, opacities, colours], settings,
    config)."""
    from ..scripts.bench_matrix import make_cloud

    sf = 448
    coords, rgb = make_cloud(n, sf)
    cam = RD.generate_cam({"fov": 45.0, "width_px": res, "height_px": res,
                           "mode": "circle", "n_imgs": 2, "d": 0, "r": 3,
                           "center_angles": [90, 0]}, device=device)
    bg = torch.ones(3, device=device)
    rp = RD.get_rasterize_param_from_camera(cam, 45.0, bg=bg, sh_degree=0,
                                            super_sample_rate=2)
    size = rp["height"]
    config = R.RasterizeConfig(max_dup_per_gaussian=8, chunk_size=128,
                               differentiable=True)
    settings = R.GaussianRasterizationSettings(
        size, size, rp["tanfov"], rp["tanfov"], bg, 1.0, rp["view_t"][0],
        rp["full_t"][0], 0, rp["campos"][0])
    leaves = [RD.pcgc_rescale(torch.from_numpy(coords).to(device), 512, sf),
              torch.full((n, 3), 1.0 / sf, device=device),
              torch.tensor([1.0, 0, 0, 0], device=device).repeat(n, 1),
              torch.full((n,), 0.9, device=device),
              torch.from_numpy(rgb).to(device)]
    return leaves, settings, config


def analytic_view0(n: int, device):
    """The training kernels' inputs on ``analytic_scene`` (C = 3)."""
    (m, sc, q, o, f), settings, config = analytic_scene(n, device)
    with torch.no_grad():
        prep = R.preprocess(m, o, settings, config, scales=sc, rotations=q,
                            colors_precomp=f)
        return (*bin_view(prep, settings.image_height, config), 3, config)


def bench_view0_prep(scene: dict, config: R.RasterizeConfig):
    """View 0 of a benchmark scene (``scripts/bench_matrix.make_scene``),
    preprocessed as ``render_views_fused`` preprocesses it: fused features
    without normals, downscale 2 when the output is half the raster size.
    Returns (prep, num_tiles, grid_x, channels, config)."""
    rp = scene["rp"]
    H, W = rp["height"], rp["width"]
    if H == 2 * scene["out_h"] and W == 2 * scene["out_w"]:
        config = config._replace(downscale=2)
    with torch.no_grad():
        feats = P.fuse_view_features(rp["campos"][0], scene["means"],
                                     scene["shs"], scene["normal"], 1, False)
        bg = P.view_background(scene["bg3"], False)
        settings = R.GaussianRasterizationSettings(
            H, W, rp["tanfov"], rp["tanfov"], bg, 1.0, rp["view_t"][0],
            rp["full_t"][0], 1, rp["campos"][0])
        prep = R.preprocess(scene["means"], scene["opacity"], settings, config,
                            scales=scene["scales"],
                            rotations=scene["rotations"],
                            colors_precomp=feats, valid_mask=scene["valid"])
    grid_x = -(-W // config.tile_x)
    num_tiles = grid_x * -(-H // config.tile_y)
    return prep, num_tiles, grid_x, feats.shape[1], config


def bench_view0_stream(scene: dict, config: R.RasterizeConfig):
    """The serving blend's inputs at view 0 of a benchmark scene, built as
    ``render_views_fused`` builds them: ``bench_view0_prep``, the stream
    binning and ``render_order``'s tiles. Returns (stream, starts, order,
    num_tiles, grid_x, channels, config, overflow)."""
    prep, num_tiles, grid_x, channels, config = bench_view0_prep(scene,
                                                                 config)
    with torch.no_grad():
        stream, starts, overflow = RS.bin_sorted_stream(prep, num_tiles,
                                                        grid_x, config)
        order, overflow = RS.render_order(starts, overflow, num_tiles, config)
    return (stream, starts, order, num_tiles, grid_x, channels, config,
            int(overflow))


def distribution(x: torch.Tensor) -> dict:
    """max, p99 and median of ``x``."""
    x = x.double().cpu()
    return {"max": int(x.max()), "p99": float(torch.quantile(x, 0.99)),
            "median": float(torch.quantile(x, 0.5))}


def tile_work(starts, order, n_contrib, chunk: int, forward: bool) -> dict:
    """Over the rendered non-empty tiles: entries per tile, entries the
    tile's CTA walks, and the share of the walked (entry, pixel) slots
    that belong to pixels already stopped (``n_contrib`` is the
    contributor count of the forward at native resolution). The forward's
    CTA walks whole chunks until its last pixel stops (at most the range);
    the backward walks [0, min(range, max n_contrib))."""
    o = order.long()
    cnt = (starts[1:] - starts[:-1])[o].long()
    nc = n_contrib[o].long()
    keep = cnt > 0
    cnt, nc = cnt[keep], nc[keep]
    top = nc.amax(dim=1)
    if forward:
        # the pixel that stops at in-tile index k reads chunk k // chunk
        walked = torch.minimum(cnt, (top // chunk + 1) * chunk)
    else:
        walked = torch.minimum(cnt, top)
    slots = 256 * walked.sum()
    return {"tiles": int(keep.sum()), "entries": distribution(cnt),
            "walked": distribution(walked),
            "stopped_share": float(1 - nc.sum() / max(int(slots), 1))}


def aligned_work(chunk_starts, n_contrib, counts, chunk: int) -> dict:
    """Over the non-empty tiles of a chunk-aligned layout: chunks per tile,
    chunks the tile's CTA walks (until its last pixel stops: the pixel
    that stops at in-tile index k reads chunk k // chunk), the number of
    empty tiles, and the share of the walked (slot, pixel) pairs that
    belong to pixels already stopped. ``n_contrib`` is the contributor
    count of the stream forward over the same entries at native
    resolution and ``counts`` the entries per tile, both in tile order."""
    cs = chunk_starts.long()
    nch = cs[1:] - cs[:-1]
    keep = nch > 0
    nch, nc = nch[keep], n_contrib[keep].long()
    top = nc.amax(dim=1)
    walked = torch.minimum(nch, top // chunk + 1)
    slots = walked * chunk
    # a pixel that never stopped walks every slot its tile's CTA walks
    stopped = nc < counts[keep].long()[:, None]
    own = torch.where(stopped, nc, slots[:, None])
    return {"tiles": int(keep.sum()), "empty_tiles": int((~keep).sum()),
            "chunks": distribution(nch), "walked_chunks": distribution(walked),
            "stopped_share": float(1 - own.sum()
                                   / max(int(256 * slots.sum()), 1))}
