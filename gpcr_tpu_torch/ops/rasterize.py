"""Tile-based Gaussian rasterizer: config, preprocessing, the frame
skeleton every route shares and the public dispatcher (port of
``gpcr_tpu/ops/rasterize.py``).

A frame is ``rasterize_frame``: preprocess, then ``rasterize_prepared``: a
route's tile core (bin + blend + background of every tile) and tile
assembly. The renderer preprocesses its views with
``ops/preprocess.py::preprocess_view`` (the fused feature row, on one CUDA
kernel) and calls ``rasterize_prepared`` itself. The cores:

- serving: ``rasterize_stream.STREAM`` (``blend_stream``; the blend
  launches the hand-written CUDA kernel for CUDA tensors and runs its
  plain PyTorch version for CPU tensors);
- differentiable: ``rasterize_stream_vjp.DIFF`` (the same binning inside
  a ``torch.autograd.Function`` whose backward is the replay kernel);
- aligned all-tiles blend: ``rasterize_aligned.ALIGNED``;
- tile-sharded: ``parallel.render.tile_sharded_core``.

``rasterize_gaussians`` takes the serving core, or with
``config.differentiable`` the differentiable one. There is no separate
XLA-style blend and no silent switch of device: the tensors' device
decides, and a CUDA run that cannot launch a kernel raises.
"""

from __future__ import annotations

import typing as T

import torch

from ..utils import sh as sh_utils
from ..utils import trace
from . import splat


class RasterizeConfig(T.NamedTuple):
    """Rasterizer configuration; field names and defaults mirror
    ``gpcr_tpu.ops.rasterize.RasterizeConfig``, whose fields for the TPU's
    scan-based backward, grid steps and bf16 contraction the port does
    not have (ROADMAP "Not queued").

    ``tile_x``/``tile_y``: the CUDA kernels take 16x16 tiles only;
    ``chunk_size``: stream rows staged per step; ``tile_batch``: tiles per
    step of the plain blend, which bounds its memory; ``differentiable``:
    route to the differentiable core (gradients through the replay
    backward, native resolution).
    """

    tile_x: int = 16
    tile_y: int = 16
    max_dup_per_gaussian: int = 32
    chunk_size: int = 128
    tile_batch: int = 256
    differentiable: bool = False
    # cap on sorted entries: None, -1 or 0 = no cap (every emitted entry
    # is kept, the exact budget); a positive value keeps the first
    # k_budget sorted entries (rounded up to chunk_size) and counts the
    # rest as overflow
    k_budget: T.Optional[int] = None
    # render only the max_active_tiles tiles with the most entries; the
    # entries of the rest count as overflow
    max_active_tiles: T.Optional[int] = None
    # 2 folds the x2-supersampling 2x2-mean downscale into the blend's
    # tile write (renders H x W, emits H/2 x W/2)
    downscale: int = 1
    # opacity-aware tile rects (exact: see splat.conic_and_radius)
    opacity_radius: bool = False


class GaussianRasterizationSettings(T.NamedTuple):
    """Mirror of the reference settings tuple."""

    image_height: int
    image_width: int
    tanfovx: float
    tanfovy: float
    bg: torch.Tensor  # (C,)
    scale_modifier: float
    viewmatrix: torch.Tensor  # (4, 4) transposed w2c
    projmatrix: torch.Tensor  # (4, 4) transposed full view·proj
    sh_degree: int
    campos: torch.Tensor  # (3,)
    prefiltered: bool = False
    debug: bool = False  # raise on NaN / Inf (check_debug)


class Preprocessed(T.NamedTuple):
    valid: torch.Tensor  # (N,) bool
    depth: torch.Tensor  # (N,)
    mean2d: torch.Tensor  # (N, 2) pixel coords
    conic: torch.Tensor  # (N, 3)
    radius: torch.Tensor  # (N,)
    rect: torch.Tensor  # (N, 4) int32: min_x, min_y, max_x, max_y (tiles)
    features: torch.Tensor  # (N, C)
    opacity: torch.Tensor  # (N,)


def preprocess(
    means3d: torch.Tensor,
    opacities: torch.Tensor,
    settings: GaussianRasterizationSettings,
    config: RasterizeConfig,
    scales: T.Optional[torch.Tensor] = None,
    rotations: T.Optional[torch.Tensor] = None,
    cov3d_precomp: T.Optional[torch.Tensor] = None,
    shs: T.Optional[torch.Tensor] = None,
    colors_precomp: T.Optional[torch.Tensor] = None,
    valid_mask: T.Optional[torch.Tensor] = None,
) -> Preprocessed:
    """Per-Gaussian preprocessing (forward.cu:157-259)."""
    H, W = settings.image_height, settings.image_width
    focal_y = H / (2.0 * settings.tanfovy)
    focal_x = W / (2.0 * settings.tanfovx)
    grid_x = -(-W // config.tile_x)
    grid_y = -(-H // config.tile_y)

    p_view, vis = splat.in_frustum(means3d, settings.viewmatrix)
    p_proj = splat.project_points(means3d, settings.projmatrix)

    if cov3d_precomp is None:
        cov3d = splat.compute_cov3d(scales, settings.scale_modifier, rotations)
    else:
        cov3d = cov3d_precomp
    cov2d = splat.compute_cov2d(
        means3d, focal_x, focal_y, settings.tanfovx, settings.tanfovy,
        cov3d, settings.viewmatrix,
    )
    if config.opacity_radius:
        conic, radius, det_ok, r_bin = splat.conic_and_radius(
            cov2d, opacity=opacities.reshape(-1))
    else:
        conic, radius, det_ok = splat.conic_and_radius(cov2d)
        r_bin = radius
    mean2d = torch.stack(
        [splat.ndc2pix(p_proj[..., 0], W), splat.ndc2pix(p_proj[..., 1], H)],
        dim=-1,
    )
    rmin_x, rmin_y, rmax_x, rmax_y = splat.get_rect(
        mean2d, r_bin, grid_x, grid_y, config.tile_x, config.tile_y)
    tiles_touched = (rmax_x - rmin_x) * (rmax_y - rmin_y)

    valid = vis & det_ok & (tiles_touched > 0)
    if valid_mask is not None:
        valid = valid & valid_mask.bool()
    valid_report = valid
    if config.opacity_radius:
        # r_bin == 0 <=> op <= 1/255: culled from binning only; the radii
        # keep reference semantics (3-sigma rect tiles_touched)
        valid = valid & (r_bin > 0)
        rx0, ry0, rx1, ry1 = splat.get_rect(
            mean2d, radius, grid_x, grid_y, config.tile_x, config.tile_y)
        valid_report = vis & det_ok & ((rx1 - rx0) * (ry1 - ry0) > 0)
        if valid_mask is not None:
            valid_report = valid_report & valid_mask.bool()

    if colors_precomp is None:
        features = sh_utils.eval_sh_color(
            settings.sh_degree, shs, means3d, settings.campos)
    else:
        features = colors_precomp

    return Preprocessed(
        valid=valid,
        depth=p_view[..., 2],
        mean2d=mean2d,
        conic=conic,
        radius=torch.where(valid_report, radius, torch.zeros_like(radius)),
        rect=torch.stack([rmin_x, rmin_y, rmax_x, rmax_y], dim=-1),
        features=features,
        opacity=opacities.reshape(-1),
    )


def entry_count(prep: Preprocessed, config: RasterizeConfig) -> torch.Tensor:
    """Exact number of (splat, tile) entries the binning emits for this
    view (same cap-clamped rects and validity)."""
    rect = prep.rect.long()
    area_raw = (rect[:, 2] - rect[:, 0]) * (rect[:, 3] - rect[:, 1])
    area = torch.clamp(area_raw, max=config.max_dup_per_gaussian)
    return torch.sum(torch.where(prep.valid, area, torch.zeros_like(area)))


def emit_tiles(rect, valid, cap: int, grid_x: int):
    """Duplicate each valid gaussian over the first min(area, cap) tiles of
    its rect, row-major (duplicateWithKeys, rasterizer_impl.cu:70-111).

    ``rect`` (n, 4) and ``valid`` (n,) come in the order the caller wants
    the entries emitted in (gaussian-major). Returns (gaussian (E,) i64:
    the row of ``rect`` each entry came from, tile (E,) i64, overflow ()
    i64: the tiles beyond ``cap``, never emitted). Only live entries are
    emitted: dynamic shapes need no sentinel padding.
    """
    n = rect.shape[0]
    dev = rect.device
    rminx, rminy, rmaxx, rmaxy = rect.long().unbind(-1)
    rw = torch.clamp(rmaxx - rminx, min=1)
    area_raw = (rmaxx - rminx) * (rmaxy - rminy)
    zero = torch.zeros_like(area_raw)
    area = torch.where(valid, torch.clamp(area_raw, max=cap), zero)
    overflow = torch.sum(
        torch.where(valid, torch.clamp(area_raw - cap, min=0), zero))
    total = int(area.sum())
    gaussian = torch.repeat_interleave(
        torch.arange(n, device=dev), area, output_size=total)
    first = torch.cumsum(area, 0) - area
    k = torch.arange(total, device=dev) - first[gaussian]
    rw_e = rw[gaussian]
    tile = (rminy[gaussian] + k // rw_e) * grid_x + rminx[gaussian] + k % rw_e
    return gaussian, tile, overflow


def tile_bin(prep: Preprocessed, num_tiles: int, grid_x: int,
             config: RasterizeConfig):
    """Duplicate each gaussian into its tile rect and sort the entries by
    (tile, depth) (port of ``gpcr_tpu/ops/rasterize.py::tile_bin``,
    :232-328, without ``tile_window``).

    The sort is stable as ``lax.sort(num_keys=2)`` is: entries of one tile
    with equal depths keep emit order (gaussian-major). A tile holds a
    gaussian at most once, so the rank of a gaussian in a stable sort of
    the depths stands for (depth, emit order), and one sort of the unique
    int64 key tile * (n + 1) + rank gives that order.

    A positive ``config.k_budget`` keeps the first ``k_budget`` entries in
    EMIT order, before the sort, and counts the rest as overflow (the
    stream path's ``bin_sorted_stream`` cuts the SORTED list instead).

    Returns (sorted_gidx (E,) i64 gaussian index per sorted entry, starts
    (num_tiles + 1,) i32, overflow () i64). The JAX function pads
    ``sorted_gidx`` to a static size with sentinels; here E is the number
    of kept entries.
    """
    n = prep.depth.shape[0]
    dev = prep.depth.device
    gaussian, tile, overflow = emit_tiles(
        prep.rect, prep.valid, config.max_dup_per_gaussian, grid_x)
    kb = config.k_budget
    if kb is not None and kb > 0:
        overflow = overflow + max(gaussian.numel() - kb, 0)
        gaussian, tile = gaussian[:kb], tile[:kb]
    _, by_depth = torch.sort(prep.depth, stable=True)
    rank = torch.empty_like(by_depth)
    rank[by_depth] = torch.arange(n, device=dev)
    key_s, _ = torch.sort(tile * (n + 1) + rank[gaussian])
    sorted_tile = key_s // (n + 1)
    sorted_gidx = by_depth[key_s - sorted_tile * (n + 1)]
    starts = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, device=dev),
        side="left").to(torch.int32)
    return sorted_gidx, starts, overflow


def check_debug(settings: GaussianRasterizationSettings, prep: Preprocessed,
                color) -> None:
    """With ``settings.debug``, raise FloatingPointError when the splats'
    2D means or conics, or the image, hold a NaN or Inf (a host read of
    each: the call waits for the device). Every route runs it."""
    if settings.debug:
        from ..utils.debug import check_finite

        check_finite((prep.mean2d, prep.conic, color), name="rasterize")


class TileCore(T.NamedTuple):
    """A route's middle of the frame: ``blend(prep, bg, num_tiles,
    grid_x, config, channels)`` bins and blends every tile and composites
    ``bg`` (C,): (out (num_tiles, P, C), final_T (num_tiles, P), overflow
    () i64). A ``native`` core renders at the settings' resolution
    whatever ``config.downscale`` says."""

    blend: T.Callable
    native: bool = False


def assemble_tiles(out, t_run, H, W, config: RasterizeConfig):
    """(num_tiles, P, C) -> (C, H, W), (H, W)."""
    grid_x = -(-W // config.tile_x)
    grid_y = -(-H // config.tile_y)
    channels = out.shape[-1]
    img = out.reshape(grid_y, grid_x, config.tile_y, config.tile_x, channels)
    img = img.permute(4, 0, 2, 1, 3).reshape(
        channels, grid_y * config.tile_y, grid_x * config.tile_x
    )[:, :H, :W]
    t = t_run.reshape(grid_y, grid_x, config.tile_y, config.tile_x)
    t = t.permute(0, 2, 1, 3).reshape(
        grid_y * config.tile_y, grid_x * config.tile_x
    )[:H, :W]
    return img, t


def rasterize_frame(
    core: TileCore,
    means3d,
    opacities,
    settings: GaussianRasterizationSettings,
    scales=None,
    rotations=None,
    cov3d_precomp=None,
    shs=None,
    colors_precomp=None,
    valid_mask=None,
    config: RasterizeConfig = RasterizeConfig(),
    return_extra: bool = False,
):
    """One frame through ``core``: (color (C, H, W), radii (N,) i32), plus
    {"final_T", "dup_overflow"} with ``return_extra``.
    ``config.downscale == 2`` returns H/2 x W/2 unless the core is native.

    Exactly one of (shs, colors_precomp) and one of (scales+rotations,
    cov3d_precomp) must be given.
    """
    if (shs is None) == (colors_precomp is None):
        raise ValueError(
            "Please provide exactly one of either SHs or precomputed colors!")
    if (scales is None or rotations is None) == (cov3d_precomp is None):
        raise ValueError(
            "Please provide exactly one of either scale/rotation pair or "
            "precomputed 3D covariance!")
    with trace.span("gpcr.raster.preprocess"):
        prep = preprocess(
            means3d, opacities, settings, config,
            scales=scales, rotations=rotations, cov3d_precomp=cov3d_precomp,
            shs=shs, colors_precomp=colors_precomp, valid_mask=valid_mask,
        )
    return rasterize_prepared(core, prep, settings, config, return_extra)


def rasterize_prepared(core: TileCore, prep: Preprocessed,
                       settings: GaussianRasterizationSettings,
                       config: RasterizeConfig = RasterizeConfig(),
                       return_extra: bool = False):
    """The frame after its preprocess (``rasterize_frame``'s tail, and
    the renderer's after ``ops/preprocess.py::preprocess_view``): the
    tiles through ``core``, then tile assembly; returns as
    ``rasterize_frame``."""
    H, W = settings.image_height, settings.image_width
    if core.native:
        config = config._replace(downscale=1)
    ds = config.downscale
    if ds > 1 and (H % ds or W % ds or config.tile_x % ds
                   or config.tile_y % ds):
        raise ValueError("downscale requires even H/W/tile dims")
    grid_x = -(-W // config.tile_x)
    num_tiles = grid_x * -(-H // config.tile_y)
    out, t_run, overflow = core.blend(prep, settings.bg, num_tiles, grid_x,
                                      config, prep.features.shape[-1])
    with trace.span("gpcr.raster.epilogue"):
        color, t_img = assemble_tiles(
            out, t_run, H // ds, W // ds,
            config._replace(tile_x=config.tile_x // ds,
                            tile_y=config.tile_y // ds))
    check_debug(settings, prep, color)
    radii = prep.radius.to(torch.int32)
    if return_extra:
        return color, radii, {"final_T": t_img, "dup_overflow": overflow}
    return color, radii


def route_core(config: RasterizeConfig) -> TileCore:
    """The core ``rasterize_gaussians`` takes for ``config``: the
    differentiable one with ``config.differentiable``, else the serving
    stream core."""
    if config.differentiable:
        from .rasterize_stream_vjp import DIFF

        return DIFF
    from .rasterize_stream import STREAM

    return STREAM


def rasterize_gaussians(
    means3d,
    opacities,
    settings: GaussianRasterizationSettings,
    scales=None,
    rotations=None,
    cov3d_precomp=None,
    shs=None,
    colors_precomp=None,
    valid_mask=None,
    config: RasterizeConfig = RasterizeConfig(),
    return_extra: bool = False,
):
    """``rasterize_frame`` through the core ``route_core`` picks."""
    return rasterize_frame(
        route_core(config), means3d, opacities, settings, scales, rotations,
        cov3d_precomp, shs, colors_precomp, valid_mask, config, return_extra)


def mark_visible(means3d, viewmatrix, projmatrix):
    """Frustum visibility query."""
    _, vis = splat.in_frustum(means3d, viewmatrix)
    return vis


class GaussianRasterizer:
    """API-parity wrapper over ``rasterize_gaussians``; ``means2D`` is
    accepted and ignored."""

    def __init__(self, raster_settings: GaussianRasterizationSettings,
                 config: RasterizeConfig = RasterizeConfig()):
        self.raster_settings = raster_settings
        self.config = config

    def markVisible(self, positions):
        s = self.raster_settings
        return mark_visible(positions, s.viewmatrix, s.projmatrix)

    def __call__(
        self, means3D, means2D=None, opacities=None, shs=None,
        colors_precomp=None, scales=None, rotations=None, cov3D_precomp=None,
        valid_mask=None,
    ):
        return rasterize_gaussians(
            means3D, opacities, self.raster_settings,
            scales=scales, rotations=rotations, cov3d_precomp=cov3D_precomp,
            shs=shs, colors_precomp=colors_precomp, valid_mask=valid_mask,
            config=self.config,
        )

    forward = __call__
