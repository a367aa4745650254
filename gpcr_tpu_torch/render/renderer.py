"""Renderer orchestration (port of ``gpcr_tpu/render/renderer.py``):
``PCMLRender`` (learned splats from the PCEncoder) and ``SimpleRender``
(analytic splats) over one shared request tail (``_render_request``),
the projection / raster-settings builders, ``pcgc_rescale`` and
``world_splats``.

All outputs of a view — rgb, world xyz, hit map and (learned path)
normal — are feature channels of ONE rasterizer pass (written by
``ops/preprocess.py::preprocess_view``, on the card in the preprocess
kernel's launch, read back by ``split_view_channels``), and on
the serving route the x2 supersampling downscale is folded into the
blend kernel's tile write. Views render in one Python loop,
``render_views_fused``, whatever the route: serving, differentiable
(the trainer), aligned (``use_pallas``) or tile-sharded
(``render_views_sharded``).

Parity notes kept from the reference: raster settings use tanfov =
tan(fov), NOT tan(fov/2) (:101-102); the projection matrix uses tan(fov/2)
with znear 0.01 and zfar 100; PCML scales are multiplied by
sqrt(3)/scale_factor*6.
"""

from __future__ import annotations

import functools
import math
import os
import time
import typing as T

import numpy as np
import torch

from ..models.encoder import PCEncoder, PCMLInfo, assemble_input_features
from ..ops import rasterize as R
from ..ops import rasterize_aligned as RA
from ..ops import rasterize_stream as RS
from ..ops import sparse
from ..ops.preprocess import preprocess_view, view_background
from ..parallel.distributed import get_world_size, is_main
from ..parallel.render import tile_sharded_core
from ..parallel.sharding import Mesh, make_mesh
from ..structures.camera import Camera
from ..structures.pointcloud import PointCloud
from ..structures.trajectory import CameraTrajectory
from ..utils import sh as sh_utils
from ..utils import trace
from ..utils.timing import sync


def pin_fp32() -> None:
    """Full-float32 matmuls and convolutions (no TF32) for parity."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------------------
# camera -> raster parameters
# --------------------------------------------------------------------------


def get_projection_matrix(znear, zfar, fovX, fovY, device=None) -> torch.Tensor:
    """OpenGL-style projection; fov in radians."""
    tanHalfY = math.tan(fovY / 2)
    tanHalfX = math.tan(fovX / 2)
    top = tanHalfY * znear
    right = tanHalfX * znear
    P = np.zeros((4, 4), np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return torch.as_tensor(P, device=device)


def get_rasterize_param_from_camera(
    camera: Camera, fov_deg: float, bg=None, sh_degree: int = 0,
    super_sample_rate: int = 2,
) -> dict:
    """Raster settings for ALL views of a (b, q) camera: view_t (bq,4,4),
    full_t (bq,4,4), campos (bq,3), plus scalars."""
    dev = camera.device
    H_w2c = camera.get_H_w2c()  # (b, q, 4, 4)
    b, q = H_w2c.shape[:2]
    view_t = H_w2c.transpose(-1, -2).reshape(b * q, 4, 4)
    fov = np.pi * fov_deg / 180.0
    proj_t = get_projection_matrix(0.01, 100.0, fov, fov, device=dev).T
    full_t = view_t @ proj_t[None]
    campos = camera.H_c2w[..., :3, 3].reshape(b * q, 3)
    if bg is None:
        bg = torch.zeros((3,), dtype=torch.float32, device=dev)
    return {
        "view_t": view_t,
        "full_t": full_t,
        "campos": campos,
        "tanfov": math.tan(fov),  # reference quirk: tan(fov), not tan(fov/2)
        "bg": torch.as_tensor(bg, dtype=torch.float32, device=dev),
        "height": camera.height_px * super_sample_rate,
        "width": camera.width_px * super_sample_rate,
        "sh_degree": sh_degree,
    }


def pcgc_rescale(input_xyz, offset=512, factor=256):
    """(xyz - offset) / factor."""
    return (input_xyz - offset) / factor


def generate_cam(camera_info: dict, return_traj: bool = False, device=None):
    """Camera factory: ``camera_info["mode"]`` is 'circle', 'udlrfb' (which
    takes its radius range from the reference's defaults) or the path of a
    camera file."""
    defaults = {
        "min_r": 3, "max_r": 4, "max_angle": 30.0, "num_circle": 4,
        "r_freq": 1, "max_translate_ratio": 2.0, "local_max_angle": 3.0,
        "rand_r": 0.0,
    }
    traj = CameraTrajectory(
        mode=camera_info["mode"], n_imgs=camera_info["n_imgs"], total=1,
        rng_seed=0,
        params=camera_info if camera_info["mode"] != "udlrfb" else defaults,
        device=device,
    )
    cam = traj.get_camera(fov=camera_info["fov"],
                          width_px=camera_info["width_px"],
                          height_px=camera_info["height_px"])
    return (cam, traj) if return_traj else cam


# --------------------------------------------------------------------------
# image resize (F.interpolate bilinear, align_corners=False)
# --------------------------------------------------------------------------


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(…, H, W) -> (…, out_h, out_w) with F.interpolate bilinear
    (align_corners=False) semantics; an exact 2x downscale is 2x2 means."""
    h, w = img.shape[-2], img.shape[-1]
    if h == out_h and w == out_w:
        return img
    if h == 2 * out_h and w == 2 * out_w:
        x = img.reshape(*img.shape[:-2], out_h, 2, out_w, 2)
        return x.mean(dim=(-3, -1))
    dev = img.device

    def axis_weights(n_in, n_out):
        coords = (torch.arange(n_out, device=dev, dtype=torch.float32)
                  + 0.5) * (n_in / n_out) - 0.5
        lo = torch.clamp(torch.floor(coords), 0, n_in - 1)
        hi = torch.clamp(lo + 1, 0, n_in - 1)
        frac = torch.clamp(coords - lo, 0.0, 1.0)
        return lo.long(), hi.long(), frac

    ylo, yhi, fy = axis_weights(h, out_h)
    xlo, xhi, fx = axis_weights(w, out_w)
    top = img[..., ylo, :]
    bot = img[..., yhi, :]
    rows = top + (bot - top) * fy[:, None]
    left = rows[..., :, xlo]
    right = rows[..., :, xhi]
    return left + (right - left) * fx


# --------------------------------------------------------------------------
# fused multi-channel render core
# --------------------------------------------------------------------------


def split_view_channels(colors: torch.Tensor, with_normal: bool) -> dict:
    """(q, C, h, w) images of ``ops/preprocess.py::fuse_view_features``'
    layout -> {"rgb", "xyz_w", "hitmap", "normal"} of (q, h, w, 3) (normal
    None without ``with_normal``)."""
    out = {k: colors[:, i:i + 3].permute(0, 2, 3, 1)
           for k, i in (("rgb", 0), ("xyz_w", 3), ("hitmap", 6))}
    out["normal"] = (colors[:, 9:12].permute(0, 2, 3, 1) if with_normal
                     else None)
    return out


def render_view(
    view_t, full_t, campos,
    means3d, scales, rotations, opacity, shs, normal, valid,
    bg3, tanfov, height, width, sh_degree, config: R.RasterizeConfig,
    with_normal: bool, core: T.Optional[R.TileCore] = None,
):
    """Render one view with all output channels fused into one pass:
    ``preprocess_view`` (on the card one kernel launch), then
    ``R.rasterize_prepared`` through ``core`` (default ``R.route_core``:
    gradients flow when ``config.differentiable``). Returns (color (C, h,
    w), dup_overflow ())."""
    settings = R.GaussianRasterizationSettings(
        image_height=height, image_width=width, tanfovx=tanfov,
        tanfovy=tanfov, bg=view_background(bg3, with_normal),
        scale_modifier=1.0, viewmatrix=view_t, projmatrix=full_t,
        sh_degree=sh_degree, campos=campos,
    )
    prep = preprocess_view(settings, means3d, scales, rotations, opacity,
                           shs, normal, valid, config, with_normal)
    color, _, extra = R.rasterize_prepared(
        core or R.route_core(config), prep, settings, config,
        return_extra=True)
    return color, extra["dup_overflow"]


def render_views_fused(
    view_ts, full_ts, camposes,  # (q, 4, 4), (q, 4, 4), (q, 3)
    means3d, scales, rotations, opacity, shs, normal, valid,
    bg3, tanfov,
    height: int, width: int, out_h: int, out_w: int, sh_degree: int,
    config: R.RasterizeConfig, with_normal: bool, use_pallas: bool = False,
    core: T.Optional[R.TileCore] = None,
) -> dict:
    """All views of one cloud, one fused rasterizer pass per view
    (``render_view``) through ``core``: by default ``R.route_core``, or
    with ``use_pallas`` (the JAX package's name) the aligned all-tiles
    blend, which reports no dropped entries. Only the serving stream core
    folds the x2-supersampling downscale into its tile write; the other
    cores render at (height, width) and the images are resized after.
    Returns ``split_view_channels``' (q, out_h, out_w, 3) images plus
    per-view ``dup_overflow`` (q,)."""
    pin_fp32()
    if core is None:
        core = RA.ALIGNED if use_pallas else R.route_core(config)
    if (core is RS.STREAM and config.downscale == 1
            and height == 2 * out_h and width == 2 * out_w
            and config.tile_x % 2 == 0 and config.tile_y % 2 == 0):
        config = config._replace(downscale=2)
    colors, overflow = [], []
    for vt, ft, cp in zip(view_ts, full_ts, camposes):
        with trace.span("gpcr.raster.view"):
            color, ovf = render_view(
                vt, ft, cp, means3d, scales, rotations, opacity, shs, normal,
                valid, bg3, tanfov, height, width, sh_degree, config,
                with_normal, core)
        colors.append(color)
        overflow.append(ovf)
    with trace.span("gpcr.raster.resize"):
        colors = bilinear_resize(torch.stack(colors), out_h, out_w)
        # dropped splat-tile entries per view (dup cap / k_budget /
        # max_active_tiles); callers warn after the timed region
        return dict(split_view_channels(colors, with_normal),
                    dup_overflow=torch.stack(overflow))


def render_views_sharded(
    mesh: Mesh,
    mode: str,  # 'views' | 'tiles'
    view_ts, full_ts, camposes, *args, axis: str = "sp", **kw,
) -> dict:
    """Multi-GPU ``render_views_fused`` (same arguments after ``mode``),
    the entry that the benchmark CLI's ``--shard views|tiles`` reaches;
    the same dict on every rank of ``axis``.

    - ``'views'``: rank d renders views [d q', (d + 1) q') of the q views
      padded to q' n by repeating the last one; one ``all_gather`` per
      output, cut back to q.
    - ``'tiles'``: every view is rendered by all ranks together
      (``parallel.render.tile_sharded_core``) at (height, width), then
      resized, as ``gpcr_tpu`` does (no downscale fold).
    """
    if mode == "tiles":
        return render_views_fused(view_ts, full_ts, camposes, *args,
                                  core=tile_sharded_core(mesh, axis), **kw)
    if mode != "views":
        raise ValueError(f"unknown shard mode {mode!r}")
    q = view_ts.shape[0]
    per = -(-q // mesh.shape[axis])
    d = mesh.coords[axis]
    idx = torch.clamp(torch.arange(per * d, per * (d + 1)),
                      max=q - 1).to(view_ts.device)
    local = render_views_fused(view_ts[idx], full_ts[idx], camposes[idx],
                               *args, **kw)
    return {k: (mesh.all_gather(v, axis)[:q] if v is not None else None)
            for k, v in local.items()}


def apply_point_light(ret: dict, point_light: dict) -> torch.Tensor:
    """Lambertian point-light composite."""
    dev = ret["rgb"].device
    lighted = [ret["rgb"] * point_light["light_coeff"][0]]
    for i in range(len(point_light["xyz_w"])):
        pos = torch.as_tensor(np.asarray(point_light["xyz_w"][i]),
                              dtype=torch.float32, device=dev)
        color = torch.as_tensor(np.asarray(point_light["color"][i]),
                                dtype=torch.float32, device=dev)
        light_dir = ret["xyz_w"] - pos
        light_dir = light_dir / torch.linalg.norm(light_dir, dim=-1,
                                                  keepdim=True)
        cos_t = torch.clamp(
            torch.sum(light_dir * ret["normal"], dim=-1, keepdim=True), min=0.0)
        lighted.append(color * cos_t * ret["hitmap"] * ret["rgb"]
                       * point_light["light_coeff"][i + 1])
    return torch.sum(torch.stack(lighted, dim=0), dim=0)


def est_normal_from_ellipsoid(scale, rotation):
    """Normal = rotation of the min-scale axis."""
    from ..ops.splat import quat_to_rotmat

    norm = torch.linalg.norm(rotation, dim=-1, keepdim=True)
    Rm = quat_to_rotmat(rotation / torch.clamp(norm, min=1e-12))
    idx = torch.argmin(scale, dim=-1)
    return torch.gather(Rm, 2, idx[:, None, None].expand(-1, 3, 1))[..., 0]


class Splats(T.NamedTuple):
    """World-space splats in ``render_views_fused``'s argument order;
    ``normal`` is zeros where ``with_normal`` is False."""

    means: torch.Tensor  # (N, 3)
    scales: torch.Tensor  # (N, 3)
    rotations: torch.Tensor  # (N, 4)
    opacity: torch.Tensor  # (N,)
    shs: torch.Tensor  # (N, K, 3)
    normal: torch.Tensor  # (N, 3)
    valid: torch.Tensor  # (N,) bool
    with_normal: bool


def world_splats(sp, offset, scale_factor, use_opacity: bool = True,
                 normal=None) -> Splats:
    """The encoder's ``SplatParams`` (grid units) as world splats: centres
    by ``pcgc_rescale``, scales times sqrt(3) / scale_factor * 6, the
    opacity column (ones without ``use_opacity``), and ``normal``, else
    the network's, else zeros."""
    means = pcgc_rescale(sp.primitives, offset, scale_factor)
    opacity = sp.opacity[:, 0]
    if not use_opacity:
        opacity = torch.ones_like(opacity)
    if normal is None:
        normal = sp.normal
    with_normal = normal is not None
    return Splats(means, sp.scale * float(np.sqrt(3) / scale_factor * 6),
                  sp.rotation, opacity, sp.sh,
                  normal if with_normal else torch.zeros_like(means),
                  sp.valid, with_normal)


def _finish(out: dict, point_light, model_time, rgb_time,
            timing: T.Optional[dict]) -> dict:
    if is_main():  # one timing line per run, from rank 0
        print("model time: %.3f sec, rgb time: %.3f sec"
              % (model_time, rgb_time), flush=True)
    ovf = int(out.pop("dup_overflow").sum())
    trace.count("entries_dropped", ovf)
    if timing is not None:
        timing.update(model_time=model_time, rgb_time=rgb_time,
                      dup_overflow=ovf)
    if ovf and is_main():
        print(f"[Warn] rasterizer dropped {ovf} splat-tile entries "
              f"(raise the dup cap / k_budget)", flush=True)
    ret = {k: (v[None] if v is not None else None) for k, v in out.items()}
    if point_light is not None and ret["normal"] is not None:
        ret["shaded"] = apply_point_light(
            {k: v[0] for k, v in ret.items() if v is not None}, point_light
        )[None]
    return ret


def _views_runner(rdr):
    """What renders a renderer's views: ``render_views_fused``, or with
    ``rdr.shard`` ('views' | 'tiles') ``render_views_sharded`` on
    ``rdr.shard_mesh``, by default all ranks on 'sp' (made at the first
    render, when the process group it lays out exists; without one: one
    rank, one window)."""
    if not rdr.shard:
        return render_views_fused
    if rdr._shard_runner is None:
        if rdr.shard not in ("views", "tiles"):
            raise ValueError(f"unknown shard mode {rdr.shard!r}")
        mesh = rdr.shard_mesh or make_mesh(sp=get_world_size())
        rdr._shard_runner = functools.partial(render_views_sharded, mesh,
                                              rdr.shard)
    return rdr._shard_runner


def _concat_batch(outs: T.List[dict]) -> dict:
    return {k: (torch.cat([o[k] for o in outs], dim=0)
                if outs[0][k] is not None else None) for k in outs[0]}


def _render_request(rdr, pcd: PointCloud, scale, cam: Camera, fov: float,
                    kw: dict, timing: T.Optional[dict], sh_degree: int,
                    splats_of: T.Callable) -> dict:
    """What both renderers' ``render`` share. A batch of clouds renders
    cloud by cloud (``rdr.render`` with the keywords ``kw``, no
    ``timing``) and is concatenated. One cloud is one request:
    ``splats_of(pcd)`` -> (Splats, model time in s), the views
    (``_views_runner``; once before the timed call with
    ``rdr.warm_timing``) timed on the host clock, then ``_finish``."""
    pin_fp32()
    if pcd.batch_size > 1:
        return _concat_batch([
            rdr.render(pcd[ib], scale, cam[ib], fov, **kw)
            for ib in range(pcd.batch_size)
        ])
    with trace.request(pcd.device):
        splats, model_time = splats_of(pcd)
        dev = splats.means.device
        bg3 = torch.zeros((3,), device=dev) + torch.as_tensor(
            np.asarray(kw["background_color"], np.float32), device=dev)
        rp = get_rasterize_param_from_camera(
            cam, fov, bg=bg3, sh_degree=sh_degree,
            super_sample_rate=kw["super_sample_rate"])
        fused = _views_runner(rdr)

        def run():
            return fused(
                rp["view_t"], rp["full_t"], rp["campos"], *splats[:7], bg3,
                rp["tanfov"], height=rp["height"], width=rp["width"],
                out_h=cam.height_px, out_w=cam.width_px, sh_degree=sh_degree,
                config=rdr.config, with_normal=splats.with_normal,
            )

        if rdr.warm_timing:
            sync(run())
        t0 = time.perf_counter()
        out = run()
        sync(out)
        rgb_time = time.perf_counter() - t0
        with trace.span("gpcr.finish"):
            return _finish(out, kw["point_light"], model_time, rgb_time,
                           timing)


# --------------------------------------------------------------------------
# SimpleRender
# --------------------------------------------------------------------------


class SimpleRender:
    """No-network analytic baseline: identity quaternions, isotropic
    σ/scale_factor scales, opacity 1, SH DC = RGB2SH(rgb) with zero AC.
    ``shard`` ('views' | 'tiles') renders over every rank
    (``parallel.render.render_views_sharded``) on ``shard_mesh``."""

    def __init__(self, voxelized=True, scale_factor=None, offset=512,
                 config: R.RasterizeConfig = R.RasterizeConfig(),
                 warm_timing: bool = False, shard: T.Optional[str] = None,
                 shard_mesh=None):
        self.voxelized = voxelized
        self.scale_factor = 1.0 if scale_factor is None else scale_factor
        self.offset = offset
        self.config = config
        # run the rgb pass once before the timed one
        self.warm_timing = warm_timing
        self.shard = shard
        self.shard_mesh = shard_mesh
        self._shard_runner = None

    def render(
        self, pcd: PointCloud, scale, cam: Camera, fov: float,
        enable_opacity: bool = False, super_sample_rate: int = 2,
        input_offset=None, point_light=None, consistent_normal=False,
        est_normal_from_ellipsoid=False, background_color=0.0, sigma=1.0,
        timing: T.Optional[dict] = None,
    ) -> dict:
        sh_deg = 1

        def splats(pcd):
            dev = pcd.device
            if input_offset is None:
                in_off = torch.zeros((1, 3), device=dev)
            else:
                in_off = torch.as_tensor(np.asarray(input_offset, np.float32),
                                         device=dev).reshape(1, 3)
            xyz = pcd.xyz_w[0] + in_off
            rgb = pcd.rgb[0]
            valid = pcd.get_valid_mask()[0, :, 0]
            n = xyz.shape[0]

            t0 = time.perf_counter()
            with trace.span("gpcr.splats"):
                scale_norm = self.scale_factor if self.voxelized else 1.0
                pseudo = (2 ** (sh_deg + 1)) * 3  # 12 zero AC rows
                shs = torch.cat([sh_utils.RGB2SH(rgb)[:, None, :],
                                 torch.zeros((n, pseudo, 3), device=dev)],
                                dim=1)
                means = (pcgc_rescale(xyz, self.offset, self.scale_factor)
                         if self.voxelized else xyz)
                rotations = torch.tensor([1.0, 0.0, 0.0, 0.0],
                                         device=dev).expand(n, 4)
                scales = torch.ones((n, 3), device=dev) * (sigma / scale_norm)
                opacity = torch.ones((n,), device=dev)
                sync(opacity)
            return (Splats(means, scales, rotations, opacity, shs,
                           torch.zeros_like(means), valid, False),
                    time.perf_counter() - t0)

        return _render_request(
            self, pcd, scale, cam, fov,
            dict(enable_opacity=enable_opacity,
                 super_sample_rate=super_sample_rate,
                 input_offset=input_offset, point_light=point_light,
                 background_color=background_color, sigma=sigma),
            timing, sh_deg, splats)


# --------------------------------------------------------------------------
# PCMLRender
# --------------------------------------------------------------------------


def _read_options(option_dir: str) -> dict:
    """A run's options, chosen by file name: ``options.json`` (json) when
    the run has one, else the reference's ``options.yaml`` (PyYAML, which
    such a run then needs, as ``gpcr_tpu`` does)."""
    path = os.path.join(option_dir, "options.json")
    if os.path.exists(path):
        import json

        with open(path) as f:
            return json.load(f)
    import yaml

    with open(os.path.join(option_dir, "options.yaml")) as f:
        return yaml.safe_load(f)


def load_pcml(ckpt: str):
    """Load ``<run>/option/options.{json,yaml}`` + the checkpoint params
    for ``<run>/checkpoint/<file>``. Returns (nested numpy params, info
    dict)."""
    root = os.path.dirname(os.path.dirname(ckpt))
    info = _read_options(os.path.join(root, "option"))["pcml_info"]
    from .checkpoint import load_params

    params = load_params(ckpt, PCMLInfo.from_dict(info))
    print("Loaded weights.")
    return params, info


class PCMLRender:
    """Learned renderer: quantize -> PCEncoder -> fused 4-output raster.

    ``params`` is a JAX-layout nested dict of arrays (what ``load_pcml``
    returns); without ``ckpt`` or ``params`` the encoder keeps its random
    init from ``generator`` (default: ``torch.Generator().manual_seed(0)``).
    ``shard`` / ``shard_mesh`` as in ``SimpleRender``.
    """

    def __init__(
        self, ckpt: T.Optional[str] = None, voxelized: bool = True,
        scale_factor: T.Optional[int] = None, offset: int = 512,
        info: T.Optional[dict] = None, params=None,
        config: R.RasterizeConfig = R.RasterizeConfig(),
        warm_timing: bool = False, device="cuda",
        generator: T.Optional[torch.Generator] = None,
        shard: T.Optional[str] = None, shard_mesh=None,
    ):
        with trace.span("gpcr.init"):
            if ckpt is not None:
                params, info = load_pcml(ckpt)
            elif info is None:
                raise ValueError("PCMLRender needs a ckpt or an info dict")
            self.info = (info if isinstance(info, PCMLInfo)
                         else PCMLInfo.from_dict(info))
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            model = PCEncoder(self.info, generator=generator)
            if params is not None:
                from .checkpoint import load_jax_params

                load_jax_params(model, params)
            self.device = torch.device(device)
            self.model = model.to(self.device).eval()
            self.voxelized = voxelized
            self.scale_factor = (self.info.scale_factor
                                 if scale_factor is None else scale_factor)
            self.offset = offset
            self.config = config
            self.warm_timing = warm_timing
            self.shard = shard
            self.shard_mesh = shard_mesh
            self._shard_runner = None
            # geometry cache: MinkowskiEngine's coordinate manager keeps
            # kernel maps per sparse tensor, so the reference's timed pass
            # after warmup re-runs only the network; one cloud's plan is
            # kept, keyed on the input offset and checked against the cloud
            # by identity
            self._geom_cache: dict = {}

    @torch.no_grad()
    def encode(self, pcd: PointCloud, input_offset=None):
        """Quantize + run the network. Returns (SplatParams in grid units,
        grid, plan)."""
        pin_fp32()
        with trace.span("gpcr.encode"):
            dev = pcd.device
            off_np = (np.zeros(3, np.float32) if input_offset is None
                      else np.asarray(input_offset, np.float32).reshape(3))
            with trace.span("gpcr.encode.quantize"):
                in_off = torch.as_tensor(off_np, device=dev).reshape(1, 3)
                xyz = pcd.xyz_w[0]
                if self.voxelized:
                    coords = xyz + in_off
                else:
                    coords = xyz * self.scale_factor + self.offset + in_off
                rgb = pcd.rgb[0]
                valid = pcd.get_valid_mask()[0, :, 0]
                feats = assemble_input_features(self.info, coords, rgb,
                                                self.offset)
                grid = sparse.quantize_average(coords, feats, valid=valid)
            trace.count("voxels", grid.num)

            with trace.span("gpcr.encode.plan"):
                geom_key = tuple(np.round(off_np, 6))
                cached = self._geom_cache.get(geom_key)
                if cached is not None and cached[0] is pcd:
                    plan = cached[1]
                    trace.count("plan_hits", 1)
                else:
                    plan = self.model.build_plan(grid)
                    self._geom_cache = {geom_key: (pcd, plan)}
                    trace.count("plan_builds", 1)
            return self.model(grid, plan), grid, plan

    @torch.no_grad()
    def render(
        self, pcd: PointCloud, scale, cam: Camera, fov: float,
        enable_opacity: bool = True, super_sample_rate: int = 2,
        input_offset=None, point_light=None, consistent_normal=False,
        est_normal_from_ellipsoid: bool = False, background_color=0.0,
        timing: T.Optional[dict] = None,
    ) -> dict:
        if consistent_normal:
            raise NotImplementedError("consistent_normal is not supported")

        def splats(pcd):
            # warmup then timed network pass (simple_raw_render.py:372-379)
            sp, _, _ = self.encode(pcd, input_offset)
            sync(sp.primitives)
            t0 = time.perf_counter()
            sp, _, _ = self.encode(pcd, input_offset)
            sync(sp.primitives)
            model_time = time.perf_counter() - t0
            with trace.span("gpcr.splats"):
                normal = (globals()["est_normal_from_ellipsoid"](
                    sp.scale, sp.rotation) if est_normal_from_ellipsoid
                    else None)
                return world_splats(
                    sp, self.offset, self.scale_factor,
                    enable_opacity and self.info.enable_opacity,
                    normal), model_time

        return _render_request(
            self, pcd, scale, cam, fov,
            dict(enable_opacity=enable_opacity,
                 super_sample_rate=super_sample_rate,
                 input_offset=input_offset, point_light=point_light,
                 est_normal_from_ellipsoid=est_normal_from_ellipsoid,
                 background_color=background_color),
            timing, self.info.sh_deg, splats)
