"""Renderer orchestration (port of ``gpcr_tpu/render/renderer.py``):
``PCMLRender`` (learned splats from the PCEncoder) and ``SimpleRender``
(analytic splats), the projection / raster-settings builders and
``pcgc_rescale``.

All outputs of a view — rgb, world xyz, hit map and (learned path)
normal — are feature channels of ONE rasterizer pass, and the x2
supersampling downscale is folded into the blend kernel's tile write.
Views render in a Python loop.

Parity notes kept from the reference: raster settings use tanfov =
tan(fov), NOT tan(fov/2) (:101-102); the projection matrix uses tan(fov/2)
with znear 0.01 and zfar 100; PCML scales are multiplied by
sqrt(3)/scale_factor*6.
"""

from __future__ import annotations

import math
import os
import time
import typing as T

import numpy as np
import torch

from ..models.encoder import PCEncoder, PCMLInfo, assemble_input_features
from ..ops import rasterize as R
from ..ops import sparse
from ..structures.camera import Camera
from ..structures.pointcloud import PointCloud
from ..structures.trajectory import CameraTrajectory
from ..utils import sh as sh_utils
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


def fuse_view_features(campos, means3d, shs, normal, bg3, sh_degree,
                       with_normal):
    """Per-view fused features [rgb | xyz | ones | (camera-facing normal)]
    and their per-channel background [bg3, bg3, bg3 (, bg3)]."""
    rgb = sh_utils.eval_sh_color(sh_degree, shs, means3d, campos)
    feats = [rgb, means3d, torch.ones_like(means3d)]
    bgs = [bg3, bg3, bg3]
    if with_normal:
        cam_dir = means3d - campos[None, :]
        sgn = (torch.sum(cam_dir * normal, -1, keepdim=True) > 0).to(
            torch.float32) * 2.0 - 1.0
        feats.append(normal * (-1.0) * sgn)
        bgs.append(bg3)
    return torch.cat(feats, dim=-1), torch.cat(bgs, dim=-1)


def _render_one_view(
    view_t, full_t, campos,
    means3d, scales, rotations, opacity, shs, normal, valid,
    bg3, tanfov, height, width, sh_degree, config: R.RasterizeConfig,
    with_normal: bool, use_pallas: bool = False,
):
    """Render one view with all output channels fused into one pass
    (gradients flow when ``config.differentiable``). ``use_pallas`` (the
    JAX package's name for it) takes the aligned all-tiles blend of
    ``ops/rasterize_aligned.py``: forward only, always at (height, width),
    and its dropped entries are not counted. Returns (color (C, h, w),
    dup_overflow)."""
    features, bg = fuse_view_features(
        campos, means3d, shs, normal, bg3, sh_degree, with_normal)
    settings = R.GaussianRasterizationSettings(
        image_height=height, image_width=width, tanfovx=tanfov,
        tanfovy=tanfov, bg=bg, scale_modifier=1.0, viewmatrix=view_t,
        projmatrix=full_t, sh_degree=sh_degree, campos=campos,
    )
    if use_pallas:
        from . import _get_pallas_raster

        color, _ = _get_pallas_raster()(
            means3d, opacity, settings, scales=scales, rotations=rotations,
            colors_precomp=features, valid_mask=valid, config=config,
        )
        return color, torch.zeros((), dtype=torch.long, device=color.device)
    color, _, extra = R.rasterize_gaussians(
        means3d, opacity, settings, scales=scales, rotations=rotations,
        colors_precomp=features, valid_mask=valid, config=config,
        return_extra=True,
    )
    return color, extra["dup_overflow"]


def render_views_fused(
    view_ts, full_ts, camposes,  # (q, 4, 4), (q, 4, 4), (q, 3)
    means3d, scales, rotations, opacity, shs, normal, valid,
    bg3, tanfov,
    height: int, width: int, out_h: int, out_w: int, sh_degree: int,
    config: R.RasterizeConfig, with_normal: bool, use_pallas: bool = False,
) -> dict:
    """All views of one cloud, one fused rasterizer pass per view.
    Returns a dict of (q, out_h, out_w, 3) images plus per-view
    ``dup_overflow`` (q,)."""
    pin_fp32()
    if (not use_pallas and config.downscale == 1
            and height == 2 * out_h and width == 2 * out_w
            and config.tile_x % 2 == 0 and config.tile_y % 2 == 0):
        # fold the x2-supersampling downscale into the stream blend's tile
        # write; the aligned route renders at full size and is resized below
        config = config._replace(downscale=2)
    colors, overflow = [], []
    for vt, ft, cp in zip(view_ts, full_ts, camposes):
        color, ovf = _render_one_view(
            vt, ft, cp, means3d, scales, rotations, opacity, shs, normal,
            valid, bg3, tanfov, height, width, sh_degree, config, with_normal,
            use_pallas)
        colors.append(color)
        overflow.append(ovf)
    colors = bilinear_resize(torch.stack(colors), out_h, out_w)
    out = {
        "rgb": colors[:, 0:3].permute(0, 2, 3, 1),
        "xyz_w": colors[:, 3:6].permute(0, 2, 3, 1),
        "hitmap": colors[:, 6:9].permute(0, 2, 3, 1),
        "normal": (colors[:, 9:12].permute(0, 2, 3, 1) if with_normal
                   else None),
        # dropped splat-tile entries per view (dup cap / k_budget /
        # max_active_tiles); callers warn after the timed region
        "dup_overflow": torch.stack(overflow),
    }
    return out


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


def _exact_budget(config: R.RasterizeConfig) -> R.RasterizeConfig:
    """k_budget -1 (auto) is the exact budget: with dynamic shapes the
    binning keeps every emitted entry, which is what the JAX auto budget
    achieves by sizing."""
    return config._replace(k_budget=None) if config.k_budget == -1 else config


def _finish(out: dict, point_light, model_time, rgb_time,
            timing: T.Optional[dict]) -> dict:
    print("model time: %.3f sec, rgb time: %.3f sec" % (model_time, rgb_time),
          flush=True)
    ovf = int(out.pop("dup_overflow").sum())
    if timing is not None:
        timing.update(model_time=model_time, rgb_time=rgb_time,
                      dup_overflow=ovf)
    if ovf:
        print(f"[Warn] rasterizer dropped {ovf} splat-tile entries "
              f"(raise the dup cap / k_budget)", flush=True)
    ret = {k: (v[None] if v is not None else None) for k, v in out.items()}
    if point_light is not None and ret["normal"] is not None:
        ret["shaded"] = apply_point_light(
            {k: v[0] for k, v in ret.items() if v is not None}, point_light
        )[None]
    return ret


def _concat_batch(outs: T.List[dict]) -> dict:
    return {k: (torch.cat([o[k] for o in outs], dim=0)
                if outs[0][k] is not None else None) for k in outs[0]}


# --------------------------------------------------------------------------
# SimpleRender
# --------------------------------------------------------------------------


class SimpleRender:
    """No-network analytic baseline: identity quaternions, isotropic
    σ/scale_factor scales, opacity 1, SH DC = RGB2SH(rgb) with zero AC."""

    def __init__(self, voxelized=True, scale_factor=None, offset=512,
                 config: R.RasterizeConfig = R.RasterizeConfig(),
                 warm_timing: bool = False):
        self.voxelized = voxelized
        self.scale_factor = 1.0 if scale_factor is None else scale_factor
        self.offset = offset
        self.config = config
        # run the rgb pass once before the timed one
        self.warm_timing = warm_timing

    def render(
        self, pcd: PointCloud, scale, cam: Camera, fov: float,
        enable_opacity: bool = False, super_sample_rate: int = 2,
        input_offset=None, point_light=None, consistent_normal=False,
        est_normal_from_ellipsoid=False, background_color=0.0, sigma=1.0,
        timing: T.Optional[dict] = None,
    ) -> dict:
        pin_fp32()
        if pcd.batch_size > 1:
            return _concat_batch([
                self.render(
                    pcd[ib], scale, cam[ib], fov,
                    enable_opacity=enable_opacity,
                    super_sample_rate=super_sample_rate,
                    input_offset=input_offset, point_light=point_light,
                    background_color=background_color, sigma=sigma,
                )
                for ib in range(pcd.batch_size)
            ])
        dev = pcd.device
        in_off = torch.zeros((1, 3), device=dev) if input_offset is None else (
            torch.as_tensor(np.asarray(input_offset, np.float32),
                            device=dev).reshape(1, 3))
        xyz = pcd.xyz_w[0] + in_off
        rgb = pcd.rgb[0]
        valid = pcd.get_valid_mask()[0, :, 0]
        n = xyz.shape[0]

        t0 = time.time()
        sh_deg = 1
        scale_norm = self.scale_factor if self.voxelized else 1.0
        pseudo = (2 ** (sh_deg + 1)) * 3  # 12 zero AC rows
        shs = torch.cat([sh_utils.RGB2SH(rgb)[:, None, :],
                         torch.zeros((n, pseudo, 3), device=dev)], dim=1)
        means = (pcgc_rescale(xyz, self.offset, self.scale_factor)
                 if self.voxelized else xyz)
        rotations = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).expand(n, 4)
        scales = torch.ones((n, 3), device=dev) * (sigma / scale_norm)
        opacity = torch.ones((n,), device=dev)
        sync(opacity)
        model_time = time.time() - t0

        bg3 = torch.zeros((3,), device=dev) + torch.as_tensor(
            np.asarray(background_color, np.float32), device=dev)
        rp = get_rasterize_param_from_camera(
            cam, fov, bg=bg3, sh_degree=sh_deg,
            super_sample_rate=super_sample_rate)
        config = _exact_budget(self.config)

        def run():
            return render_views_fused(
                rp["view_t"], rp["full_t"], rp["campos"],
                means, scales, rotations, opacity, shs,
                torch.zeros_like(means), valid, bg3, rp["tanfov"],
                height=rp["height"], width=rp["width"],
                out_h=cam.height_px, out_w=cam.width_px,
                sh_degree=sh_deg, config=config, with_normal=False,
            )

        if self.warm_timing:
            sync(run())
        t0 = time.time()
        out = run()
        sync(out)
        rgb_time = time.time() - t0
        return _finish(out, point_light, model_time, rgb_time, timing)


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
    """

    def __init__(
        self, ckpt: T.Optional[str] = None, voxelized: bool = True,
        scale_factor: T.Optional[int] = None, offset: int = 512,
        info: T.Optional[dict] = None, params=None,
        config: R.RasterizeConfig = R.RasterizeConfig(),
        warm_timing: bool = False, device="cpu",
        generator: T.Optional[torch.Generator] = None,
    ):
        if ckpt is not None:
            params, info = load_pcml(ckpt)
        elif info is None:
            raise ValueError("PCMLRender needs a ckpt or an info dict")
        self.info = info if isinstance(info, PCMLInfo) else PCMLInfo.from_dict(info)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        model = PCEncoder(self.info, generator=generator)
        if params is not None:
            from .checkpoint import load_jax_params

            load_jax_params(model, params)
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.voxelized = voxelized
        self.scale_factor = (
            self.info.scale_factor if scale_factor is None else scale_factor)
        self.offset = offset
        self.config = config
        self.warm_timing = warm_timing
        # geometry cache: MinkowskiEngine's coordinate manager keeps kernel
        # maps per sparse tensor, so the reference's timed pass after warmup
        # re-runs only the network; one cloud's plan is kept, keyed on the
        # input offset and checked against the cloud by identity
        self._geom_cache: dict = {}

    @torch.no_grad()
    def encode(self, pcd: PointCloud, input_offset=None):
        """Quantize + run the network. Returns (SplatParams in grid units,
        grid, plan)."""
        pin_fp32()
        dev = pcd.device
        off_np = (np.zeros(3, np.float32) if input_offset is None
                  else np.asarray(input_offset, np.float32).reshape(3))
        in_off = torch.as_tensor(off_np, device=dev).reshape(1, 3)
        xyz = pcd.xyz_w[0]
        if self.voxelized:
            coords = xyz + in_off
        else:
            coords = xyz * self.scale_factor + self.offset + in_off
        rgb = pcd.rgb[0]
        valid = pcd.get_valid_mask()[0, :, 0]
        feats = assemble_input_features(self.info, coords, rgb, self.offset)
        grid = sparse.quantize_average(coords, feats, valid=valid)

        geom_key = tuple(np.round(off_np, 6))
        cached = self._geom_cache.get(geom_key)
        if cached is not None and cached[0] is pcd:
            plan = cached[1]
        else:
            plan = self.model.build_plan(grid)
            self._geom_cache = {geom_key: (pcd, plan)}
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
        pin_fp32()
        if pcd.batch_size > 1:
            return _concat_batch([
                self.render(
                    pcd[ib], scale, cam[ib], fov,
                    enable_opacity=enable_opacity,
                    super_sample_rate=super_sample_rate,
                    input_offset=input_offset, point_light=point_light,
                    est_normal_from_ellipsoid=est_normal_from_ellipsoid,
                    background_color=background_color,
                )
                for ib in range(pcd.batch_size)
            ])

        # warmup then timed network pass (simple_raw_render.py:372-379)
        sp, _, _ = self.encode(pcd, input_offset)
        sync(sp.primitives)
        t0 = time.time()
        sp, _, _ = self.encode(pcd, input_offset)
        sync(sp.primitives)
        model_time = time.time() - t0

        dev = sp.primitives.device
        means = pcgc_rescale(sp.primitives, self.offset, self.scale_factor)
        radius = float(np.sqrt(3) / self.scale_factor * 6)
        scales = sp.scale * radius
        opacity = (sp.opacity[:, 0]
                   if (enable_opacity and self.info.enable_opacity)
                   else torch.ones_like(sp.opacity[:, 0]))
        if est_normal_from_ellipsoid:
            normal = globals()["est_normal_from_ellipsoid"](sp.scale,
                                                            sp.rotation)
        else:
            normal = sp.normal
        with_normal = normal is not None
        if normal is None:
            normal = torch.zeros_like(means)

        bg3 = torch.zeros((3,), device=dev) + torch.as_tensor(
            np.asarray(background_color, np.float32), device=dev)
        rp = get_rasterize_param_from_camera(
            cam, fov, bg=bg3, sh_degree=self.info.sh_deg,
            super_sample_rate=super_sample_rate)
        config = _exact_budget(self.config)

        def run():
            return render_views_fused(
                rp["view_t"], rp["full_t"], rp["campos"],
                means, scales, sp.rotation, opacity, sp.sh, normal,
                sp.valid, bg3, rp["tanfov"],
                height=rp["height"], width=rp["width"],
                out_h=cam.height_px, out_w=cam.width_px,
                sh_degree=self.info.sh_deg, config=config,
                with_normal=with_normal,
            )

        if self.warm_timing:
            sync(run())
        t0 = time.time()
        out = run()
        sync(out)
        rgb_time = time.time() - t0
        return _finish(out, point_light, model_time, rgb_time, timing)
