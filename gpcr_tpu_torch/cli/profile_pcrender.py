"""Stage profile of the learned ``pcrender`` path on one device:

    python -m gpcr_tpu_torch.cli.profile_pcrender            # 800K, full width
    python -m gpcr_tpu_torch.cli.profile_pcrender --n_points 2000 \
        --channels "9 8 8 8 8 8" --views 2 --res 32 --device cpu

Input: the synthetic THuman-like cloud of ``scripts/bench_pcrender.py``
(seed 0, scale factor 448) and a ``PCEncoder`` with seeded random weights.
It prints

1. per repetition, one ``stages`` JSON line: the host-clock ms of each
   stage of one encode and of one rgb pass (views summed), every stage
   ended by a device synchronise, which adds host time that the
   renderer's unsynchronised rgb pass does not pay. The first repetition
   includes the kernel build and allocator warmup;
2. a ``torch.profiler`` table of the top device ops of one warm encode
   and of one unsynchronised rgb pass;
3. one ``device`` JSON line per traced pass: wall ms (host clock, under
   the profiler), device busy ms (union of the device-side intervals) and
   the device's idle share ``1 - busy / wall``.

The per-view stages call the same functions, in the same order, as
``render_views_fused`` -> ``rasterize_gaussians_stream``; the returned
images equal ``PCMLRender.render``'s.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.encoder import assemble_input_features
from ..ops import rasterize as R
from ..ops import rasterize_stream as RS
from ..ops import sparse
from ..render import renderer as RD
from ..structures.pointcloud import PointCloud
from ..utils.timing import sync

LEARNED_INFO = {
    "clr_encoder_channels": "9 32 64 128 256 128",
    "sh_deg": 1, "sh_feat_deg": 0,
    "use_rotation": True, "use_scale": True, "use_offset": True,
    "use_dc_offset": False, "use_opacity": False, "est_normal": True,
    "normalize_normal": True, "enable_opacity": True,
    "scale_factor": 448, "model_type": "unet",
}


def synthetic_cloud(n: int = 800_000, sf: int = 448, seed: int = 0):
    """The stretched-sphere THuman-like cloud of scripts/bench_pcrender.py
    on the PCGC grid: (xyz (n, 3) f32 in [0, 1023], rgb (n, 3) f32)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 1] *= 1.6
    v *= 0.55
    xyz = v + rng.randn(n, 3) * 0.002
    coords = np.clip(xyz * sf + 512, 0, 1023).astype(np.float32)
    return coords, rng.rand(n, 3).astype(np.float32)


class _Stages:
    """Host-clock ms per stage, each stage ended by a device sync."""

    def __init__(self, device):
        self.device = device
        self.ms: dict = {}

    def __call__(self, name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out


def _encode(rdr: RD.PCMLRender, pcd: PointCloud, st: _Stages):
    xyz, rgb = pcd.xyz_w[0], pcd.rgb[0]
    valid = pcd.get_valid_mask()[0, :, 0]

    def quantize():
        feats = assemble_input_features(rdr.info, xyz, rgb, rdr.offset)
        return sparse.quantize_average(xyz, feats, valid=valid)

    grid = st("encode.quantize", quantize)
    plan = st("encode.build_plan", rdr.model.build_plan, grid)
    return st("encode.unet+head", rdr.model, grid, plan)


def _render(rdr, sp, cam, fov, st: _Stages):
    """The learned rgb pass, stage by stage (views summed)."""
    means = RD.pcgc_rescale(sp.primitives, rdr.offset, rdr.scale_factor)
    scales = sp.scale * float(np.sqrt(3) / rdr.scale_factor * 6)
    opacity = sp.opacity[:, 0]
    bg3 = torch.ones(3, device=means.device)
    rp = RD.get_rasterize_param_from_camera(cam, fov, bg=bg3,
                                            sh_degree=rdr.info.sh_deg)
    H, W = rp["height"], rp["width"]
    config = RD._exact_budget(rdr.config)._replace(downscale=2)
    grid_x, grid_y = -(-W // config.tile_x), -(-H // config.tile_y)
    num_tiles = grid_x * grid_y
    acfg = config._replace(tile_x=config.tile_x // 2,
                           tile_y=config.tile_y // 2)
    colors = []
    for vt, ft, cp in zip(rp["view_t"], rp["full_t"], rp["campos"]):
        def prep_view():
            feats, bg = RD.fuse_view_features(
                cp, means, sp.sh, sp.normal, bg3, rdr.info.sh_deg, True)
            settings = R.GaussianRasterizationSettings(
                H, W, rp["tanfov"], rp["tanfov"], bg, 1.0, vt, ft,
                rdr.info.sh_deg, cp)
            return bg, R.preprocess(
                means, opacity, settings, config, scales=scales,
                rotations=sp.rotation, colors_precomp=feats,
                valid_mask=sp.valid)

        bg, prep = st("view.features+preprocess", prep_view)
        stream, starts, _ = st("view.binning", RS.bin_sorted_stream, prep,
                               num_tiles, grid_x, config)
        order = st("view.order", lambda: torch.argsort(
            -(starts[1:] - starts[:-1]), stable=True).to(torch.int32))
        acc, t_run = st("view.blend_kernel", RS.blend_tiles, stream, starts,
                        order, num_tiles, grid_x, prep.features.shape[1],
                        config)
        color, _ = st("view.epilogue", lambda: RS.assemble_tiles(
            acc + t_run[..., None] * bg[None, None, :], t_run, H // 2,
            W // 2, acfg))
        colors.append(color)
    return torch.stack(colors)  # (q, 12, out_h, out_w)


def _device_busy_ms(prof) -> float:
    """Union of the device-side event intervals of a trace, in ms."""
    ivs = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.device_type.name == "CUDA")
    busy, end = 0.0, None
    for s, e in ivs:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / 1e3


def _traced(name, fn, device, top):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync_dev = (lambda: torch.cuda.synchronize(device)) if (
        device.type == "cuda") else (lambda: None)
    sync_dev()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync_dev()
        wall = (time.perf_counter() - t0) * 1e3
    key = ("self_device_time_total" if device.type == "cuda"
           else "self_cpu_time_total")
    print(f"[profile] {name}", flush=True)
    print(prof.key_averages().table(sort_by=key, row_limit=top), flush=True)
    busy = _device_busy_ms(prof) if device.type == "cuda" else None
    line = {"pass": name, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if busy is None else 1.0 - busy / wall}
    print("device " + json.dumps(line), flush=True)
    return line


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--n_points", type=int, default=800_000)
    p.add_argument("--scale_factor", type=int, default=448)
    p.add_argument("--channels", type=str,
                   default=LEARNED_INFO["clr_encoder_channels"])
    p.add_argument("--views", type=int, default=12)
    p.add_argument("--res", type=int, default=512,
                   help="output side; the rgb pass renders at x2")
    p.add_argument("--fov", type=int, default=45)
    p.add_argument("--dup_cap", type=int, default=256)
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--top", type=int, default=15,
                   help="rows of each profiler table")
    p.add_argument("--device", type=str, default="cuda")
    return p


@torch.no_grad()
def main(argv=None):
    """Returns (stage ms of the last repetition, device lines, the last
    rgb pass's (views, 12, res, res) images)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    RD.pin_fp32()
    info = dict(LEARNED_INFO, clr_encoder_channels=args.channels,
                scale_factor=args.scale_factor)
    config = R.RasterizeConfig(max_dup_per_gaussian=args.dup_cap,
                               chunk_size=256, opacity_radius=True)
    rdr = RD.PCMLRender(info=info, voxelized=True,
                        scale_factor=args.scale_factor, config=config,
                        device=device)
    xyz, rgb = synthetic_cloud(args.n_points, args.scale_factor)
    pcd = PointCloud.from_numpy(xyz, rgb, device=device)
    cam = RD.generate_cam({"fov": args.fov, "width_px": args.res,
                           "height_px": args.res, "mode": "circle",
                           "n_imgs": args.views, "d": 0, "r": 3,
                           "center_angles": [90, 0]}, device=device)
    for rep in range(args.reps):
        st = _Stages(device)
        sp = _encode(rdr, pcd, st)
        images = _render(rdr, sp, cam, args.fov, st)
        sync(images)
        print(f"stages rep {rep} " + json.dumps(
            {k: round(v, 3) for k, v in st.ms.items()}), flush=True)
    ignore = _Stages(torch.device("cpu"))
    lines = [
        _traced("encode", lambda: _encode(rdr, pcd, ignore), device,
                args.top),
        _traced("rgb", lambda: _render(rdr, sp, cam, args.fov, ignore),
                device, args.top),
    ]
    return st.ms, lines, images


if __name__ == "__main__":
    main()
