"""Benchmark CLI (port of the ``pcrender`` and ``simple`` tasks of
``gpcr_tpu/cli/benchmark.py``):

    python -m gpcr_tpu_torch.cli.benchmark pcrender --ckpt <run>/checkpoint/x.npz \
        --id_list 0519 --dataset_root ./example/THuman-256 --scale_factor 256 \
        --fov 45 --voxelized --skip_mesh
    python -m gpcr_tpu_torch.cli.benchmark simple --scale_factor 448 --fov 45 \
        --voxelized --skip_mesh

The parser keeps the JAX CLI's flags and adds ``--device`` (default
``cuda``; the CPU runs the blend's plain PyTorch version and must be asked
for). Mesh ground truth and metric scoring are not ported yet: without
``--skip_mesh`` the tasks raise NotImplementedError, as does the ``cam``
task.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..io import save_pic
from ..ops.rasterize import RasterizeConfig
from ..render.renderer import PCMLRender, SimpleRender, generate_cam
from ..structures.pointcloud import PointCloud

point_light_dict = {
    "longdress": {
        "xyz_w": [[5.0, -5.0, -5.0], [-5.0, 5.0, -5.0], [0.0, -5.0, -5.0]],
        "color": [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
        "light_coeff": [0.7, 0.6, 0.3, 0.1],
    },
}

_NOT_PORTED = ("mesh ground truth and metric scoring are not ported yet "
               "(the metrics slice of the port); pass --skip_mesh")


def _camera_for(args, task: str, device):
    if args.cam_mode != "circle":
        raise NotImplementedError(
            f"--cam_mode {args.cam_mode} is not ported yet (only 'circle')")
    cam_info = {
        "fov": args.fov, "width_px": 512, "height_px": 512,
        "mode": "circle", "n_imgs": 12, "d": 0, "r": 3,
        "center_angles": [90, 0], "alt_yaxis": False,
    }
    return generate_cam(cam_info, device=device), cam_info


def _save_render_outputs(out, rpth, tag):
    def host(x):
        return x.detach().cpu().numpy()

    save_pic(host(out["rgb"]), rpth + tag, type="rgb")
    if out.get("normal") is not None:
        save_pic(host(out["normal"]), rpth + tag, type="normal_w")
    if out.get("xyz_w") is not None:
        save_pic(host(out["xyz_w"]), rpth + tag, type="xyz_w")
    if out.get("shaded") is not None:
        save_pic(host(out["shaded"]), rpth + tag, type="shaded")


def _raster_config(args) -> RasterizeConfig:
    """Inference raster config: 256-row stream chunks, the tiles-per-splat
    cap (overflow is counted and warned), opacity-aware tile rects."""
    return RasterizeConfig(
        impl="stream", max_dup_per_gaussian=args.dup_cap,
        chunk_size=256,
        max_active_tiles=args.max_active_tiles or None,
        k_budget=args.k_budget or None,
        opacity_radius=not args.no_opacity_radius,
    )


def get_pcrender_renders(args, device):
    rdr = PCMLRender(
        args.ckpt, voxelized=args.voxelized, scale_factor=args.scale_factor,
        offset=args.offset, warm_timing=True, config=_raster_config(args),
        device=device,
    )
    camera, cam_info = _camera_for(args, "pcrender", device)
    input_offset = np.array(args.input_offset.split(","), dtype=np.float32)
    print("[Info] input_offset:", input_offset)
    outs = {}
    for id in args.id_list.split(","):
        print("[Info] Processing", id)
        if args.metric_only:
            raise NotImplementedError(_NOT_PORTED)
        pcd = PointCloud.from_ply(f"{args.dataset_root}/{id}/pcd_0.ply",
                                  device=device)
        timing = {}
        print("[Info] pts_center:",
              pcd.xyz_w[0].mean(0).detach().cpu().numpy())
        if args.down_sample_ratio != 1.0:
            n = pcd.get_num_points()
            keep = torch.as_tensor(np.random.choice(
                n, int(n * args.down_sample_ratio), replace=False),
                device=device)
            pcd = pcd.replace(
                xyz_w=pcd.xyz_w[:, keep], rgb=pcd.rgb[:, keep],
                normal_w=(pcd.normal_w[:, keep]
                          if pcd.normal_w is not None else None),
                valid_mask=None,
            )
        out = rdr.render(
            pcd, scale=None, cam=camera, fov=cam_info["fov"],
            enable_opacity=True, super_sample_rate=args.pcrender_ssrate,
            input_offset=input_offset, point_light=point_light_dict.get(id),
            background_color=args.background_color, timing=timing,
        )
        _save_render_outputs(out, args.rpth, f"{id}_pcrender")
        outs[id] = (out, timing)
    return outs


def get_simple_renders(args, device):
    if args.down_sample_ratio != 1.0:
        raise NotImplementedError(
            "--down_sample_ratio for the simple task (voxel downsampling) "
            "is not ported yet")
    rdr = SimpleRender(
        voxelized=args.voxelized, scale_factor=args.scale_factor,
        offset=args.offset, config=_raster_config(args), warm_timing=True,
    )
    camera, cam_info = _camera_for(args, "simple", device)
    input_offset = np.array(args.input_offset.split(","), dtype=np.float32)
    print("[Info] input_offset:", input_offset)
    outs = {}
    for id in args.id_list.split(","):
        print("[Info] Processing", id)
        if args.metric_only:
            raise NotImplementedError(_NOT_PORTED)
        pcd = PointCloud.from_ply(f"{args.dataset_root}/{id}/pcd_0.ply",
                                  device=device)
        timing = {}
        out = rdr.render(
            pcd, scale=None, cam=camera, fov=cam_info["fov"],
            enable_opacity=False, super_sample_rate=args.pcrender_ssrate,
            input_offset=input_offset, point_light=point_light_dict.get(id),
            background_color=float(np.mean(args.background_color)),
            sigma=args.sigma, timing=timing,
        )
        _save_render_outputs(out, args.rpth,
                             f"{id}_simple_sigma_{args.sigma}")
        outs[id] = (out, timing)
    return outs


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("task", type=str, choices=["pcrender", "simple", "cam"])
    p.add_argument("--ckpt", type=str,
                   default="./models/1-21-2/train/checkpoint/model_epoch39.pth")
    p.add_argument("--id_list", type=str, default="0519")
    p.add_argument("--dataset_root", type=str, default="./example/THuman-256")
    p.add_argument("--rpth", type=str, default="validate/res/render/")
    p.add_argument("--pcrender_ssrate", type=int, default=2)
    p.add_argument("--skip_mesh", action="store_true")
    p.add_argument("--fov", type=int, default=45)
    p.add_argument("--voxelized", action="store_true")
    p.add_argument("--scale_factor", type=int, default=256)
    p.add_argument("--input_offset", type=str, default="0,0,0")
    p.add_argument("--cam_mode", type=str, default="circle")
    p.add_argument("--cam_json", type=str, default="")
    p.add_argument("--background_color", type=str, default="1")
    p.add_argument("--metric_only", action="store_true")
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--simple_on", action="store_true")
    p.add_argument("--offset", type=int, default=512)
    p.add_argument("--cam_save_path", type=str, default="validate/res/cam/cam.npz")
    p.add_argument("--down_sample_ratio", type=float, default=1.0)
    p.add_argument("--dup_cap", type=int, default=16,
                   help="tiles-per-splat cap for the stream rasterizer")
    p.add_argument("--k_budget", type=int, default=-1,
                   help="sorted-entry cap (0 or -1 = none: every emitted "
                        "entry is kept; a positive value drops the tail "
                        "and warns)")
    p.add_argument("--kb_sweep", type=int, default=0,
                   help="accepted for CLI parity; no effect (the TPU "
                        "k_budget size-class sweep is not ported)")
    p.add_argument("--feat_f32", action="store_true",
                   help="accepted for CLI parity; the CUDA blend always "
                        "accumulates in float32")
    p.add_argument("--no_opacity_radius", action="store_true",
                   help="disable opacity-aware tile rects")
    p.add_argument("--max_active_tiles", type=int, default=0,
                   help="grid budget on non-empty tiles (0 = all)")
    p.add_argument("--shard", type=str, default="none",
                   choices=["none", "views", "tiles"],
                   help="multi-device rendering; only 'none' is ported")
    p.add_argument("--num_frames", type=int, default=12)
    p.add_argument("--use_t_indices", action="store_true")
    p.add_argument("--t_idx_pth", type=str, default="t_idx.npy")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    return p


def main(argv=None):
    """Run a task; returns {id: (outputs, timing)} with timing holding
    model_time, rgb_time (seconds) and dup_overflow (dropped entries)."""
    args = build_parser().parse_args(argv)
    bc = args.background_color.split(",")
    if len(bc) == 1:
        args.background_color = np.array([float(bc[0])] * 3, np.float32)
    else:
        args.background_color = np.array(bc, dtype=np.float32) / 255.0
    if args.task == "cam":
        raise NotImplementedError("the 'cam' task is not ported yet")
    if not args.skip_mesh:
        raise NotImplementedError(_NOT_PORTED)
    if args.shard != "none":
        raise NotImplementedError("--shard (multi-device) is not ported yet")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to render on the CPU")
    print(f"[Info] device: {device}", flush=True)
    if args.task == "pcrender":
        return get_pcrender_renders(args, device)
    return get_simple_renders(args, device)


if __name__ == "__main__":
    main(sys.argv[1:])
