"""Benchmark CLI (port of ``gpcr_tpu/cli/benchmark.py``, the
``simple_benchmark.py`` equivalent):

    python -m gpcr_tpu_torch.cli.benchmark pcrender --ckpt <run>/checkpoint/x.npz \
        --id_list 0519 --dataset_root ./example/THuman-256 --scale_factor 256 \
        --fov 45 --voxelized
    python -m gpcr_tpu_torch.cli.benchmark simple --scale_factor 448 --fov 45 \
        --voxelized
    python -m gpcr_tpu_torch.cli.benchmark cam --cam_mode circle ...

``pcrender`` and ``simple`` render ``<dataset_root>/<id>/pcd_0.ply``, ray
trace the mesh ``<dataset_root>/<id>/<id>.obj`` from the same cameras as
ground truth (the native BVH ray caster, on the host) and score the two
directories in-process (``cli/pic_metrics.py``: PSNR, MS-SSIM, LPIPS where
its weights are present); ``--skip_mesh`` renders only, ``--metric_only``
scores directories an earlier run wrote. ``cam`` saves a trajectory.

The parser keeps the JAX CLI's flags and adds ``--device`` (default
``cuda``; the CPU runs the blend's plain PyTorch version and must be asked
for). ``simple --down_sample_ratio`` voxel-downsamples the cloud on the
device with cells of width 2 for any ratio other than 1.0, as the JAX CLI
does.

``--shard views|tiles`` renders over every rank of the process group,
one process per card (``parallel/render.py``: the views split over the
ranks, or each frame's tile grid):

    torchrun --nproc_per_node 4 -m gpcr_tpu_torch.cli.benchmark simple \
        --shard tiles ...

Rank 0 alone writes the images, the ground truth and the scores, and
prints the timing line. Without a launcher it runs as a world of one.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..io import save_pic
from ..ops.rasterize import RasterizeConfig
from ..parallel import distributed
from ..render.renderer import PCMLRender, SimpleRender, generate_cam
from ..structures.camera import Camera
from ..structures.mesh import Mesh
from ..structures.pointcloud import PointCloud
from ..structures.ray import Ray
from . import pic_metrics

point_light_dict = {
    "longdress": {
        "xyz_w": [[5.0, -5.0, -5.0], [-5.0, 5.0, -5.0], [0.0, -5.0, -5.0]],
        "color": [[1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [1.0, 1.0, 1.0]],
        "light_coeff": [0.7, 0.6, 0.3, 0.1],
    },
}


def get_gt(pth: str, cam: Camera) -> dict:
    """Ray-traced mesh ground truth (numpy arrays shaped (b, q, h, w, .))."""
    mesh = Mesh(pth, scale=1.0)
    o, d = cam.generate_camera_rays(subsample=1, offsets="center")
    return mesh.get_ray_intersection(Ray(origins_w=o, directions_w=d))


def _camera_for(args, task: str, device):
    if args.cam_mode == "udlrfb":
        cam_info = {"fov": args.fov, "width_px": 512, "height_px": 512,
                    "mode": "udlrfb", "n_imgs": 6}
    elif args.cam_mode == "circle":
        cam_info = {
            "fov": args.fov, "width_px": 512, "height_px": 512,
            "mode": "circle", "n_imgs": 12, "d": 0, "r": 3,
            "center_angles": [90, 0], "alt_yaxis": False,
        }
    else:
        wh = 1024 if task == "pcrender" else 512
        cam_info = {"fov": args.fov, "width_px": wh, "height_px": wh,
                    "mode": args.cam_json, "n_imgs": 12}
    return generate_cam(cam_info, device=device), cam_info


def _score(rpth, render_dir, gt_dir, device) -> dict:
    return {
        "psnr": pic_metrics.psnr_dirs(
            render_dir, gt_dir, diff_dir=os.path.join(rpth, "difmap2", "diff"),
            device=device),
        "msssim": pic_metrics.msssim_dirs(render_dir, gt_dir, device=device),
        "lpips": pic_metrics.lpips_dirs(render_dir, gt_dir, device=device),
    }


def _save_mesh_gt(args, id, camera, rpth):
    mesh_gt = get_gt(f"{args.dataset_root}/{id}/{id}.obj", camera)
    hit = mesh_gt["hit_map"][..., None]
    rgb = mesh_gt["ray_rgbs"] + (1 - hit) * args.background_color
    save_pic(rgb, rpth + f"{id}_mesh_gt", "rgb")
    save_pic(mesh_gt["surface_normals_w"], rpth + f"{id}_mesh_gt", "normal_w",
             hit_map=hit)


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
        max_dup_per_gaussian=args.dup_cap, chunk_size=256,
        max_active_tiles=args.max_active_tiles or None,
        k_budget=args.k_budget or None,
        opacity_radius=not args.no_opacity_radius,
    )


def get_pcrender_renders(args, device):
    rdr = PCMLRender(
        args.ckpt, voxelized=args.voxelized, scale_factor=args.scale_factor,
        offset=args.offset, warm_timing=True, config=_raster_config(args),
        device=device, shard=_shard(args),
    )
    camera, cam_info = _camera_for(args, "pcrender", device)
    main_rank = distributed.is_main()
    input_offset = np.array(args.input_offset.split(","), dtype=np.float32)
    print("[Info] input_offset:", input_offset)
    outs = {}
    for id in args.id_list.split(","):
        print("[Info] Processing", id)
        rpth = args.rpth
        out, timing = None, {}
        if not args.metric_only:
            pcd = PointCloud.from_ply(f"{args.dataset_root}/{id}/pcd_0.ply",
                                      device=device)
            print("[Info] pts_center:",
                  pcd.xyz_w[0].mean(0).detach().cpu().numpy())
            if args.down_sample_ratio != 1.0:
                n = pcd.get_num_points()
                keep = torch.as_tensor(np.random.choice(
                    n, int(n * args.down_sample_ratio), replace=False),
                    device=device)
                if torch.distributed.is_initialized():
                    # every rank renders rank 0's subsample
                    torch.distributed.broadcast(keep, src=0)
                pcd = pcd.replace(
                    xyz_w=pcd.xyz_w[:, keep], rgb=pcd.rgb[:, keep],
                    normal_w=(pcd.normal_w[:, keep]
                              if pcd.normal_w is not None else None),
                    valid_mask=None,
                )
            if not args.skip_mesh and main_rank:
                t0 = time.time()
                _save_mesh_gt(args, id, camera, rpth)
                timing["gt_time"] = time.time() - t0
            out = rdr.render(
                pcd, scale=None, cam=camera, fov=cam_info["fov"],
                enable_opacity=True, super_sample_rate=args.pcrender_ssrate,
                input_offset=input_offset,
                point_light=point_light_dict.get(id),
                background_color=args.background_color, timing=timing,
            )
            if main_rank:
                _save_render_outputs(out, rpth, f"{id}_pcrender")
        if not args.skip_mesh and main_rank:
            t0 = time.time()
            timing["scores"] = _score(rpth, rpth + f"{id}_pcrender",
                                      rpth + f"{id}_mesh_gt", device)
            timing["score_time"] = time.time() - t0
        outs[id] = (out, timing)
    return outs


def _avg_nn_dist(xyz: np.ndarray) -> float:
    """Mean nearest-neighbour distance of ~2000 probe points against ALL
    points (the reference's kNN probe before its normal estimate)."""
    probe = xyz[:: max(1, len(xyz) // 2000)]
    nn = np.full(len(probe), np.inf)
    for s in range(0, len(xyz), 65536):
        blk = xyz[s:s + 65536]
        d2 = ((probe[:, None, :] - blk[None, :, :]) ** 2).sum(-1)
        d2[d2 == 0] = np.inf  # self-match
        nn = np.minimum(nn, d2.min(1))
    return float(np.sqrt(nn).mean())


def get_simple_renders(args, device):
    rdr = SimpleRender(
        voxelized=args.voxelized, scale_factor=args.scale_factor,
        offset=args.offset, config=_raster_config(args), warm_timing=True,
        shard=_shard(args),
    )
    camera, cam_info = _camera_for(args, "simple", device)
    main_rank = distributed.is_main()
    input_offset = np.array(args.input_offset.split(","), dtype=np.float32)
    print("[Info] input_offset:", input_offset)
    outs = {}
    for id in args.id_list.split(","):
        print("[Info] Processing", id)
        rpth = args.rpth
        tag = f"{id}_simple_sigma_{args.sigma}"
        out, timing = None, {}
        if not args.metric_only:
            pcd = PointCloud.from_ply(f"{args.dataset_root}/{id}/pcd_0.ply",
                                      device=device)
            if args.down_sample_ratio != 1.0:
                # the reference's rule: any ratio other than 1.0 means
                # voxel cells of width 2, whatever the ratio
                n_in = pcd.get_num_points()
                pcd = pcd.voxel_downsampling(cell_width=2.0)
                print(f"[Info] voxel downsampling (cell width 2): {n_in} -> "
                      f"{int(pcd.get_num_valid_points(0))} points")
            if pcd.normal_w is None:
                # the reference estimates normals for the simple task
                print("[Info] avg_dist:",
                      _avg_nn_dist(pcd.xyz_w[0].cpu().numpy()))
                pcd = pcd.estimate_normals()
            if not args.skip_mesh and main_rank:
                t0 = time.time()
                _save_mesh_gt(args, id, camera, rpth)
                timing["gt_time"] = time.time() - t0
            out = rdr.render(
                pcd, scale=None, cam=camera, fov=cam_info["fov"],
                enable_opacity=False, super_sample_rate=args.pcrender_ssrate,
                input_offset=input_offset,
                point_light=point_light_dict.get(id),
                background_color=float(np.mean(args.background_color)),
                sigma=args.sigma, timing=timing,
            )
            if main_rank:
                _save_render_outputs(out, rpth, tag)
        if not args.skip_mesh and main_rank:
            t0 = time.time()
            timing["scores"] = _score(rpth, rpth + tag,
                                      rpth + f"{id}_mesh_gt", device)
            timing["score_time"] = time.time() - t0
        outs[id] = (out, timing)
    return outs


def _shard(args):
    return None if args.shard == "none" else args.shard


def get_camera_info(args, device):
    """Task 'cam': save a camera trajectory (for ``plot1`` the five-stage
    1024² storyboard: orbit, zoom in, stay, zoom out, stay)."""
    if args.cam_mode == "plot1":
        base = {
            "fov": args.fov, "width_px": 1024, "height_px": 1024,
            "mode": "circle", "d": 0, "center_angles": [90, 0],
            "alt_yaxis": False,
        }

        def cam(n_imgs, r):
            return generate_cam({**base, "n_imgs": n_imgs, "r": float(r)},
                                device=device)

        cams = [cam(150, 3)]
        cams += [cam(1, r) for r in np.linspace(3, 1.5, 30)]  # zoom in
        cams += [cam(1, 1.5)] * 60  # stay
        cams += [cam(1, r) for r in np.linspace(1.5, 3, 30)]  # zoom out
        cams += [cam(1, 3)] * 30  # stay
        camera = Camera.cat(cams, dim=1)
    else:
        camera, _ = _camera_for(args, "cam", device)
    if args.use_t_indices:
        t_idx = np.round(np.arange(0, args.num_frames // 2 - 1, 0.5)).astype(
            np.int32)
        np.save(args.t_idx_pth, t_idx)
    os.makedirs(os.path.dirname(args.cam_save_path) or ".", exist_ok=True)
    camera.save(args.cam_save_path)
    print(f"[Info] saved camera trajectory ({tuple(camera.H_c2w.shape)}) to "
          f"{args.cam_save_path}")
    return camera


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
                   help="render over every rank of the process group "
                        "(one process per card, e.g. under torchrun): "
                        "'views' splits the views, 'tiles' each frame's "
                        "tile grid (parallel/render.py)")
    p.add_argument("--num_frames", type=int, default=12)
    p.add_argument("--use_t_indices", action="store_true")
    p.add_argument("--t_idx_pth", type=str, default="t_idx.npy")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to render on (default cuda)")
    return p


def main(argv=None):
    """Run a task. ``pcrender`` and ``simple`` return {id: (outputs,
    timing)}: outputs is None under ``--metric_only``; timing holds
    model_time, rgb_time (seconds), dup_overflow (dropped entries) and,
    without ``--skip_mesh``, gt_time and score_time (host seconds of the
    mesh ground truth and of the scoring) and scores = {psnr, msssim,
    lpips (None when its weights are absent)}. ``cam`` returns the saved
    Camera. With ``--shard`` the outputs are every rank's; files, scores
    and the timing line are rank 0's."""
    args = build_parser().parse_args(argv)
    bc = args.background_color.split(",")
    if len(bc) == 1:
        args.background_color = np.array([float(bc[0])] * 3, np.float32)
    else:
        args.background_color = np.array(bc, dtype=np.float32) / 255.0
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to render on the CPU")
    started = _shard(args) is not None and distributed.initialize(
        backend="gloo" if device.type == "cpu" else None)
    if _shard(args) is not None and not torch.distributed.is_initialized():
        raise ValueError(
            f"--shard {args.shard} needs a process group: run one process "
            f"per card under torchrun (torchrun --nproc_per_node N -m "
            f"gpcr_tpu_torch.cli.benchmark ...), or start one with "
            f"parallel.distributed.initialize() before main()")
    try:
        print(f"[Info] device: {device}", flush=True)
        if args.task == "pcrender":
            return get_pcrender_renders(args, device)
        if args.task == "simple":
            return get_simple_renders(args, device)
        return get_camera_info(args, device)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
