"""Mesh -> point-cloud dataset generation (port of
``gpcr_tpu/cli/sample_pcd.py``): samples every ``<root>/<id>/<id>.obj``
into ``<root>/<id>/pcd_0.ply``, assets in parallel on a forkserver pool.

    python -m gpcr_tpu_torch.cli.sample_pcd --dataset_root <root> \\
        --method poisson_disk --workers 1 [--device cpu]

Methods: ``uniform``, ``uniform_quantized`` (the default: round(xyz * 448)
+ 512, deduplicated), ``poisson_disk`` and ``uniform_camera`` (see
``structures/mesh.py``). Sampling runs on the host; ``uniform_camera``
builds its cameras and unprojects its hits on ``--device`` (default
``cuda``). An asset that fails is reported with its traceback and the
others go on, as in the JAX package; ``main`` returns the written paths,
None for each failed asset.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import sys
import traceback


def sample_mesh(task):
    root, asset_id, num_points, method, out_name, device = task
    try:
        from ..structures.mesh import Mesh

        mesh_fn = os.path.join(root, asset_id, f"{asset_id}.obj")
        mesh = Mesh(mesh_fn, scale=1.0)
        pcd = mesh.sample_point_cloud(num_points, method=method, device=device)
        out = os.path.join(root, asset_id, out_name)
        pcd.save(out, overwrite=True)
        print(f"[ok] {asset_id}: {int(pcd.get_num_valid_points(0))} points "
              f"-> {out}", flush=True)
        return out
    except Exception:  # one asset's failure does not stop the others
        print(f"[error] {asset_id}:", file=sys.stderr)
        traceback.print_exc()
        return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset_root", type=str, required=True)
    ap.add_argument("--num_points", type=int, default=800_000)
    ap.add_argument("--method", type=str, default="uniform_quantized",
                    choices=["uniform", "uniform_quantized", "poisson_disk",
                             "uniform_camera"])
    ap.add_argument("--out_name", type=str, default="pcd_0.ply")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--id_list", type=str, default="",
                    help="comma-separated; empty = all subdirs")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of uniform_camera's unprojection "
                         "(default cuda)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda but torch.cuda.is_available() "
                               "is False; pass --device cpu")

    if args.id_list:
        ids = args.id_list.split(",")
    else:
        ids = sorted(
            d for d in os.listdir(args.dataset_root)
            if os.path.isdir(os.path.join(args.dataset_root, d))
        )
    tasks = [
        (args.dataset_root, i, args.num_points, args.method, args.out_name,
         args.device)
        for i in ids
        if os.path.exists(os.path.join(args.dataset_root, i, f"{i}.obj"))
    ]
    if args.workers <= 1 or len(tasks) <= 1:
        return [sample_mesh(t) for t in tasks]
    ctx = mp.get_context("forkserver")
    with ctx.Pool(args.workers) as pool:
        return pool.map(sample_mesh, tasks)


if __name__ == "__main__":
    main()
