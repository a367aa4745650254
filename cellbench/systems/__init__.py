"""The systems under test, one module per renderer kind (a configuration's
``renderer`` key): each gives ``make_inputs`` (the benchmark's own inputs
from the seed), ``Program`` (the program's public render entry, driven one
request at a time) and ``reference_splats`` (the reference's splats from the
same inputs, with ``with_normal``)."""

from __future__ import annotations

import importlib

OUTPUTS = ("rgb", "xyz_w", "hitmap", "normal")


def load(kind: str):
    return importlib.import_module(f"cellbench.systems.{kind}")


def camera(poses, traffic: dict):
    """The program's ``Camera`` for (views, 4, 4) poses."""
    import torch

    from gpcr_tpu_torch.structures.camera import (Camera,
                                                  derive_camera_intrinsics)

    views = poses.shape[0]
    k = derive_camera_intrinsics(traffic["width"], traffic["height"],
                                 traffic["fov_deg"], device=poses.device)
    return Camera(H_c2w=poses[None], intrinsic=k.expand(1, views, 3, 3),
                  width_px=traffic["width"], height_px=traffic["height"])


def raster_config(raster: dict):
    from gpcr_tpu_torch.ops.rasterize import RasterizeConfig

    return RasterizeConfig(
        max_dup_per_gaussian=raster["dup_cap"], chunk_size=raster["chunk"],
        k_budget=raster.get("k_budget"),
        max_active_tiles=raster.get("max_active"),
        opacity_radius=raster.get("opacity_radius", False))


def point_cloud(xyz, rgb):
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    return PointCloud(xyz_w=xyz[None], rgb=rgb[None])
