"""The analytic renderer, ``SimpleRender.render``: isotropic splats of
sigma / scale factor, opacity 1, SH DC from the colours, one fused
rasterizer pass per view; no network."""

from __future__ import annotations

import torch

from .. import scene
from ..reference.network import SH_C0
from . import camera, point_cloud, raster_config

WITH_NORMAL = False


def make_inputs(cfg: dict, seed: int, device) -> dict:
    xyz, rgb = scene.cloud(cfg["cloud"], seed, device)
    return {"xyz": xyz, "rgb": rgb}


class Program:
    """``SimpleRender`` over one static cloud."""

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, device):
        from gpcr_tpu_torch.render.renderer import SimpleRender

        self.cfg, self.traffic = cfg, traffic
        self.rdr = SimpleRender(
            voxelized=True, scale_factor=cfg["cloud"]["scale_factor"],
            offset=cfg["cloud"]["offset"],
            config=raster_config(cfg["raster"]))
        self.pcd = point_cloud(inputs["xyz"], inputs["rgb"])

    def __call__(self, poses, timing: dict) -> dict:
        t = self.traffic
        return self.rdr.render(
            self.pcd, self.cfg["cloud"]["scale_factor"], camera(poses, t),
            t["fov_deg"], super_sample_rate=t["supersample"],
            background_color=self.cfg["background"],
            sigma=self.cfg["sigma"], timing=timing)


def reference_splats(cfg: dict, inputs: dict) -> dict:
    sf, off = cfg["cloud"]["scale_factor"], cfg["cloud"]["offset"]
    xyz, rgb = inputs["xyz"], inputs["rgb"]
    n, dev = xyz.shape[0], xyz.device
    sh = torch.zeros((n, 4, 3), device=dev)
    sh[:, 0] = (rgb - 0.5) / SH_C0
    return {
        "means": (xyz - off) / sf,
        "scales": torch.full((n, 3), cfg["sigma"] / sf, device=dev),
        "rotation": torch.tensor([1.0, 0, 0, 0], device=dev).expand(n, 4),
        "opacity": torch.ones(n, device=dev), "sh": sh, "normal": None,
        "valid": torch.ones(n, dtype=torch.bool, device=dev),
        "flops": None, "voxels": None,
    }
