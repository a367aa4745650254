"""The learned renderer, ``PCMLRender.render``: quantize, the sparse U-Net
and its head, then one fused rasterizer pass per view."""

from __future__ import annotations

import math

import torch

from .. import scene
from ..reference import network
from . import camera, point_cloud, raster_config

WITH_NORMAL = True


def _channels(cfg):
    return [int(c) for c in cfg["pcml_info"]["clr_encoder_channels"].split()]


def _feat_dim(info: dict) -> int:
    # the head layout the reference implements: rotation 4, scale 3,
    # offset 3, normal 3
    want = dict(use_rotation=True, use_scale=True, use_offset=True,
                use_dc_offset=False, use_opacity=False, est_normal=True,
                normalize_normal=True, sh_feat_deg=0, sh_deg=1)
    bad = {k: info.get(k) for k, v in want.items() if info.get(k) != v}
    if bad:
        raise NotImplementedError(f"the reference head has no {bad}")
    return 13


def make_inputs(cfg: dict, seed: int, device) -> dict:
    xyz, rgb = scene.cloud(cfg["cloud"], seed, device)
    weights = network.make_weights(
        _channels(cfg), _feat_dim(cfg["pcml_info"]),
        scene.generator(seed, scene.STREAM_WEIGHTS, device), device)
    return {"xyz": xyz, "rgb": rgb, "weights": weights}


class Program:
    """``PCMLRender`` with the benchmark's weights and one static cloud."""

    def __init__(self, cfg: dict, traffic: dict, inputs: dict, device):
        from gpcr_tpu_torch.render.renderer import PCMLRender

        self.cfg, self.traffic = cfg, traffic
        self.rdr = PCMLRender(
            info=cfg["pcml_info"], voxelized=True,
            scale_factor=cfg["cloud"]["scale_factor"],
            offset=cfg["cloud"]["offset"],
            config=raster_config(cfg["raster"]), device=device)
        self.rdr.model.color_encoder.load_state_dict(inputs["weights"])
        self.pcd = point_cloud(inputs["xyz"], inputs["rgb"])

    def __call__(self, poses, timing: dict) -> dict:
        t = self.traffic
        return self.rdr.render(
            self.pcd, self.cfg["cloud"]["scale_factor"], camera(poses, t),
            t["fov_deg"], super_sample_rate=t["supersample"],
            background_color=self.cfg["background"], timing=timing)


def reference_splats(cfg: dict, inputs: dict) -> dict:
    sf, off = cfg["cloud"]["scale_factor"], cfg["cloud"]["offset"]
    _feat_dim(cfg["pcml_info"])
    sp = network.splats(inputs["xyz"], inputs["rgb"], inputs["weights"],
                        _channels(cfg), sf, off)
    n = sp["voxels"]
    dev = inputs["xyz"].device
    return {
        "means": (sp["xyz"] - off) / sf,
        "scales": sp["scale"] * float(math.sqrt(3) / sf * 6),
        "rotation": sp["rotation"],
        "opacity": torch.ones(n, device=dev),
        "sh": sp["sh"], "normal": sp["normal"],
        "valid": torch.ones(n, dtype=torch.bool, device=dev),
        "flops": sp["flops"], "voxels": n,
    }
