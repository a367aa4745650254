"""The learned renderer with Point Transformer V3 as its backbone,
``PCMLRender.render`` with ``model_type`` "ptv3": quantize, the PTv3
backbone and its head, then one fused rasterizer pass per view. The
attention work of a request (counted from the reference's own hierarchy of
the cloud at set-up, never by the program) goes into each request's timing
dict for ``metrics/attn_roofline.py``."""

from __future__ import annotations

import math

import torch

from .. import scene
from ..reference import ptv3
from . import camera, pcml, point_cloud, raster_config

WITH_NORMAL = True
ENCODES = 2  # per request: the renderer's warm pass, then its timed pass


def _settings(cfg: dict) -> dict:
    return ptv3.settings(cfg["pcml_info"])


def make_inputs(cfg: dict, seed: int, device) -> dict:
    xyz, rgb = scene.cloud(cfg["cloud"], seed, device)
    weights = ptv3.make_weights(
        _settings(cfg), pcml._feat_dim(cfg["pcml_info"]),
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
        with torch.no_grad():
            per_pass = ptv3.attention_work(inputs["xyz"], _settings(cfg))
        self.attn_work = per_pass * ENCODES

    def __call__(self, poses, timing: dict) -> dict:
        t = self.traffic
        out = self.rdr.render(
            self.pcd, self.cfg["cloud"]["scale_factor"], camera(poses, t),
            t["fov_deg"], super_sample_rate=t["supersample"],
            background_color=self.cfg["background"], timing=timing)
        timing["attn_work"] = self.attn_work
        return out


def reference_splats(cfg: dict, inputs: dict) -> dict:
    sf, off = cfg["cloud"]["scale_factor"], cfg["cloud"]["offset"]
    sp = ptv3.splats(inputs["xyz"], inputs["rgb"], inputs["weights"],
                     _settings(cfg), sf, off)
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
