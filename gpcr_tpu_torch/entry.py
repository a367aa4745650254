"""The end-to-end forward of the learned renderer in one call (port of
``__graft_entry__.py::entry`` and ``_tiny_scene``).

``entry()`` returns ``(fn, example_args)``. ``fn(params, coords, rgb,
view_t, full_t, campos)`` runs the flagship model's whole forward on a
tiny scene:

1. ``assemble_input_features`` (world xyz, quantization offset, rgb);
2. ``sparse.quantize_average`` onto the integer voxel grid;
3. ``PCEncoder.build_plan`` (the coordinate hierarchy and the convs'
   maps);
4. the encoder with ``params`` applied by ``torch.func.functional_call``
   (the counterpart of ``model.apply(params, ...)``);
5. ``world_splats``: ``pcgc_rescale(..., 512, 96)`` of the splat
   centres, the scales times ``sqrt(3) / 96 * 6``;
6. ``render_view`` of view 0 (dup cap 8, chunk 64, tile batch 4): on the
   card one launch of the serving blend kernel.

It returns the (12, 32, 32) image (rgb, world xyz, hit map, normal) and
drops the dup-cap overflow, as the JAX ``fn`` does. ``fn`` asks for no
gradients (``RasterizeConfig.differentiable`` stays False); call it under
``torch.no_grad()``.

The scene: 256 points on a sphere of radius 48 on the PCGC grid (offset
512), drawn by numpy ``RandomState(seed)`` as the JAX scene is, so
``coords`` and ``rgb`` are the same floats; a 2-view circle trajectory at
32², fov 60, no supersampling. The encoder is ``9 16 16 16 16 16`` at
scale factor 96, its weights drawn from a ``torch.Generator`` (seed 0
unless one is passed); ``params_from_jax`` carries the JAX ``init`` tree
across instead.

The port's encoder holds every voxel of each U-Net level. The JAX
``entry()`` plans its levels with the default capacities n, n, n/2, n/4
and drops the coarse voxels beyond them (on this scene it keeps 128 of
the 244 voxels of level 2 and 64 of level 3, which holds 195), so the two
``fn``s agree only once the JAX caps are lifted to n.

Unlike the JAX ``fn``, which is one jitted graph, this one waits on the
host where a size depends on the data: ``torch.unique`` in
``quantize_average`` and in each downsampling of ``build_plan``, the
first sparse-conv launch over each of the plan's 10 maps (which reads
the map's pair and slot counts, ``ops/sparse.py::tile_map``; ``fn``
builds a plan per call) and the emit size of the binning
(``ops/rasterize_stream.py::bin_sorted_stream``). One call on an H100
waited 16 times, 10 of them at the maps (``chip_smoke.py``'s
``phase_entry`` counts them by line). A ``torch.compile`` or CUDA-graph capture of ``fn`` would break
at each of them; this module takes neither.

    python -m gpcr_tpu_torch.entry [--device cpu]

runs ``fn`` once and prints its shape, then
``parallel.dryrun.dryrun_multichip`` with one rank per card (NCCL), or
with ``--device cpu`` in one gloo CPU process.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from torch.func import functional_call

from .models.encoder import PCEncoder, PCMLInfo, assemble_input_features
from .ops import rasterize as R
from .ops import sparse
from .render import renderer as RD
from .render.checkpoint import load_jax_params
from .scripts import require_device
from .structures.trajectory import CameraTrajectory

INFO = PCMLInfo(clr_encoder_channels="9 16 16 16 16 16", scale_factor=96)
HW = 32
OFFSET = 512
CONFIG = R.RasterizeConfig(max_dup_per_gaussian=8, chunk_size=64,
                           tile_batch=4)


def _tiny_scene(n_points=256, n_views=2, hw=HW, seed=0, device="cuda"):
    """(coords, rgb, view_t, full_t, campos, tanfov) on ``device``: points
    on a sphere on the voxel grid and a circle of ``n_views`` cameras."""
    dev = require_device(device)
    rng = np.random.RandomState(seed)
    v = rng.randn(n_points, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    coords = np.round(v * 48 + OFFSET).astype(np.float32)
    rgb = (v * 0.5 + 0.5).astype(np.float32)

    traj = CameraTrajectory(
        mode="circle", n_imgs=n_views, total=1,
        params={"d": 0, "r": 3, "center_angles": [90, 0]}, device=dev,
    )
    cam = traj.get_camera(fov=60.0, width_px=hw, height_px=hw)
    rp = RD.get_rasterize_param_from_camera(cam, 60.0, super_sample_rate=1)
    return (torch.from_numpy(coords).to(dev), torch.from_numpy(rgb).to(dev),
            rp["view_t"], rp["full_t"], rp["campos"], rp["tanfov"])


def params_from_jax(jax_params: dict, device="cuda") -> dict:
    """The JAX ``PCEncoder.init`` tree (nested dict of arrays) as the
    parameter dict ``fn`` takes, on ``device``."""
    dev = require_device(device)
    model = load_jax_params(PCEncoder(INFO), jax_params)
    return {k: p.detach().to(dev) for k, p in model.named_parameters()}


def entry(device="cuda", generator=None):
    """(fn, example_args): ``fn`` is the end-to-end forward described in
    the module docstring, ``example_args`` = (params, coords, rgb, view_t,
    full_t, campos) on ``device``."""
    dev = require_device(device)
    RD.pin_fp32()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = PCEncoder(INFO, generator=generator).to(dev)
    params = {k: p.detach() for k, p in model.named_parameters()}
    coords, rgb, view_t, full_t, campos, tanfov = _tiny_scene(device=dev)
    bg3 = torch.zeros(3, device=dev)

    def fn(params, coords, rgb, view_t, full_t, campos):
        feats = assemble_input_features(INFO, coords, rgb)
        grid = sparse.quantize_average(coords, feats)
        plan = model.build_plan(grid)
        splats = RD.world_splats(functional_call(model, params, (grid, plan)),
                                 OFFSET, INFO.scale_factor)
        color, _overflow = RD.render_view(
            view_t[0], full_t[0], campos[0], *splats[:7], bg3, tanfov, HW,
            HW, INFO.sh_deg, CONFIG, splats.with_normal)
        return color

    return fn, (params, coords, rgb, view_t, full_t, campos)


def main(argv=None) -> tuple:
    """Run ``fn`` once, print its shape, then the multi-process dry run.
    Returns the image's shape."""
    from .parallel.dryrun import dryrun_multichip

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    a = ap.parse_args(argv)
    fn, args = entry(device=a.device)
    with torch.no_grad():
        out = fn(*args)
    shape = tuple(out.shape)
    print("entry ok:", shape, flush=True)
    # one rank per card, as the JAX __main__ takes one per JAX device
    ranks = torch.cuda.device_count() if a.device == "cuda" else 1
    dryrun_multichip(ranks, device=a.device)
    return shape


if __name__ == "__main__":
    main()
