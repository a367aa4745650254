"""BASELINE.md's analytic benchmark matrix on the port (twin of
``scripts/bench_matrix.py``), all configs in one run:

  c1  simple render, 800K cloud quantized at sf 256 (708,565 points kept),
      512² x2ss, 12-view circle
  c3a simple render, 800K cloud (sf 448), 1024² x2ss (the headline config)
  c4  1.5M-point cloud, multi-view orbit, 512² x2ss
  c5  30-frame animated sequence at 1080p (1920x1080) x2ss, 800K cloud

    python -m gpcr_tpu_torch.scripts.bench_matrix [c1 c3a c4 c5] \
        [--device cuda]

Each config renders one warm call, then ``views_per_dispatch`` views per
timed call (one ``render_views_fused`` call, which renders its views one
after another on the device), waiting for the device after each call,
and prints one JSON line with the JAX script's keys (``ms_per_frame`` is
the median over the timed calls) and a ``#`` line with the per-call
times, the rendered path's own dropped entries summed over the timed
views (``render_dup_overflow``) and the device. ``dup_overflow`` in the
JSON line is, as in the JAX script, ``ops/rasterize.py::tile_bin``'s
overflow at view 0, which cuts ``k_budget`` in emit order where the
rendered stream binning cuts the sorted entries.

Not ported: ``feat_precision="default"`` (the TPU's one-pass bf16
feature contraction; the CUDA kernel accumulates in float32).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import rasterize as R
from ..render import renderer as RD
from ..structures.trajectory import CameraTrajectory
from ..utils import sh as sh_utils
from ..utils.timing import device_label, sync
from . import require_device

# the four configs of the JAX script (:130-146), by their command-line key
CONFIGS = {
    "c1": dict(name="c1_simple_quant256_512p", n_pts=800_000, sf=256,
               res_w=512, res_h=512, n_views=12, vpd=4, quantize=True,
               dup_cap=8, k_budget=2_200_000, max_active=4096),
    "c3a": dict(name="c3a_simple_800k_1024p", n_pts=800_000, sf=448,
                res_w=1024, res_h=1024, n_views=12, vpd=4,
                k_budget=1_800_000),
    "c4": dict(name="c4_simple_1p5m_512p_orbit", n_pts=1_500_000, sf=448,
               res_w=512, res_h=512, n_views=12, vpd=4, dup_cap=8,
               k_budget=3_600_000, max_active=4096),
    "c5": dict(name="c5_seq_1080p_30f", n_pts=800_000, sf=448, res_w=1920,
               res_h=1080, n_views=30, vpd=2, frames=30, dup_cap=8,
               k_budget=4_500_000, max_active=16384),
}


def make_cloud(n, sf, seed=0, quantize=False):
    """The synthetic THuman-like cloud: points on a vertically stretched
    sphere with 1% noise, on the PCGC grid at scale ``sf`` (the JAX
    script's draws, in its order). ``quantize`` keeps one point per
    integer voxel (the first by ``np.unique``). Returns (coords (n', 3)
    f32, rgb (n', 3) f32)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 1] *= 1.6
    v *= 0.55
    xyz = v + rng.randn(n, 3) * 0.01
    rgb = rng.rand(n, 3).astype(np.float32)
    coords = xyz * sf + 512
    if quantize:
        q = np.round(coords).astype(np.int64)
        key = (q[:, 0] * 2048 + q[:, 1]) * 2048 + q[:, 2]
        _, idx = np.unique(key, return_index=True)
        coords, rgb = q[idx].astype(np.float32), rgb[idx]
    return coords.astype(np.float32), rgb


def raster_config(dup_cap, k_budget, max_active, chunk=256):
    """The stream path's config: ``chunk``-row chunks (256: the round-5
    default of the JAX script), the dup cap and both budgets."""
    return R.RasterizeConfig(
        max_dup_per_gaussian=dup_cap, chunk_size=chunk, k_budget=k_budget,
        max_active_tiles=max_active)


def make_scene(coords, rgb, sf, res_w, res_h, n_views, sigma=1.0, fov=45.0,
               ssrate=2, device="cuda"):
    """Analytic splats of a cloud (isotropic, sigma / sf, opacity 1, SH
    degree 1 from the colours) and the raster parameters of an
    ``n_views`` circle at res_w x res_h, ``ssrate`` x supersampled: a dict
    of ``render``'s inputs."""
    dev = torch.device(device)
    n = len(coords)
    traj = CameraTrajectory(
        mode="circle", n_imgs=n_views, total=1,
        params={"d": 0, "r": 3, "center_angles": [90, 0]}, device=dev)
    cam = traj.get_camera(fov=fov, width_px=res_w, height_px=res_h)
    bg3 = torch.ones(3, device=dev)
    rp = RD.get_rasterize_param_from_camera(
        cam, fov, bg=bg3, sh_degree=1, super_sample_rate=ssrate)
    shs = torch.cat(
        [sh_utils.RGB2SH(torch.from_numpy(rgb).to(dev))[:, None, :],
         torch.zeros((n, 12, 3), device=dev)], dim=1)
    return dict(
        rp=rp, out_h=res_h, out_w=res_w, bg3=bg3,
        means=RD.pcgc_rescale(torch.from_numpy(coords).to(dev), 512, sf),
        scales=torch.full((n, 3), sigma / sf, device=dev),
        rotations=torch.tensor([1.0, 0, 0, 0], device=dev).repeat(n, 1),
        opacity=torch.ones((n,), device=dev),
        shs=shs, valid=torch.ones((n,), dtype=torch.bool, device=dev),
        normal=torch.zeros((n, 3), device=dev))


def render(scene: dict, config: R.RasterizeConfig, idx):
    """``render_views_fused`` of the views ``idx`` (without normals):
    the renderer's dict of (q, out_h, out_w, 3) images and per-view
    ``dup_overflow``."""
    rp = scene["rp"]
    idx = torch.as_tensor(np.asarray(idx), device=rp["view_t"].device)
    with torch.no_grad():
        return RD.render_views_fused(
            rp["view_t"][idx], rp["full_t"][idx], rp["campos"][idx],
            scene["means"], scene["scales"], scene["rotations"],
            scene["opacity"], scene["shs"], scene["normal"], scene["valid"],
            scene["bg3"], rp["tanfov"], height=rp["height"],
            width=rp["width"], out_h=scene["out_h"], out_w=scene["out_w"],
            sh_degree=1, config=config, with_normal=False)


def binning_report(scene: dict, config: R.RasterizeConfig,
                   max_active) -> dict:
    """The JAX scripts' overflow sanity at view 0 through
    ``ops/rasterize.py::tile_bin``: its overflow (dup cap and the
    emit-order ``k_budget`` cut), the non-empty tiles, and the tiles and
    entries beyond the busiest ``max_active`` ones (rendered as
    background; 0 when ``max_active`` is falsy)."""
    rp = scene["rp"]
    dev = scene["means"].device
    n = scene["means"].shape[0]
    settings = R.GaussianRasterizationSettings(
        rp["height"], rp["width"], rp["tanfov"], rp["tanfov"],
        torch.ones(12, device=dev), 1.0, rp["view_t"][0], rp["full_t"][0], 1,
        rp["campos"][0])
    with torch.no_grad():
        prep = R.preprocess(
            scene["means"], scene["opacity"], settings, config,
            scales=scene["scales"], rotations=scene["rotations"],
            colors_precomp=torch.zeros((n, 12), device=dev))
        gx = -(-rp["width"] // config.tile_x)
        nt = gx * (-(-rp["height"] // config.tile_y))
        _, starts, ovf = R.tile_bin(prep, nt, gx, config)
        counts = (starts[1:] - starts[:-1]).cpu().numpy()
    n_nonempty = int((counts > 0).sum())
    dropped_tiles = max(0, n_nonempty - max_active) if max_active else 0
    dropped_entries = (int(np.sort(counts)[::-1][max_active:].sum())
                       if dropped_tiles else 0)
    return dict(overflow=int(ovf), nonempty_tiles=n_nonempty,
                dropped_tiles=dropped_tiles, dropped_entries=dropped_entries)


def time_calls(scene, config, calls):
    """One warm call of ``calls[0]``'s views, then one timed call per
    entry of ``calls`` (a list of view-index lists); each call waits for
    the device. Returns (ms per frame of each call, dropped entries summed
    over the timed views)."""
    sync(render(scene, config, calls[0]))
    times, overflow = [], 0
    for idx in calls:
        t0 = time.perf_counter()
        out = render(scene, config, idx)
        sync(out)
        times.append((time.perf_counter() - t0) * 1e3 / len(idx))
        overflow += int(out["dup_overflow"].sum())
    return times, overflow


def run_config(name, n_pts, sf, res_w, res_h, n_views, vpd, seed=0,
               quantize=False, dup_cap=4, k_budget=2_000_000,
               max_active=8192, sigma=1.0, fov=45.0, ssrate=2, frames=None,
               device="cuda"):
    """Render and time one config; prints its JSON and ``#`` lines and
    returns the JSON line's dict plus ``times_ms``,
    ``render_dup_overflow`` and ``device``."""
    coords, rgb = make_cloud(n_pts, sf, seed, quantize)
    n = len(coords)
    scene = make_scene(coords, rgb, sf, res_w, res_h, n_views, sigma, fov,
                       ssrate, device)
    config = raster_config(dup_cap, k_budget, max_active)
    # vpd views per call, wrapping around the cameras, until the frames
    # are timed (the warm call renders views 0..vpd-1)
    starts = range(0, frames or n_views, vpd)
    times, render_ovf = time_calls(
        scene, config, [[(s + j) % n_views for j in range(vpd)]
                        for s in starts])
    report = binning_report(scene, config, max_active)

    ms = float(np.median(times))
    line = {
        "config": name, "points": int(n), "res": f"{res_w}x{res_h}",
        "ssrate": ssrate, "views_per_dispatch": vpd,
        "ms_per_frame": round(ms, 1), "fps": round(1000.0 / ms, 1),
        "frames_timed": len(times) * vpd,
        "dup_overflow": report["overflow"],
    }
    label = device_label(device)
    print(json.dumps(line), flush=True)
    print(f"# config={name} times_ms={times} "
          f"render_dup_overflow={render_ovf} device={label}", flush=True)
    return dict(line, times_ms=times, render_dup_overflow=render_ovf,
                device=label)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="*",
                    help=f"configs to run, of {' '.join(CONFIGS)} "
                         "(default: all four)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    unknown = [c for c in args.configs if c not in CONFIGS]
    if unknown:
        ap.error(f"unknown configs {unknown}; choose from {list(CONFIGS)}")
    require_device(args.device)
    RD.pin_fp32()
    return {key: run_config(**CONFIGS[key], device=args.device)
            for key in (args.configs or list(CONFIGS))}


if __name__ == "__main__":
    main(sys.argv[1:])
