"""Span profile of the learned ``pcrender`` path on one device:

    python -m gpcr_tpu_torch.cli.profile_pcrender            # 800K, full width
    python -m gpcr_tpu_torch.cli.profile_pcrender --n_points 2000 \
        --channels "9 8 8 8 8 8" --views 2 --res 32 --device cpu

Input: the synthetic THuman-like cloud of ``scripts/bench_pcrender.py``
(seed 0, scale factor 448) and a ``PCEncoder`` with seeded random weights.
It builds a ``PCMLRender`` and calls its ``render`` under
``utils.trace.recording()``, and prints

0. one ``spans init`` JSON line: the host ms of ``gpcr.init``, the
   renderer's construction (weights on the host, then on the device);
1. per repetition, one ``spans`` JSON line: the host ms of each of the
   renderer's spans in one request (summed by name; no profiler is on)
   and the request's counters. The first repetition includes the kernel
   build and the plan build;
2. for one more request under ``torch.profiler`` (CPU, and CUDA on a
   card): the profiler's table of the top ops; one ``span`` JSON line per
   span name: how many, host ms, device ms launched inside it and
   device-idle ms while the host was inside it (``self_idle_ms``: while it
   was the innermost span); and one ``device`` JSON line of totals: busy,
   placed inside a span, idle, idle inside ``gpcr.render`` and, of that,
   idle under one of its children.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops import rasterize as R
from ..render import renderer as RD
from ..structures.pointcloud import PointCloud
from ..utils import trace
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


def _host_ms(rec: trace.Recorder) -> dict:
    ms: dict = {}
    for sp in rec.spans:
        ms[sp.name] = ms.get(sp.name, 0.0) + (sp.end_ns - sp.start_ns) / 1e6
    return {k: round(v, 3) for k, v in ms.items()}


@torch.no_grad()
def main(argv=None):
    """Returns (the Recorder of the construction, the Recorder and the
    ``Recorder.attribute`` table of the profiled request, and its
    output)."""
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    info = dict(LEARNED_INFO, clr_encoder_channels=args.channels,
                scale_factor=args.scale_factor)
    config = R.RasterizeConfig(max_dup_per_gaussian=args.dup_cap,
                               chunk_size=256, opacity_radius=True)
    with trace.recording() as init:
        rdr = RD.PCMLRender(info=info, voxelized=True,
                            scale_factor=args.scale_factor, config=config,
                            device=device)
    print("spans init " + json.dumps({"host_ms": _host_ms(init)}),
          flush=True)
    xyz, rgb = synthetic_cloud(args.n_points, args.scale_factor)
    pcd = PointCloud.from_numpy(xyz, rgb, device=device)
    cam = RD.generate_cam({"fov": args.fov, "width_px": args.res,
                           "height_px": args.res, "mode": "circle",
                           "n_imgs": args.views, "d": 0, "r": 3,
                           "center_angles": [90, 0]}, device=device)

    def request():
        out = rdr.render(pcd, None, cam, args.fov, background_color=1.0)
        sync(out)
        return out

    for rep in range(args.reps):
        with trace.recording() as rec:
            request()
        print(f"spans rep {rep} " + json.dumps(
            {"host_ms": _host_ms(rec), "counters": rec.counters[0]}),
            flush=True)
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with trace.recording() as rec, profile(activities=acts) as prof:
        out = request()
    key = ("self_device_time_total" if device.type == "cuda"
           else "self_cpu_time_total")
    print(prof.key_averages().table(sort_by=key, row_limit=args.top),
          flush=True)
    table = rec.attribute(prof)
    # without a card the profile holds no device activity: host ms only
    keys = (("count", "host_ms", "device_ms", "idle_ms", "self_idle_ms")
            if device.type == "cuda" else ("count", "host_ms"))
    for name, row in table["spans"].items():
        print("span " + json.dumps(
            {"name": name, **{k: round(row[k], 3) for k in keys}}),
            flush=True)
    if device.type == "cuda":
        print("device " + json.dumps(
            {k: round(v, 3) for k, v in table.items() if k != "spans"}),
            flush=True)
    return init, rec, table, out


if __name__ == "__main__":
    main()
