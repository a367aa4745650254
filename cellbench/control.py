"""Readings that set a cell's check limits, on the card, in one process:

    python3 cellbench/control.py --workload <cell> --seeds 11 12 13 \
        [--side program] [--side control]

For each seed it makes the cell's inputs and cameras as a run does and
reads the comparison numbers (``harness.compare``, worst view) of the
first ``sample_requests`` requests:

- ``program``: the program's outputs against the reference, as a run's
  check reads them (the lower reading of each limit);
- ``control``: the reference computed with TF32 matmuls (the precision
  below the configuration's float32 with TF32 off) in the program's
  place, against the reference in float32 (the upper reading).

One JSON line per seed and side; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def tf32(on: bool):
    import torch

    kept = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = kept


def reference_views(cell, system, inputs, poses_list, device, on: bool):
    """The reference's (C, h, w) images of every view of every request."""
    import torch

    from cellbench.reference import raster

    traffic, cfg = cell["traffic"], cell["config"]
    ss = traffic["supersample"]
    bg3 = torch.full((3,), float(cfg["background"]), device=device)
    with tf32(on), torch.no_grad():
        ref = system.reference_splats(cfg, inputs)
        return [[raster.render_view(
            ref, poses[v], traffic["fov_deg"], traffic["height"] * ss,
            traffic["width"] * ss, cfg["raster"], bg3,
            system.WITH_NORMAL)[0] for v in range(poses.shape[0])]
            for poses in poses_list]


def readings(workload: str, seed: int, sides, device="cuda", root=None,
             manifest=None) -> list:
    """[{"seed", "side", numbers...}] for one seed."""
    import torch

    from cellbench import harness, scene, systems

    cell = harness.load_cell(workload, root or harness.HERE, manifest)
    work, cfg, traffic = cell["workload"], cell["config"], cell["traffic"]
    system = systems.load(cfg["renderer"])
    inputs = system.make_inputs(cfg, seed, device)
    cams = scene.Cameras(traffic, seed, device)
    poses_list = [cams.request(i) for i in range(work["sample_requests"])]
    out = []
    t0 = time.perf_counter()
    truth = reference_views(cell, system, inputs, poses_list, device, False)
    if "program" in sides:
        prog = system.Program(cfg, traffic, inputs, device)
        with harness.quiet():
            prog(cams.warm(0), {})
            outs = [prog(p, {}) for p in poses_list]
        del prog
        out.append(_worst(seed, "program", [
            harness.port_views(o, system.WITH_NORMAL) for o in outs],
            truth))
        del outs
    if "control" in sides:
        low = reference_views(cell, system, inputs, poses_list, device, True)
        out.append(_worst(seed, "control", [
            torch.stack(views).permute(0, 2, 3, 1) for views in low], truth))
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    for line in out:
        line["seconds"] = time.perf_counter() - t0
    return out


def _worst(seed, side, images, truth) -> dict:
    from cellbench import harness

    worst = {}
    for port, views in zip(images, truth):
        for v, ref in enumerate(views):
            for k, val in harness.compare(port[v], ref).items():
                worst[k] = max(worst.get(k, 0.0), val)
            # which output the gap sits in: mean |d| per group of 3
            d = (port[v] - ref.permute(1, 2, 0)).abs()
            for g in range(d.shape[-1] // 3):
                key = "mae_" + ("rgb", "xyz", "hit", "normal")[g]
                val = float(d[..., 3 * g:3 * g + 3].mean())
                worst[key] = max(worst.get(key, 0.0), val)
    return {"seed": seed, "side": side, **worst}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--side", action="append", choices=("program", "control"))
    args = p.parse_args(argv)
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for line in readings(args.workload, seed,
                             args.side or ("program", "control")):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
