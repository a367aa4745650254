"""Headline benchmark on the port: per-frame splat render latency (twin of
the repository's ``bench.py``).

Config (BASELINE.md): an 800K-point cloud, 1024x1024 output, x2
supersampling (2048x2048 inside), analytic Simple-path splats; the
reference's 'rgb time' protocol: a warm call, then calls that wait for
the device (simple_raw_render.py:372-379,433-456).

    python -m gpcr_tpu_torch.bench [--device cuda]

Each call renders ``--views_per_dispatch`` views (one
``render_views_fused`` call; the port renders its views one after another
on the device), and a call's ms per frame is its time over its views.
Prints ONE JSON line on stdout,

  {"metric": "render_ms_per_frame_800k_1024", "value": <ms>, "unit": "ms"}

with the median over ``--frames`` timed calls, then on stderr a ``#``
line with every call's ms per frame, the ``k_budget``, the device (the
card's name and power limit), the non-empty tiles of view 0, the
``--max_active`` budget and the tiles and entries beyond it, and the
rendered path's own dropped entries summed over the timed views
(``render_dup_overflow``), and the JAX script's warnings.

Not ported, on purpose:
- ``--impl``: the port has one forward path, the stream blend (the XLA
  exact blend is a TPU-era alternative, ROADMAP "Not queued");
- ``--tps`` and ``--autotune_kb``: TPU grid steps per kernel step and the
  k_budget sweep over TPU HBM buffer placements;
- ``--feat_precision``: the TPU's one-pass bf16 feature contraction (the
  CUDA kernel accumulates in float32);
- the ``vs_baseline`` key: its 10 ms is BASELINE.md's target for one
  TPU v5e chip, and no number set for a TPU is a target of the port.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from .render import renderer as RD
from .scripts import bench_matrix as BM
from .scripts import require_device
from .utils.timing import device_label

# bench.py:174-177: real entries are ~1.65M per view at this config;
# overflow is counted and warned
DEFAULT_K_BUDGET = 1_800_000


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=800_000)
    ap.add_argument("--res", type=int, default=1024)
    ap.add_argument("--ssrate", type=int, default=2)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--scale_factor", type=int, default=448)
    ap.add_argument("--fov", type=float, default=45.0)
    ap.add_argument("--sigma", type=float, default=1.0)
    ap.add_argument("--dup_cap", type=int, default=4,
                    help="tiles-per-splat cap; 4 is lossless at the bench "
                         "scene by the JAX script's area histogram "
                         "(overflow is counted and warned)")
    ap.add_argument("--k_budget", type=int, default=0,
                    help="sorted-entry budget of the stream binning (0: "
                         f"{DEFAULT_K_BUDGET:,})")
    ap.add_argument("--chunk", type=int, default=256,
                    help="stream kernel chunk rows")
    ap.add_argument("--max_active", type=int, default=6144,
                    help="renders only the busiest non-empty tiles (0 = "
                         "all tiles); the entries of the rest are counted "
                         "and warned")
    ap.add_argument("--views_per_dispatch", type=int, default=16,
                    help="views rendered per timed call; ms per frame is "
                         "the call's time over its views")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    return ap


def main(argv=None) -> dict:
    """Run the benchmark; returns the JSON line's value (``ms``), every
    call's ms per frame (``times_ms``), ``k_budget``, ``device`` and the
    overflow counts printed on the ``#`` line."""
    args = build_parser().parse_args(argv)
    require_device(args.device)
    RD.pin_fp32()

    coords, rgb = BM.make_cloud(args.points, args.scale_factor)
    scene = BM.make_scene(coords, rgb, args.scale_factor, args.res,
                          args.res, args.frames, args.sigma, args.fov,
                          args.ssrate, args.device)
    k_budget = args.k_budget or DEFAULT_K_BUDGET
    config = BM.raster_config(args.dup_cap, k_budget, args.max_active or None,
                              chunk=args.chunk)
    vpd = max(1, args.views_per_dispatch)
    # call i renders views i, i + 1, ... (mod --frames), as bench.py does
    times, render_ovf = BM.time_calls(
        scene, config, [[(i + j) % args.frames for j in range(vpd)]
                        for i in range(args.frames)])

    report = BM.binning_report(scene, config, args.max_active)
    if report["overflow"] > 0:
        print(f"# WARNING: binning overflow {report['overflow']} entries "
              f"(raise --k_budget)", file=sys.stderr)
    ms = float(np.median(times))
    label = device_label(args.device)
    print(json.dumps({"metric": "render_ms_per_frame_800k_1024",
                      "value": round(ms, 3), "unit": "ms"}), flush=True)
    print(
        f"# frames={args.frames} times_ms={times} k_budget={k_budget} "
        f"device={label} nonempty_tiles={report['nonempty_tiles']} "
        f"max_active={args.max_active} "
        f"dropped_tiles={report['dropped_tiles']} "
        f"dropped_entries={report['dropped_entries']} "
        f"render_dup_overflow={render_ovf}",
        file=sys.stderr, flush=True)
    if report["dropped_tiles"]:
        print(f"# WARNING: max_active budget drops {report['dropped_tiles']} "
              f"tiles ({report['dropped_entries']} entries) — rendered as "
              f"background; raise --max_active for the all-tiles protocol",
              file=sys.stderr)
    return dict(ms=ms, times_ms=times, k_budget=k_budget, device=label,
                render_dup_overflow=render_ovf, **report)


if __name__ == "__main__":
    main(sys.argv[1:])
