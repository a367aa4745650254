"""Train-step latency at deployment scale on the port (twin of
``scripts/bench_train_step.py``): forward + backward through the
differentiable rasterizer at 800K points / 512² output x2 supersampling
(1024² inside), the reference's training resolution class.

    python -m gpcr_tpu_torch.scripts.bench_train_step [--reps 5] \
        [--device cuda]

One step is ``ops/rasterize.py::rasterize_gaussians`` with
``differentiable=True``: the ``torch.autograd.Function`` of
``ops/rasterize_stream_vjp.py`` (the contributor-count forward kernel and
the replay backward kernel), then ``.backward()`` of the mean squared
error against a grey target, with gradients for the means, scales,
opacities and colours. Prints the median of ``--reps`` timed steps (each
waited for on the device), the first step (which includes loading the
kernels), the loss, max|g| and every step's ms.

Not ported, on purpose: ``--impl xla`` (the JAX package's differentiable
XLA scan bounded by ``max_chunks``; the port's backward replays every
entry, ROADMAP "Not queued").
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..ops import rasterize as R
from ..render import renderer as RD
from ..utils.blend_inputs import analytic_scene
from ..utils.timing import device_label, sync
from . import require_device

SSRATE = 2


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=800_000)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--k_budget", type=int, default=6_000_000)
    ap.add_argument("--max_active", type=int, default=4096)
    ap.add_argument("--dup_cap", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the "
                         "kernels' plain versions)")
    return ap


def build(args, device):
    """The scene and config of one step: (leaves [means, scales,
    rotations, opacities, colours], settings, config). The cloud is
    ``bench_matrix.make_cloud`` at scale 448 (the JAX script's draws),
    the camera view 0 of a 2-view circle at ``--res``² x2, SH degree 0."""
    leaves, settings, _ = analytic_scene(args.points, device, res=args.res)
    config = R.RasterizeConfig(
        max_dup_per_gaussian=args.dup_cap, chunk_size=args.chunk,
        k_budget=args.k_budget, max_active_tiles=args.max_active,
        differentiable=True)
    return leaves, settings, config


def main(argv=None) -> dict:
    """Run the benchmark; returns ``ms`` (median), ``times_ms``,
    ``first_s``, ``loss``, ``max_grad``, ``grads_finite`` and ``device``."""
    args = build_parser().parse_args(argv)
    dev = require_device(args.device)
    RD.pin_fp32()
    leaves, settings, config = build(args, dev)
    means, scales, rotations, opacity, feats = leaves
    wrt = [means, scales, opacity, feats]  # the JAX script's argnums
    for x in wrt:
        x.requires_grad_(True)

    def step():
        for x in wrt:
            x.grad = None
        color, _ = R.rasterize_gaussians(
            means, opacity, settings, scales=scales, rotations=rotations,
            colors_precomp=feats, config=config)
        loss = torch.mean((color - 0.5) ** 2)
        loss.backward()
        return loss.detach()

    t0 = time.perf_counter()
    val = step()
    sync(val)
    first_s = time.perf_counter() - t0
    gmax = max(float(x.grad.abs().max()) for x in wrt)
    ts = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        val = step()
        sync((val, means.grad))
        ts.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ts))
    finite = all(bool(torch.isfinite(x.grad).all()) for x in wrt)
    label = device_label(dev)
    print(f"impl=stream fwd+bwd {args.points / 1e3:.0f}K/"
          f"{args.res}^2x{SSRATE}ss: {med:.1f} ms/step "
          f"(first call {first_s:.1f}s, loss {float(val):.5f}, "
          f"max|g| {gmax:.3e}, reps {ts}) device={label}", flush=True)
    return dict(ms=med, times_ms=ts, first_s=first_s, loss=float(val),
                max_grad=gmax, grads_finite=finite, device=label)


if __name__ == "__main__":
    main(sys.argv[1:])
