"""Training demonstration on the port (twin of ``scripts/train_demo.py``):
the trainer trains.

Runs the end-to-end differentiable pipeline (quantize -> SparseUNet ->
rasterize with the contributor-count forward and the replay backward ->
image losses, ``train/trainer.py``) for hundreds of steps on synthetic
textured scenes (or a THuman-layout ``--dataset_root``), reporting a loss
curve and held-out-view PSNR against ray-cast mesh ground truth, with
checkpoint and resume through ``train/trainer.save_train_state`` (one
``torch.save`` of model, optimizer and step).

    python -m gpcr_tpu_torch.scripts.train_demo --steps 500 \
        --out runs/train_demo [--device cuda]
    # resume after an interrupt: add --resume

The demo's learning rate and warmup (1e-3, 100) are higher and shorter
than the reference's production 1e-5 / 4000, since it runs a few hundred
steps, not 80 epochs. ``--device`` (default cuda) takes the place of the
JAX script's ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import require_device

SCALE_FACTOR = 96
INFO = {
    "clr_encoder_channels": "9 16 32 48 64 32",
    "sh_deg": 1, "sh_feat_deg": 0,
    "use_rotation": True, "use_scale": True, "use_offset": True,
    "use_dc_offset": True, "use_opacity": True, "est_normal": True,
    "normalize_normal": True, "enable_opacity": True,
    "scale_factor": SCALE_FACTOR, "model_type": "unet",
}


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--out", default="runs/train_demo")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--dataset_root", default=None,
                    help="THuman-layout tree <root>/<id>/<id>.obj "
                         "[+ pcd_0.ply]; defaults to synthetic scenes")
    ap.add_argument("--hw", type=int, default=48)
    ap.add_argument("--n_points", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--n_views", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--ckpt_every", type=int, default=100)
    ap.add_argument("--eval_every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def build(args):
    """The trainer (weights from seed 0), the training loader (seed 0)
    and the held-out batch: two scenes the training pool never holds
    (``synthetic_scene(seed=100 + s)``) seen from views drawn with seed
    777. Returns (trainer, loader, eval_batch)."""
    from ..train.data import DataLoader, synthetic_scene
    from ..train.trainer import Trainer

    dev = require_device(args.device)
    trainer = Trainer(
        info=INFO, render_hw=(args.hw, args.hw), device=dev,
        generator=torch.Generator().manual_seed(0),
        learning_rate=args.lr, num_warmup_steps=args.warmup)
    loader = DataLoader(
        dataset_root=args.dataset_root, batch_size=args.batch,
        n_points=args.n_points, n_views=args.n_views, hw=args.hw,
        scale_factor=SCALE_FACTOR, seed=0, device=dev)
    eval_loader = DataLoader(
        dataset_root=args.dataset_root, batch_size=2,
        n_points=args.n_points, n_views=args.n_views, hw=args.hw,
        scale_factor=SCALE_FACTOR, seed=777, synthetic_pool=2, device=dev)
    if args.dataset_root is None:
        # rotate the synthetic eval pool away from the train pool
        eval_loader.scenes = [
            {"mesh": synthetic_scene(seed=100 + s), "coords": None,
             "rgb": None}
            for s in range(2)
        ]
    return trainer, loader, eval_loader.next_batch()


def main(argv=None) -> dict:
    """Train; returns the ``history`` (one dict per step, ``psnr`` where
    evaluated), ``start_step``, the held-out PSNR at it (``psnr_start``),
    ``improved`` and the ``trainer``."""
    from ..train.trainer import load_train_state, save_train_state

    args = build_parser().parse_args(argv)
    trainer, loader, eval_batch = build(args)
    os.makedirs(args.out, exist_ok=True)

    ckpt = os.path.join(args.out, "train_state.pt")
    start_step = 0
    history = []
    hist_path = os.path.join(args.out, "curve.json")
    if args.resume and os.path.exists(ckpt):
        start_step = load_train_state(ckpt, trainer)
        if os.path.exists(hist_path):
            with open(hist_path) as f:
                history = json.load(f)
        print(f"[resume] from step {start_step}", flush=True)

    psnr0 = float(trainer.eval_psnr(eval_batch))
    print(f"step {start_step:4d}  held-out PSNR {psnr0:.2f} dB", flush=True)
    if start_step == 0:
        history.append({"step": 0, "psnr": psnr0})

    t0 = time.time()
    window = []
    for step in range(start_step, args.steps):
        batch = loader.next_batch()
        metrics = trainer.train_step(batch)
        loss = float(metrics["loss"])
        window.append(loss)
        rec = {"step": step + 1, "loss": loss}
        if (step + 1) % 25 == 0:
            print(
                f"step {step + 1:4d}  loss {np.mean(window):.4f}  "
                f"({(time.time() - t0) / max(step + 1 - start_step, 1):.2f}"
                f" s/step)", flush=True)
            window = []
        if (step + 1) % args.eval_every == 0 or step + 1 == args.steps:
            rec["psnr"] = float(trainer.eval_psnr(eval_batch))
            print(f"step {step + 1:4d}  held-out PSNR {rec['psnr']:.2f} dB",
                  flush=True)
        history.append(rec)
        if (step + 1) % args.ckpt_every == 0 or step + 1 == args.steps:
            save_train_state(ckpt, trainer)
            with open(hist_path, "w") as f:
                json.dump(history, f)

    psnrs = [h["psnr"] for h in history if "psnr" in h]
    losses = [h["loss"] for h in history if "loss" in h]
    k = max(len(losses) // 10, 1)
    improved = psnrs[-1] > psnrs[0] + 0.5
    print(
        f"\nsummary: loss {np.mean(losses[:k]):.4f} -> "
        f"{np.mean(losses[-k:]):.4f}; held-out PSNR "
        f"{psnrs[0]:.2f} -> {psnrs[-1]:.2f} dB "
        f"({'IMPROVED' if improved else 'no gain'})", flush=True)
    with open(hist_path, "w") as f:
        json.dump(history, f)
    print(f"curve: {hist_path}  checkpoint: {ckpt}", flush=True)
    return dict(history=history, start_step=start_step, psnr_start=psnr0,
                improved=improved, trainer=trainer)


if __name__ == "__main__":
    main(sys.argv[1:])
