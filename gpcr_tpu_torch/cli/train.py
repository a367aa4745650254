"""Training CLI (port of ``gpcr_tpu/cli/train.py``).

    python -m gpcr_tpu_torch.cli.train --steps 1000 --batch_size 2 \
        --dataset_root ./example/THuman-256  # or omit for synthetic scenes

Runs on the GPU unless ``--device cpu``. Checkpoints
(``<out_dir>/checkpoint/step_<n>.pt``: model + optimizer state + step,
written by ``train.trainer.save_train_state``) are resumable with
``--resume``. One device only: ``--sp`` other than 1 raises.
"""

from __future__ import annotations

import argparse
import os
import re
import time

import torch

KEEP_CHECKPOINTS = 3


def _checkpoint_steps(ckpt_dir: str):
    """Steps of the snapshots in ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = [int(m.group(1)) for m in
             (re.fullmatch(r"step_(\d+)\.pt", f) for f in os.listdir(ckpt_dir))
             if m]
    return sorted(steps)


def _checkpoint_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=2)
    ap.add_argument("--n_points", type=int, default=4096)
    ap.add_argument("--n_views", type=int, default=2)
    ap.add_argument("--hw", type=int, default=64)
    ap.add_argument("--scale_factor", type=int, default=96)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--warmup", type=int, default=4000)
    ap.add_argument("--dataset_root", type=str, default="")
    ap.add_argument("--out_dir", type=str, default="runs/train")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--save_every", type=int, default=200)
    ap.add_argument("--log_every", type=int, default=10)
    ap.add_argument("--channels", type=str, default="9 16 32 64 64 32")
    ap.add_argument("--sp", type=int, default=1, help="view-parallel size")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights and of the data")
    args = ap.parse_args(argv)
    if args.sp != 1:
        raise NotImplementedError(
            "--sp > 1 (views over several GPUs) is not ported yet "
            "(ROADMAP queue 4: multi-GPU)")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")

    from ..train.data import DataLoader
    from ..train.trainer import Trainer, load_train_state, save_train_state

    mesh_paths = None
    if args.dataset_root:
        mesh_paths = []
        for d in sorted(os.listdir(args.dataset_root)):
            obj = os.path.join(args.dataset_root, d, f"{d}.obj")
            if os.path.exists(obj):
                mesh_paths.append(obj)

    trainer = Trainer(
        info={
            "clr_encoder_channels": args.channels,
            "sh_deg": 1, "sh_feat_deg": 0,
            "use_rotation": True, "use_scale": True, "use_offset": True,
            "use_dc_offset": False, "use_opacity": False, "est_normal": True,
            "normalize_normal": True, "enable_opacity": True,
            "scale_factor": args.scale_factor, "model_type": "unet",
        },
        render_hw=(args.hw, args.hw),
        device=args.device,
        generator=torch.Generator().manual_seed(args.seed),
        learning_rate=args.lr, num_warmup_steps=args.warmup,
    )
    loader = DataLoader(
        mesh_paths=mesh_paths, batch_size=args.batch_size,
        n_points=args.n_points, n_views=args.n_views, hw=args.hw,
        scale_factor=args.scale_factor, seed=args.seed, device=args.device,
    )

    os.makedirs(args.out_dir, exist_ok=True)
    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, "checkpoint"))
    os.makedirs(ckpt_dir, exist_ok=True)

    start_step = 0
    saved = _checkpoint_steps(ckpt_dir)
    if args.resume and saved:
        start_step = load_train_state(
            _checkpoint_path(ckpt_dir, saved[-1]), trainer)
        print(f"[resume] step {start_step}")

    history = []  # one dict of floats per logged step
    t0 = time.time()
    since = 0
    for step in range(start_step, args.steps):
        batch = loader.next_batch()
        metrics = trainer.train_step(batch)
        since += 1
        if (step + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}  # synchronises
            dt = (time.time() - t0) / since
            t0, since = time.time(), 0
            m["step"] = step + 1
            m["s_per_step"] = dt
            history.append(m)
            skip = ("loss", "step", "s_per_step", "dup_overflow")
            print(
                f"step {step + 1}: loss={m['loss']:.5f} "
                + " ".join(f"{k}={v:.5f}" for k, v in m.items()
                           if k not in skip)
                + f" ({dt:.2f} s/step)",
                flush=True,
            )
            if m["dup_overflow"]:
                print(f"[Warn] rasterizer dropped {int(m['dup_overflow'])} "
                      f"splat-tile entries (raise the dup cap)", flush=True)
        if (step + 1) % args.save_every == 0 or step + 1 == args.steps:
            save_train_state(_checkpoint_path(ckpt_dir, step + 1), trainer)
            for old in _checkpoint_steps(ckpt_dir)[:-KEEP_CHECKPOINTS]:
                os.remove(_checkpoint_path(ckpt_dir, old))
    print(f"[done] {args.steps} steps; checkpoints in {ckpt_dir}")
    return {"trainer": trainer, "history": history, "start_step": start_step,
            "checkpoint_dir": ckpt_dir}


if __name__ == "__main__":
    main()
