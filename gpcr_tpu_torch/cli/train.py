"""Training CLI (port of ``gpcr_tpu/cli/train.py``).

    python -m gpcr_tpu_torch.cli.train --steps 1000 --batch_size 2 \
        --dataset_root ./example/THuman-256  # or omit for synthetic scenes

Runs on the GPU unless ``--device cpu``. Checkpoints
(``<out_dir>/checkpoint/step_<n>.pt``: model + optimizer state + step,
written by ``train.trainer.save_train_state``) are resumable with
``--resume``.

Several GPUs: one process per card, dp x sp of them (``--sp`` views
split over sp ranks, the batch's clouds over dp = world / sp):

    torchrun --nproc_per_node 4 -m gpcr_tpu_torch.cli.train --sp 2 \
        --batch_size 2 --n_views 2

Every rank starts from rank 0's weights (``parallel.sharding.replicate``)
and builds the whole global batch from ``--seed`` with the same loader, then
keeps its slice (``shard_batch``), so each rank's (cloud, view) slice is
the data the single-process run gives that slice. The gradients are
summed over the ranks before the clip and the Adam step
(``train.trainer.Trainer``); the logged metrics are the global ones. Rank
0 alone writes checkpoints and logs; every rank reads the checkpoint on
``--resume``. ``--batch_size`` must be a multiple of dp and ``--n_views``
of sp.
"""

from __future__ import annotations

import argparse
import os
import re
import time

import torch

from ..parallel import distributed

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


def _log_step(m: dict) -> None:
    skip = ("loss", "step", "s_per_step", "dup_overflow")
    print(
        f"step {m['step']}: loss={m['loss']:.5f} "
        + " ".join(f"{k}={v:.5f}" for k, v in m.items() if k not in skip)
        + f" ({m['s_per_step']:.2f} s/step)",
        flush=True,
    )
    if m["dup_overflow"]:
        print(f"[Warn] rasterizer dropped {int(m['dup_overflow'])} "
              f"splat-tile entries (raise the dup cap)", flush=True)


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
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available "
                           "(pass --device cpu to run on the CPU)")

    started = distributed.initialize(
        backend="gloo" if args.device == "cpu" else None)
    try:
        return _train(args)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _train(args):
    from ..parallel.sharding import make_mesh, replicate, shard_batch
    from ..train.data import DataLoader
    from ..train.trainer import Trainer, load_train_state, save_train_state

    mesh = make_mesh(sp=args.sp)  # dp x sp must be the world
    main_rank = distributed.is_main()

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
        learning_rate=args.lr, num_warmup_steps=args.warmup, mesh=mesh,
    )
    loader = DataLoader(
        mesh_paths=mesh_paths, batch_size=args.batch_size,
        n_points=args.n_points, n_views=args.n_views, hw=args.hw,
        scale_factor=args.scale_factor, seed=args.seed, device=args.device,
    )

    ckpt_dir = os.path.abspath(os.path.join(args.out_dir, "checkpoint"))
    if main_rank:
        os.makedirs(ckpt_dir, exist_ok=True)

    start_step = 0
    saved = _checkpoint_steps(ckpt_dir)
    if args.resume and saved:
        start_step = load_train_state(
            _checkpoint_path(ckpt_dir, saved[-1]), trainer)
        if main_rank:
            print(f"[resume] step {start_step}")
    replicate(trainer.model, mesh)

    history = []  # one dict of floats per logged step
    t0 = time.time()
    since = 0
    for step in range(start_step, args.steps):
        batch = loader.next_batch()
        local = shard_batch(
            {k: v for k, v in batch.items() if k != "tanfov"}, mesh)
        local["tanfov"] = batch["tanfov"]
        metrics = trainer.train_step(local)
        since += 1
        if (step + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}  # synchronises
            dt = (time.time() - t0) / since
            t0, since = time.time(), 0
            m["step"] = step + 1
            m["s_per_step"] = dt
            history.append(m)
            if main_rank:
                _log_step(m)
        if main_rank and ((step + 1) % args.save_every == 0
                          or step + 1 == args.steps):
            save_train_state(_checkpoint_path(ckpt_dir, step + 1), trainer)
            for old in _checkpoint_steps(ckpt_dir)[:-KEEP_CHECKPOINTS]:
                os.remove(_checkpoint_path(ckpt_dir, old))
    if main_rank:
        print(f"[done] {args.steps} steps; checkpoints in {ckpt_dir}")
    return {"trainer": trainer, "history": history, "start_step": start_step,
            "checkpoint_dir": ckpt_dir}


if __name__ == "__main__":
    main()
