"""A world of processes that runs the multi-GPU paths once and checks them
against one process (port of ``__graft_entry__.py::dryrun_multichip``):
one card per process over ``nccl``, or CPU processes over ``gloo``:

    python -m gpcr_tpu_torch.parallel.dryrun 4                 # 4 cards
    python -m gpcr_tpu_torch.parallel.dryrun 4 --device cpu

Each of the n ranks checks, at a tiny size:

- training: one dp x sp step (sp = 2 when n is even) on a seeded global
  batch; the updated parameters and the summed gradients equal those of
  one process taking the step on the whole batch, and so does the logged
  loss; every rank ends with the same parameters; the gradients are
  summed in one layout also where some ranks have none for a parameter;
- rendering on a flat mesh (all ranks on 'sp'): ``render_views_sharded``
  in 'views' mode (3 views over n ranks: the last view is repeated to pad)
  and in 'tiles' mode against ``render_views_fused``;
- ``replicate``: rank-dependent values become rank 0's;
- the tile-sharded overflow: the all-reduced MAX of the windows' own
  overflows, under a ``k_budget`` that cuts each window differently.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

# one step's parameters (learning rate 1e-3) and gradients (relative to
# the largest of each tensor) against one process: the sums run in another
# order (per-rank parts of the means, then the all-reduce)
TRAIN_TOL = 1e-5
# the sharded renders against render_views_fused (tests/test_parallel_render.py)
RENDER_TOL = 2e-5
HW = 16
RENDER_HW = 64  # 4 x 4 tiles, split over the ranks' windows
INFO = {
    "clr_encoder_channels": "9 8 8 8 8 8", "sh_deg": 1, "sh_feat_deg": 0,
    "use_rotation": True, "use_scale": True, "use_offset": True,
    "use_dc_offset": False, "use_opacity": False, "est_normal": True,
    "normalize_normal": True, "enable_opacity": True, "scale_factor": 96,
    "model_type": "unet",
}


def _cloud(seed: int, n: int = 256, scale_factor: int = 96):
    """Points on a sphere on the voxel grid (offset 512), with colours."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = np.round(v * 0.6 * scale_factor + 512).astype(np.float32)
    return xyz, (v * 0.5 + 0.5).astype(np.float32)


def global_batch(n_clouds: int, n_views: int, seed: int = 1,
                 device="cpu") -> dict:
    """A seeded training batch of ``n_clouds`` clouds and ``n_views``
    views each, HW² pixels, random targets (the layout of
    ``train.data.DataLoader.next_batch``), on ``device``."""
    from ..render import renderer as RD

    cam = RD.generate_cam({"fov": 60, "width_px": HW, "height_px": HW,
                           "mode": "circle", "n_imgs": n_views, "d": 0,
                           "r": 2.5, "center_angles": [90, 0]})
    rp = RD.get_rasterize_param_from_camera(cam, 60, super_sample_rate=1)
    rng = np.random.RandomState(seed)
    clouds = [_cloud(seed + 10 + i) for i in range(n_clouds)]
    shape = (n_clouds, n_views, HW, HW)

    def rep(x):
        return x[None].repeat(n_clouds, 1, *([1] * (x.dim() - 1)))

    batch = {
        "coords": torch.from_numpy(np.stack([c[0] for c in clouds])),
        "rgb": torch.from_numpy(np.stack([c[1] for c in clouds])),
        "valid": torch.ones((n_clouds, clouds[0][0].shape[0]), dtype=bool),
        "view_t": rep(rp["view_t"]), "full_t": rep(rp["full_t"]),
        "campos": rep(rp["campos"]),
        "gt_rgb": torch.from_numpy(rng.rand(*shape, 3).astype(np.float32)),
        "gt_normal": torch.from_numpy(
            (rng.rand(*shape, 3) * 2 - 1).astype(np.float32)),
        "gt_hit": torch.from_numpy(
            (rng.rand(*shape, 1) > 0.5).astype(np.float32)),
    }
    batch = {k: v.to(device) for k, v in batch.items()}
    batch["tanfov"] = rp["tanfov"]
    return batch


def _trainer(mesh, device):
    from ..train.trainer import Trainer

    return Trainer(INFO, render_hw=(HW, HW), device=device,
                   generator=torch.Generator().manual_seed(0),
                   learning_rate=1e-3, num_warmup_steps=0, mesh=mesh)


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check_training(n: int, device) -> float:
    """One dp x sp step against one process on the whole batch; returns
    the largest parameter difference."""
    import torch.distributed as dist

    from .sharding import make_mesh, replicate, shard_batch

    sp = 2 if n % 2 == 0 else 1
    mesh = make_mesh(sp=sp)
    batch = global_batch(mesh.shape["dp"], sp, device=device)
    trainer = _trainer(mesh, device)
    replicate(trainer.model, mesh)
    local = shard_batch({k: v for k, v in batch.items() if k != "tanfov"},
                        mesh)
    local["tanfov"] = batch["tanfov"]
    # one process on the whole batch (every rank checks it)
    ref = _trainer(None, device)
    # the summed gradients before the clip (which would hide a scale)
    for t, b in ((trainer, local), (ref, batch)):
        t.optimizer.zero_grad()
        t.loss_fn(b)[0].backward()
    trainer._all_reduce_grads()
    for (name, q), p in zip(ref.model.named_parameters(),
                            trainer.model.parameters()):
        dg = float((q.grad - p.grad).abs().max())
        _check(dg <= TRAIN_TOL * max(1.0, float(q.grad.abs().max())),
               f"summed gradient of {name} differs from one process's by "
               f"{dg}")
    metrics = trainer.train_step(local)
    ref_metrics = ref.train_step(batch)
    params = [p.detach() for p in trainer.model.parameters()]
    # the same parameters on every rank
    for p in params:
        first = p.clone()
        dist.broadcast(first, src=0)
        _check(torch.equal(first, p), "ranks hold different parameters")
    worst = 0.0
    for (name, q), p in zip(ref.model.named_parameters(), params):
        d = float((q.detach() - p).abs().max())
        worst = max(worst, d)
        _check(d <= TRAIN_TOL, f"dp x sp step differs from one process at "
               f"{name} by {d}")
    moved = sum(not torch.equal(p, q) for p, q in zip(
        params, _trainer(None, device).model.parameters()))
    _check(moved > 0, "the step moved no parameter")
    for k in ("loss", "rgb", "normal", "hit"):
        a, b = float(metrics[k]), float(ref_metrics[k])
        _check(abs(a - b) <= TRAIN_TOL * max(1.0, abs(b)),
               f"logged {k} {a} against one process's {b}")
    _check(int(metrics["dup_overflow"]) == int(ref_metrics["dup_overflow"]),
           "dup_overflow differs")
    return worst


def check_missing_grads(n: int, device) -> None:
    """The summed gradients keep one layout on every rank when a parameter
    has a gradient on some ranks only: rank 0 has none for ``a``, the
    others rank + 1; no rank has one for ``b``, which stays None."""
    from types import SimpleNamespace

    from ..train.trainer import Trainer
    from .sharding import make_mesh

    mesh = make_mesh()
    r = mesh.coords["dp"] * mesh.shape["sp"] + mesh.coords["sp"]
    a = torch.zeros(5, device=device, requires_grad=True)
    b = torch.zeros(3, device=device, requires_grad=True)
    if r > 0:
        a.grad = torch.full((5,), float(r + 1), device=device)
    Trainer._all_reduce_grads(SimpleNamespace(
        optimizer=SimpleNamespace(params=[a, b]), mesh=mesh))
    want = float(sum(range(2, n + 1)))
    if n == 1:  # no rank had one
        _check(a.grad is None, "a gradient no rank had was made")
    else:
        _check(a.grad is not None and bool((a.grad == want).all()),
               f"a gradient missing on rank 0: {a.grad} against {want}")
    _check(b.grad is None, "a gradient no rank had was made")


def render_inputs(q: int = 3, hw: int = RENDER_HW, seed: int = 2,
                  device="cpu"):
    """``render_views_fused``'s positional arguments for a seeded scene of
    gaussians (``__graft_entry__.py``'s) and q views on ``device``, and its
    keywords (x2 supersampling, with normals)."""
    from ..ops import rasterize as R
    from ..render import renderer as RD

    rng = np.random.RandomState(seed)
    npts, sh_deg = 128, 1
    cam = RD.generate_cam({"fov": 60, "width_px": hw // 2,
                           "height_px": hw // 2, "mode": "circle",
                           "n_imgs": q, "d": 0, "r": 2.5,
                           "center_angles": [90, 0]})
    rp = RD.get_rasterize_param_from_camera(cam, 60, sh_degree=sh_deg)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    args = (rp["view_t"], rp["full_t"], rp["campos"],
            t(rng.randn(npts, 3) * 0.5), t(rng.rand(npts, 3) * 0.05 + 0.01),
            t(rng.randn(npts, 4)), t(rng.rand(npts)),
            t(rng.rand(npts, (2 ** (sh_deg + 1)) * 3 + 1, 3)),
            t(rng.randn(npts, 3)), torch.ones(npts, dtype=bool),
            t([0.2, 0.3, 0.1]))
    args = tuple(a.to(device) for a in args) + (rp["tanfov"],)
    kw = dict(height=hw, width=hw, out_h=hw // 2, out_w=hw // 2,
              sh_degree=sh_deg,
              config=R.RasterizeConfig(max_dup_per_gaussian=16,
                                       chunk_size=32, tile_batch=4),
              with_normal=True)
    return args, kw


def check_rendering(n: int, device) -> float:
    """Both sharded render modes against ``render_views_fused``; returns
    the largest difference."""
    from ..render.renderer import render_views_fused, render_views_sharded
    from .sharding import make_mesh

    flat = make_mesh(sp=n)
    args, kw = render_inputs(device=device)
    ref = render_views_fused(*args, **kw)
    worst = 0.0
    for mode in ("views", "tiles"):
        got = render_views_sharded(flat, mode, *args, **kw)
        for k in ("rgb", "xyz_w", "hitmap", "normal"):
            _check(got[k].shape == ref[k].shape,
                   f"{mode}/{k}: shape {tuple(got[k].shape)}")
            d = float((got[k] - ref[k]).abs().max())
            worst = max(worst, d)
            _check(d <= RENDER_TOL, f"sharded {mode}/{k} differs by {d}")
        _check(torch.equal(got["dup_overflow"], ref["dup_overflow"]),
               f"sharded {mode} dup_overflow differs")
    return worst


def check_replicate(n: int, device) -> None:
    from .sharding import make_mesh, replicate

    mesh = make_mesh()
    r = mesh.coords["dp"] * mesh.shape["sp"] + mesh.coords["sp"]
    module = torch.nn.Linear(3, 2).to(device)
    with torch.no_grad():
        module.weight.fill_(float(r + 1))
    tensors = {"a": torch.full((4,), float(r), device=device),
               "b": [torch.arange(3, device=device) + r]}
    replicate(module, mesh)
    replicate(tensors, mesh)
    _check(bool((module.weight == 1.0).all()), "replicate: module weights")
    _check(bool((tensors["a"] == 0.0).all())
           and torch.equal(tensors["b"][0].cpu(), torch.arange(3)),
           "replicate: nested tensors")


def check_overflow(n: int, device) -> int:
    """Under a k_budget that cuts the windows differently (with more than
    one rank), the tile-sharded overflow is the MAX over the windows;
    returns it."""
    from ..ops import rasterize as R
    from ..ops import rasterize_stream as RS
    from .render import tile_sharded_core, window_of
    from .sharding import make_mesh

    flat = make_mesh(sp=n)
    args, kw = render_inputs(q=1, device=device)
    config = kw["config"]._replace(k_budget=32)
    features = torch.cat([args[7][:, 0], args[8]], dim=-1)  # any 6 channels
    settings = R.GaussianRasterizationSettings(
        image_height=RENDER_HW, image_width=RENDER_HW, tanfovx=args[11],
        tanfovy=args[11], bg=torch.zeros(6, device=device), scale_modifier=1.0,
        viewmatrix=args[0][0], projmatrix=args[1][0], sh_degree=0,
        campos=args[2][0])
    _, _, extra = R.rasterize_frame(
        tile_sharded_core(flat), args[3], args[6], settings, scales=args[4],
        rotations=args[5], colors_precomp=features, config=config,
        return_extra=True)
    ovf = extra["dup_overflow"]
    prep = R.preprocess(args[3], args[6], settings, config, scales=args[4],
                        rotations=args[5], colors_precomp=features)
    grid = RENDER_HW // 16
    each = [int(RS.blend_stream(prep, None, grid * grid, grid, config, 6,
                                *window_of(grid * grid, n, d))[2])
            for d in range(n)]
    # one rank's window is the whole grid: nothing to tell apart
    _check(n == 1 or len(set(each)) > 1,
           f"the windows' overflows are all {each}")
    _check(int(ovf) == max(each), f"overflow {int(ovf)}, windows {each}")
    return int(ovf)


def _worker(rank: int, n: int, init_method: str, device: str) -> None:
    from . import distributed

    torch.set_num_threads(1)
    if device == "cuda":  # one card per rank, as torchrun's LOCAL_RANK
        os.environ["LOCAL_RANK"] = str(rank)
    distributed.initialize(init_method=init_method, world_size=n, rank=rank,
                           backend="nccl" if device == "cuda" else "gloo")
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(
        "cpu")
    try:
        d_train = check_training(n, dev)
        check_missing_grads(n, dev)
        d_render = check_rendering(n, dev)
        check_replicate(n, dev)
        ovf = check_overflow(n, dev)
        if rank == 0:
            print(f"dryrun_multichip({n}, {device}): ok; dp x sp step within "
                  f"{d_train:.3e} of one process, sharded views + tiles "
                  f"within {d_render:.3e} of render_views_fused, tile-sharded "
                  f"overflow {ovf} = MAX of the windows", flush=True)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def dryrun_multichip(n: int, timeout: float = 600.0,
                     device: str = "cuda") -> None:
    """Run the checks in ``n`` spawned processes: one card each joined by
    ``nccl``, or with ``device="cpu"`` on the CPU joined by ``gloo``;
    raises if any rank fails or the world does not finish in ``timeout``
    seconds."""
    import torch.multiprocessing as mp

    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cuda' or 'cpu'")
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"dryrun_multichip({n}) on the card needs {n} cards, and "
            f"torch.cuda.device_count() is {torch.cuda.device_count()}; "
            f"pass device='cpu' (--device cpu) for gloo CPU processes")

    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        ctx = mp.start_processes(_worker, args=(n, init, device), nprocs=n,
                                 join=False, start_method="spawn")
        deadline = time.time() + timeout
        try:
            while not ctx.join(timeout=max(deadline - time.time(), 0.0)):
                if time.time() >= deadline:
                    raise TimeoutError(
                        f"dryrun_multichip({n}) did not finish in "
                        f"{timeout:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n, device=a.device)
