"""Training step for the learned splat renderer (port of
``gpcr_tpu/train/trainer.py``).

End-to-end differentiable quantize -> SparseUNet -> differentiable stream
rasterizer (``ops/rasterize_stream_vjp.py``: contributor-count forward and
replay-backward kernels) -> image losses. The JAX package's ``vmap``s over
clouds and views are Python loops here.

On a ('dp', 'sp') ``parallel.sharding`` mesh each rank takes its slice of
the global batch (``shard_batch``: clouds over dp, views over sp) and the
loss of its (cloud, view) pairs, weighted by their share of the global
batch, so that the SUM of the ranks' gradients is the gradient of the
global mean loss that JAX's sharded step takes; the gradients are summed
over all ranks before the clip and the Adam step, which every rank then
takes on the same values.

The optimizer reproduces the JAX package's optax chain
(clip_by_global_norm -> adam with a linear-warmup schedule) exactly: the
schedule is read at the update count BEFORE it is incremented, so the
first update has learning rate 0, and the clip is
``g * clip / max(|g|, clip)``.
"""

from __future__ import annotations

import typing as T

import torch

from ..models.encoder import PCEncoder, PCMLInfo, assemble_input_features
from ..ops import rasterize as R
from ..ops import sparse
from ..render.renderer import pin_fp32, render_views_fused, world_splats
from . import losses as L


class WarmupClipAdam:
    """Global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8, no weight
    decay) at a learning rate that rises linearly from 0 over
    ``num_warmup_steps`` updates and then stays at ``learning_rate``."""

    def __init__(self, params, learning_rate: float = 1e-5,
                 num_warmup_steps: int = 4000, clip: float = 1.0):
        self.params = list(params)
        self.learning_rate = learning_rate
        self.num_warmup_steps = num_warmup_steps
        self.clip = clip
        self.count = 0  # updates taken
        self.adam = torch.optim.Adam(self.params, lr=learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)

    def lr_at(self, count: int) -> float:
        if self.num_warmup_steps <= 0:
            return self.learning_rate
        frac = min(max(count / self.num_warmup_steps, 0.0), 1.0)
        return self.learning_rate * frac

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                                  for g in grads))
            factor = self.clip / torch.clamp(norm, min=self.clip)
            for g in grads:
                g.mul_(factor)
        lr = self.lr_at(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict):
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_optimizer(params, learning_rate: float = 1e-5,
                   num_warmup_steps: int = 4000,
                   clip: float = 1.0) -> WarmupClipAdam:
    """adam + linear warmup + grad clip (options.yaml optim_info)."""
    return WarmupClipAdam(params, learning_rate, num_warmup_steps, clip)


class Trainer:
    def __init__(
        self,
        info: T.Union[dict, PCMLInfo],
        render_hw: T.Tuple[int, int] = (64, 64),
        super_sample_rate: int = 1,
        weights: L.LossWeights = L.LossWeights(),
        raster_config: T.Optional[R.RasterizeConfig] = None,
        offset: int = 512,
        model: T.Optional[PCEncoder] = None,
        device="cuda",
        generator: T.Optional[torch.Generator] = None,
        learning_rate: float = 1e-5,
        num_warmup_steps: int = 4000,
        clip: float = 1.0,
        mesh=None,
    ):
        self.info = (info if isinstance(info, PCMLInfo)
                     else PCMLInfo.from_dict(info))
        self.device = torch.device(device)
        if model is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            model = PCEncoder(self.info, generator=generator)
        self.model = model.to(self.device).train()
        self.render_hw = render_hw
        self.ss = super_sample_rate
        self.weights = weights
        self.offset = offset
        # the differentiable path goes through the replay-kernel backward:
        # no chunk truncation. k_budget / max_active_tiles stay None (the
        # budgets are workload-specific; pass a raster_config to set them)
        self.config = raster_config or R.RasterizeConfig(
            max_dup_per_gaussian=16, chunk_size=64, tile_batch=8,
            differentiable=True)
        self.optimizer = make_optimizer(
            self.model.parameters(), learning_rate, num_warmup_steps, clip)
        self.step_count = 0
        # None: one process holding the whole batch; so is a mesh without
        # a process group (1 x 1), whose collectives would only copy
        self.mesh = mesh if mesh is not None and mesh.world is not None \
            else None

    # ---- forward ---------------------------------------------------------

    def _encode_splats(self, coords, rgb, valid):
        """Quantize one cloud, run the network and turn its output into
        world-space splats (``world_splats``)."""
        feats = assemble_input_features(self.info, coords, rgb, self.offset)
        grid = sparse.quantize_average(coords, feats, valid=valid)
        sp = self.model(grid, self.model.build_plan(grid))
        return world_splats(sp, self.offset, self.info.scale_factor)

    def _per_cloud_render(self, coords, rgb, valid, view_t, full_t, campos,
                          tanfov):
        """Encode one cloud and render every view
        (``render_views_fused``); returns its out dict with (V, h, w, C)
        images plus 'dup_overflow' (V,)."""
        splats = self._encode_splats(coords, rgb, valid)
        h, w = self.render_hw
        return render_views_fused(
            view_t, full_t, campos, *splats[:7],
            torch.zeros((3,), device=splats.means.device), tanfov,
            height=h * self.ss, width=w * self.ss, out_h=h, out_w=w,
            sh_degree=self.info.sh_deg, config=self.config,
            with_normal=splats.with_normal)

    def _per_cloud_loss(self, coords, rgb, valid, view_t, full_t, campos,
                        gt_rgb, gt_normal, gt_hit, tanfov, view_share=1.0,
                        mask_total=None):
        out = self._per_cloud_render(
            coords, rgb, valid, view_t, full_t, campos, tanfov)
        gt = {"rgb": gt_rgb, "normal_w": gt_normal, "hit_map": gt_hit}
        total, terms = L.render_losses(out, gt, self.weights, view_share,
                                       mask_total)
        return total, terms, out["dup_overflow"]

    def loss_fn(self, batch: dict):
        """batch: coords/rgb/valid (B, N, ·); view_t/full_t (B, V, 4, 4);
        campos (B, V, 3); gt_rgb/gt_normal (B, V, h, w, 3);
        gt_hit (B, V, h, w, 1); tanfov scalar. Returns (mean total, mean
        terms); the dropped splat-tile entries of the batch are left in
        ``self.last_dup_overflow``.

        On a mesh, ``batch`` is this rank's slice (``shard_batch``) and the
        results are this rank's part of the global means: the sum over
        the ranks is the global mean."""
        pin_fp32()
        b = batch["coords"].shape[0]
        dp, sp = ((self.mesh.shape["dp"], self.mesh.shape["sp"])
                  if self.mesh is not None else (1, 1))
        mask_total = None
        if sp > 1:
            # the normal term's hit count over all views of each cloud
            mask_total = self.mesh.all_reduce(
                batch["gt_hit"].reshape(b, -1).sum(1), "sum", ("sp",))
        totals, terms_all, overflow = [], [], []
        for ib in range(b):
            total, terms, ovf = self._per_cloud_loss(
                batch["coords"][ib], batch["rgb"][ib], batch["valid"][ib],
                batch["view_t"][ib], batch["full_t"][ib], batch["campos"][ib],
                batch["gt_rgb"][ib], batch["gt_normal"][ib],
                batch["gt_hit"][ib], float(batch["tanfov"]),
                view_share=1.0 / sp,
                mask_total=None if mask_total is None else mask_total[ib],
            )
            totals.append(total)
            terms_all.append(terms)
            overflow.append(ovf.sum())
        self.last_dup_overflow = torch.stack(overflow).sum()
        n = b * dp  # clouds in the global batch
        part_terms = {k: torch.stack([t[k] for t in terms_all]).sum() / n
                      for k in terms_all[0]}
        return torch.stack(totals).sum() / n, part_terms

    @torch.no_grad()
    def eval_psnr(self, batch: dict) -> torch.Tensor:
        """Render every (cloud, view) of a batch and score the PSNR of the
        rgb channels against the ray-cast ground truth."""
        pin_fp32()
        psnrs = []
        for ib in range(batch["coords"].shape[0]):
            out = self._per_cloud_render(
                batch["coords"][ib], batch["rgb"][ib], batch["valid"][ib],
                batch["view_t"][ib], batch["full_t"][ib], batch["campos"][ib],
                float(batch["tanfov"]))
            mse = torch.mean((out["rgb"] - batch["gt_rgb"][ib]) ** 2)
            psnrs.append(-10.0 * torch.log10(torch.clamp(mse, min=1e-10)))
        return torch.mean(torch.stack(psnrs))

    # ---- update ----------------------------------------------------------

    def train_step(self, batch: dict) -> dict:
        """One optimizer update. Returns detached 0-dim tensors: 'loss',
        the loss terms and 'dup_overflow' (reading them synchronises)."""
        self.optimizer.zero_grad()
        total, terms = self.loss_fn(batch)
        total.backward()
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in terms.items()}}
        if self.mesh is not None:
            self._all_reduce_grads()
            # every rank logs the global metrics
            keys = list(metrics)
            summed = self.mesh.all_reduce(torch.stack(
                [metrics[k].to(torch.float32) for k in keys]))
            metrics = dict(zip(keys, summed.unbind()))
            self.last_dup_overflow = self.mesh.all_reduce(
                self.last_dup_overflow.clone())
        self.optimizer.step()
        self.step_count += 1
        metrics["dup_overflow"] = self.last_dup_overflow
        return metrics

    def _all_reduce_grads(self):
        """Sum the gradients over all ranks, in one flat buffer laid out
        over every parameter, so that every rank reduces the same layout
        (zeros where this rank has no gradient). A count per parameter
        rides along: a parameter that no rank gave a gradient keeps None,
        as it would in one process."""
        params = self.optimizer.params
        parts = [p.grad.reshape(-1) if p.grad is not None
                 else torch.zeros(p.numel(), dtype=p.dtype, device=p.device)
                 for p in params]
        parts.append(torch.tensor([float(p.grad is not None) for p in params],
                                  dtype=params[0].dtype,
                                  device=params[0].device))
        flat = self.mesh.all_reduce(torch.cat(parts))
        *summed, seen = flat.split([p.numel() for p in params] + [len(params)])
        for i, (p, part) in enumerate(zip(params, summed)):
            if p.grad is not None:
                p.grad.copy_(part.view_as(p))
            elif float(seen[i]) > 0:  # reads the count only where needed
                p.grad = part.view_as(p).clone()


# ---- train-state checkpointing (render/checkpoint.py handles bare model
# params; these add optimizer state + step for resume) ----------------------


def save_train_state(path: str, trainer: Trainer):
    """One ``torch.save`` of model, optimizer and step: tensors, numbers
    and plain containers only, so it loads with ``weights_only=True``."""
    torch.save({
        "model": trainer.model.state_dict(),
        "optimizer": trainer.optimizer.state_dict(),
        "step": trainer.step_count,
    }, path)


def load_train_state(path: str, trainer: Trainer) -> int:
    """Restore a snapshot into a freshly built ``trainer`` of the same
    model config; returns the step."""
    state = torch.load(path, map_location=trainer.device, weights_only=True)
    trainer.model.load_state_dict(state["model"])
    trainer.optimizer.load_state_dict(state["optimizer"])
    trainer.step_count = int(state["step"])
    return trainer.step_count
