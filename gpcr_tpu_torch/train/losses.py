"""Training losses (port of ``gpcr_tpu/train/losses.py``).

The deployed loss configuration (the checkpoint's options.yaml,
optim_info): l1 rgb (weight 0.01), normal l2 (weight 10 x 1.0), hit focal
loss (alpha 0.5, gamma 2, weight 0.01).
"""

from __future__ import annotations

import typing as T

import torch


def l1(pred, gt, mask=None):
    d = torch.abs(pred - gt)
    if mask is not None:
        return torch.sum(d * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(d)


def l2(pred, gt, mask=None):
    d = (pred - gt) ** 2
    if mask is not None:
        return torch.sum(d * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(d)


def focal_bce(pred, gt, alpha: float = 0.5, gamma: float = 2.0, eps=1e-6):
    """Focal binary cross-entropy on hit probabilities."""
    p = torch.clamp(pred, eps, 1.0 - eps)
    pos = -alpha * ((1 - p) ** gamma) * torch.log(p)
    neg = -(1 - alpha) * (p ** gamma) * torch.log(1 - p)
    return torch.mean(torch.where(gt > 0.5, pos, neg))


class LossWeights(T.NamedTuple):
    """Deployed weights (options.yaml optim_info)."""

    rgb: float = 0.01
    normal: float = 10.0
    normal_l2: float = 1.0
    hit: float = 0.01
    dc: float = 1.0
    t: float = 0.01
    focal_alpha: float = 0.5
    focal_gamma: float = 2.0


def render_losses(
    out: dict,  # renderer outputs: rgb/normal/hitmap (q, h, w, 3)
    gt: dict,  # gt images: rgb, normal_w, hit_map
    weights: LossWeights = LossWeights(),
    view_share: float = 1.0,
    mask_total=None,
):
    """Weighted total + per-term dict.

    A rank that holds ``view_share`` of a cloud's views (view-parallel
    training) gets its part of the cloud's loss, so that the parts over
    the ranks sum to the loss of all views: the means are scaled by
    ``view_share``, and the masked normal term is divided by the hit count
    of all views, ``mask_total``, instead of this rank's."""
    hit_gt = gt["hit_map"]
    if hit_gt.dim() == out["hitmap"].dim() - 1:
        hit_gt = hit_gt[..., None]
    terms = {}
    terms["rgb"] = l1(out["rgb"], gt["rgb"]) * view_share
    if out.get("normal") is not None and gt.get("normal_w") is not None:
        # normals only matter where the surface is hit
        if mask_total is None:
            normal = l2(out["normal"], gt["normal_w"], mask=hit_gt)
        else:
            normal = (torch.sum((out["normal"] - gt["normal_w"]) ** 2 * hit_gt)
                      / torch.clamp(mask_total, min=1.0))
        terms["normal"] = weights.normal_l2 * normal
    terms["hit"] = focal_bce(
        torch.clamp(out["hitmap"][..., :1], 0.0, 1.0),
        hit_gt,
        alpha=weights.focal_alpha,
        gamma=weights.focal_gamma,
    ) * view_share
    total = (
        weights.rgb * terms["rgb"]
        + weights.normal * terms.get("normal", 0.0)
        + weights.hit * terms["hit"]
    )
    return total, terms
