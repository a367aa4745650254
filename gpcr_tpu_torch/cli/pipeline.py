"""Evaluation pipeline steps as in-process calls (port of
``gpcr_tpu/cli/pipeline.py``): voxel <-> world rescaling of a PLY, the
three directory scorers, difference maps, and one call that scores a
render / ground-truth directory pair.

Two behaviours of the reference are kept: ``rescale_run`` takes
``input_offset`` and ignores it, and ``save_difference_map`` writes every
batch element of view ``iq`` to the same ``diff/rgb_{iq}.png`` (the last
one stays). The scorers run on ``device`` (default ``cuda``).
"""

from __future__ import annotations

import os
import typing as T

import numpy as np

from ..io.image import write_png
from . import pic_metrics, rescale_ply


def rescale_run(input, output, factor, input_offset=0.0, offset=512,
                show=False):
    """Voxel -> world: (xyz - offset) / factor."""
    if show:
        print(f"rescale {input} -> {output} factor={factor} offset={offset}")
    rescale_ply.rescale(input, output, offset=offset, factor=factor)


def scale_run(input, output, factor, show=False):
    """World -> voxel: xyz * factor."""
    if show:
        print(f"scale {input} -> {output} factor={factor}")
    rescale_ply.rescale(input, output, offset=0.0, factor=factor, inverse=True)


def psnr_run(p1, p2, show=False, device="cuda"):
    return pic_metrics.psnr_dirs(p1, p2, device=device)


def msssim_run(p1, p2, show=False, device="cuda"):
    return pic_metrics.msssim_dirs(p1, p2, device=device)


def lpips_run(p1, p2, show=False, device="cuda"):
    return pic_metrics.lpips_dirs(p1, p2, device=device)


def save_difference_map(gt_rgb, rgb, save_pth: str):
    """(gt - render + 1) * 128 difference images of (b, q, h, w, 3) float
    batches (arrays or tensors) into ``<save_pth>/diff/rgb_{iq}.png``."""
    os.makedirs(os.path.join(save_pth, "diff"), exist_ok=True)
    gt_rgb, rgb = _host(gt_rgb), _host(rgb)
    b, q = gt_rgb.shape[:2]
    for ib in range(b):
        for iq in range(q):
            img = np.clip((gt_rgb[ib, iq] - rgb[ib, iq] + 1.0) * 128.0, 0, 255)
            write_png(os.path.join(save_pth, "diff", f"rgb_{iq}.png"),
                      img.astype(np.uint8))


def evaluate_pair(render_dir: str, gt_dir: str,
                  device="cuda") -> T.Dict[str, T.Optional[float]]:
    """PSNR, MS-SSIM and LPIPS (None without its weights) of one
    render / ground-truth directory pair."""
    return {
        "psnr": pic_metrics.psnr_dirs(render_dir, gt_dir, device=device),
        "ms_ssim": pic_metrics.msssim_dirs(render_dir, gt_dir, device=device),
        "lpips": pic_metrics.lpips_dirs(render_dir, gt_dir, device=device),
    }


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
