"""PSNR, both conventions of the reference (port of
``gpcr_tpu/metrics/psnr.py``).

- ``psnr``: [0, 1]-range images, 10 log10(1 / mse);
- ``psnr255``: 0-255 images, 20 log10(255) - 10 log10(mse) (what the
  directory scorer prints).
Differentiable torch functions; they run on the device of their inputs.
"""

from __future__ import annotations

import math

import torch


def psnr(rgb: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((rgb[..., :3] - gts[..., :3]) ** 2)
    return 10.0 * torch.log10(1.0 / mse)


def psnr255(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """img1 / img2: 0-255 scale (any float or integer dtype)."""
    diff = img1.to(torch.float32) - img2.to(torch.float32)
    mse = torch.mean(diff ** 2)
    return 20.0 * math.log10(255.0) - 10.0 * torch.log10(mse)
