"""Learnable per-channel RGB gain (port of
``gpcr_tpu/structures/color_corrector.py``): the JAX ``init()`` /
``apply(params, x)`` pair becomes the module's ``wrgb`` parameter and
``forward(x)``."""

from __future__ import annotations

import torch
from torch import nn


class ColorCorrector(nn.Module):
    def __init__(self, correction_type: str = "wrgb", device="cuda"):
        super().__init__()
        if correction_type not in ("wrgb", "identify"):
            raise NotImplementedError(correction_type)
        self.correction_type = correction_type
        self.wrgb = nn.Parameter(torch.ones((3,), dtype=torch.float32,
                                            device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (..., 3) times the gain; "identify" is the identity."""
        if self.correction_type == "wrgb":
            return x * self.wrgb.reshape(*([1] * (x.dim() - 1)), -1)
        return x
