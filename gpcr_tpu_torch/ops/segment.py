"""Segment reductions (port of ``gpcr_tpu/ops/segment.py``) via
``index_add_``."""

from __future__ import annotations

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    total = segment_sum(data, segment_ids, num_segments)
    count = segment_sum(
        torch.ones(data.shape[:1], dtype=data.dtype, device=data.device),
        segment_ids, num_segments)
    return total / torch.clamp(count, min=1.0).reshape(
        -1, *([1] * (data.dim() - 1)))
