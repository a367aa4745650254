"""Segment reductions (port of ``gpcr_tpu/ops/segment.py``): sum and
mean via ``index_add_``, max and min via ``scatter_reduce_``."""

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


def _segment_extreme(data, segment_ids, num_segments, reduce):
    """``scatter_reduce_`` into a tensor filled with the reduction's
    identity, so an empty segment holds what JAX gives it: -inf / +inf
    for floats, the integer type's min / max for ints."""
    if data.dtype.is_floating_point:
        fill = float("-inf") if reduce == "amax" else float("inf")
    else:
        info = torch.iinfo(data.dtype)
        fill = info.min if reduce == "amax" else info.max
    out = torch.full((num_segments, *data.shape[1:]), fill, dtype=data.dtype,
                     device=data.device)
    idx = segment_ids.long().reshape(-1, *([1] * (data.dim() - 1)))
    return out.scatter_reduce_(0, idx.expand_as(data), data, reduce,
                               include_self=False)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amax")


def segment_min(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    return _segment_extreme(data, segment_ids, num_segments, "amin")
