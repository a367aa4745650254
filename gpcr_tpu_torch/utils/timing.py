"""Device-synchronised timing.

``sync`` waits for every kernel queued on the tensors' device (a
``torch.cuda.synchronize`` for CUDA tensors, nothing on the CPU, where
PyTorch runs eagerly), so a host clock read after it measures the work
and not the enqueue; ``timed`` runs a function with warmup and returns
its median host-clock time.
"""

from __future__ import annotations

import time
import typing as T

import numpy as np
import torch


def _first_device(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            dev = _first_device(leaf)
            if dev is not None:
                return dev
    return None


def sync(tree) -> None:
    """Wait until the work that produced ``tree`` (tensors, or nested
    lists / tuples / dicts of them) has finished on its device."""
    dev = _first_device(tree)
    if dev is not None and torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn: T.Callable, *args, warmup: int = 1, iters: int = 5, **kwargs):
    """Run ``fn(*args, **kwargs)`` ``warmup`` times, then ``iters`` timed
    times, each waited for on its device. Returns (median ms, all ms,
    last output)."""
    out = None
    for _ in range(max(warmup, 0)):
        out = fn(*args, **kwargs)
        sync(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(out)
        times.append((time.perf_counter() - t0) * 1000.0)
    return float(np.median(times)), times, out
