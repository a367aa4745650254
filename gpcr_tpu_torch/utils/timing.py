"""Device-synchronised timing.

``sync`` waits for every kernel queued on the tensors' device (a
``torch.cuda.synchronize`` for CUDA tensors, nothing on the CPU, where
PyTorch runs eagerly), so a host clock read after it measures the work
and not the enqueue.
"""

from __future__ import annotations

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

