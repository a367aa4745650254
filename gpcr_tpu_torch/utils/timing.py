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


def device_label(device) -> str:
    """What a timing was taken on: for a CUDA device the card's name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` gives them (a card set below its maximum
    power runs slower under load), else the device's type."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    import subprocess

    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name(dev)}, power limit not read ({e})"
    if smi.returncode != 0 or not smi.stdout.strip():
        return (f"{torch.cuda.get_device_name(dev)}, power limit not read "
                f"(nvidia-smi exit {smi.returncode})")
    return smi.stdout.strip().splitlines()[0].strip()
