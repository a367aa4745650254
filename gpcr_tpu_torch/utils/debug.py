"""Debug instrumentation (port of ``gpcr_tpu/utils/debug.py``):

- ``snapshot_on_error``: wrap a function; on any exception, write its
  tensor and array arguments to an ``.npz`` for an offline repro, then
  re-raise;
- ``check_finite``: raise (optionally) on NaN / Inf anywhere in nested
  tensors, arrays, lists, tuples, dicts and dataclasses; the check the
  rasterizer runs when its settings ask for ``debug``;
- ``trace``: a ``torch.profiler`` context over CPU and CUDA activities
  that writes a Chrome trace into its directory.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import tempfile
import typing as T

import numpy as np
import torch


def _leaves(tree) -> T.Iterator:
    """The leaves of nested lists / tuples / dicts / dataclasses, in
    order (dict values in insertion order)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif tree is not None:
        yield tree


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def snapshot_on_error(fn: T.Callable, path: str = "snapshot_fw.npz"):
    """On an exception in ``fn``, save every tensor / array argument as
    ``arg_<i>`` of ``path`` and re-raise."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            flat = {f"arg_{i}": _host(leaf)
                    for i, leaf in enumerate(_leaves((args, kwargs)))
                    if isinstance(leaf, (torch.Tensor, np.ndarray))}
            np.savez(path, **flat)
            print(f"\nAn error occurred in {fn.__name__}. Inputs were written "
                  f"to {path}.\nPlease attach the snapshot when reporting.")
            raise

    return wrapped


def check_finite(tree, name: str = "", raise_on_fail: bool = True) -> bool:
    """True if every floating-point leaf is finite; else False, or a
    FloatingPointError naming the leaves at fault. Waits for the device
    (one host read per leaf)."""
    bad = []
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                bad.append((i, tuple(leaf.shape)))
        elif hasattr(leaf, "dtype") and np.issubdtype(leaf.dtype, np.floating):
            arr = np.asarray(leaf)
            if not np.isfinite(arr).all():
                bad.append((i, arr.shape))
    if bad and raise_on_fail:
        raise FloatingPointError(f"non-finite values in {name}: leaves {bad}")
    return not bad


@contextlib.contextmanager
def trace(log_dir: T.Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    card is present) and write ``<log_dir>/trace.json``, a Chrome trace
    (chrome://tracing, Perfetto). Yields ``log_dir`` (default
    ``$TMPDIR/gpcr_trace``)."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "gpcr_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
