"""Checkpoint load/save and the JAX-params carry-over (port of
``gpcr_tpu/render/checkpoint.py``).

Params travel as the JAX package's nested dict of numpy arrays
(``params['color_encoder']['block0']['0']['conv0_0']['kernel']``), whose
flattened dotted keys are also the native ``.npz`` keys and the port's
``PCEncoder`` parameter names. MinkowskiEngine kernels are (K³, Cin, Cout)
and (Cin, Cout) for 1³ kernels, expanded to (1, Cin, Cout) here; the
offset order matches ``ops.sparse._offsets_cube``, so no permutation.
"""

from __future__ import annotations

import typing as T

import numpy as np
import torch
from torch import nn


def _nest(flat: T.Dict[str, np.ndarray]) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _flatten(params: dict, prefix: str = "") -> T.Dict[str, np.ndarray]:
    out = {}
    for k, v in params.items():
        key = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def convert_torch_state_dict(state: dict) -> dict:
    """Reference flat state dict -> nested numpy params."""
    flat = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        v = np.asarray(v, np.float32)
        if k.endswith("default_quaternion"):
            continue  # constant buffer, baked into the head
        if k.endswith(".kernel") and v.ndim == 2:
            v = v[None]  # 1³ kernel -> (1, Cin, Cout)
        flat[k] = v
    return _nest(flat)


def load_params(path: str, info=None) -> dict:
    """Nested numpy params from a native ``.npz`` or a reference ``.pth``
    (``torch.load`` with ``weights_only``: tensors and containers only, no
    code runs while unpickling)."""
    if path.endswith((".pth", ".pt")):
        state = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(state, dict) and "state_dict" in state:
            state = state["state_dict"]
        return convert_torch_state_dict(state)
    with np.load(path) as z:
        return _nest({k: z[k] for k in z.files})


def save_params(path: str, params: T.Union[dict, nn.Module]):
    """Write nested params (or a module's state dict) as a native .npz."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    np.savez(path, **_flatten(params))


def load_jax_params(module: nn.Module, params: dict) -> nn.Module:
    """Fill ``module`` (e.g. ``PCEncoder``) from a JAX-layout nested param
    dict of arrays; every key and shape must match."""
    flat = _flatten(params)
    own = module.state_dict()
    missing = sorted(set(own) - set(flat))
    unexpected = sorted(set(flat) - set(own))
    if missing or unexpected:
        raise KeyError(f"param mismatch: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")
    with torch.no_grad():
        for k, t in own.items():
            v = torch.from_numpy(np.array(flat[k], np.float32))  # a copy
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                                 f"{tuple(t.shape)}")
            t.copy_(v)
    return module


def grads_to_jax_tree(module: nn.Module) -> dict:
    """The module's ``.grad``s as a JAX-layout nested dict of numpy arrays
    (the inverse name mapping of ``load_jax_params``), to lay beside
    ``jax.grad``'s tree leaf by leaf. A parameter without a gradient gives
    zeros."""
    flat = {}
    for k, p in module.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        flat[k] = g.detach().cpu().numpy()
    return _nest(flat)


def lpips_from_jax_params(params: dict):
    """A ``metrics.lpips.LPIPS`` holding the JAX package's ``LPIPS.params``
    (its nested dict, handed over as numpy arrays: 'conv{i}' -> 'kernel' /
    'bias', 'lin{i}'), so that both packages score with the same weights."""
    from ..metrics.lpips import LPIPS

    return LPIPS(_nest({k: np.asarray(v, np.float32)
                        for k, v in _flatten(params).items()}))
