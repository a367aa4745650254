"""LPIPS with the AlexNet backbone (port of ``gpcr_tpu/metrics/lpips.py``).

The full LPIPS forward (Zhang et al. 2018): input normalisation (shift /
scale), the AlexNet conv stack tapped after relu1..relu5, per-location
channel unit-normalisation, squared difference, learned non-negative 1x1
heads, spatial mean, sum over taps. NOTE the reference's scorer feeds 0-255
images straight into a model that expects [-1, 1]; the directory scorer
reproduces that when asked for strict parity.

Weights are NOT in the repository. ``LPIPS.load`` reads them from an
``.npz`` in the JAX package's layout (``conv{i}/kernel``, ``conv{i}/bias``,
``lin{i}``), as written by ``convert_lpips_pth`` from an
``lpips.LPIPS(net='alex')`` state dict. ``lpips_available()`` says whether
the file is there; callers skip the metric, and say so, when it is not.
"""

from __future__ import annotations

import os
import typing as T

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (out_ch, in_ch, k, stride, pad) of torchvision's alexnet.features convs
_ALEX_CONVS = [
    (64, 3, 11, 4, 2),
    (192, 64, 5, 1, 2),
    (384, 192, 3, 1, 1),
    (256, 384, 3, 1, 1),
    (256, 256, 3, 1, 1),
]
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights", "lpips_alex.npz",
)


def lpips_available(path: str = DEFAULT_WEIGHTS) -> bool:
    return os.path.exists(path)


class LPIPS(nn.Module):
    """``params``: {'conv{i}': {'kernel': (O, I, kh, kw), 'bias': (O,)},
    'lin{i}': (1, C, 1, 1) non-negative} for i in 0..4, arrays or tensors
    (the JAX ``LPIPS.params`` as numpy arrays fit as they are)."""

    def __init__(self, params: dict):
        super().__init__()
        self.register_buffer("shift", torch.tensor(_SHIFT).reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).reshape(1, 3, 1, 1))
        for i in range(len(_ALEX_CONVS)):
            for name, value in (
                    (f"conv{i}_kernel", params[f"conv{i}"]["kernel"]),
                    (f"conv{i}_bias", params[f"conv{i}"]["bias"]),
                    (f"lin{i}", params[f"lin{i}"])):
                # np.array copies: a buffer must own writable memory
                self.register_buffer(name, torch.from_numpy(
                    np.array(value, np.float32)))

    @staticmethod
    def load(path: str = DEFAULT_WEIGHTS) -> "LPIPS":
        if path.endswith((".pth", ".pt")):
            raise ValueError("convert torch weights with convert_lpips_pth")
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        params: dict = {}
        for k, v in flat.items():
            if "/" in k:
                a, b = k.split("/")
                params.setdefault(a, {})[b] = v
            else:
                params[k] = v
        return LPIPS(params)

    def _features(self, x):
        """x: (N, 3, H, W) in [-1, 1]."""
        x = (x - self.shift) / self.scale
        taps = []
        for i, (_, _, _, s, p) in enumerate(_ALEX_CONVS):
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_kernel"),
                                getattr(self, f"conv{i}_bias"), stride=s,
                                padding=p))
            taps.append(x)
            if i in (0, 1):  # maxpool k3 s2 after relu1 / relu2
                x = F.max_pool2d(x, 3, 2)
        return taps

    def forward(self, img1, img2):
        """img1 / img2: (N, 3, H, W) in [-1, 1] (or whatever the caller
        feeds: strict parity feeds 0-255). Returns (N,)."""
        dev = self.shift.device
        f1 = self._features(torch.as_tensor(img1, dtype=torch.float32,
                                            device=dev))
        f2 = self._features(torch.as_tensor(img2, dtype=torch.float32,
                                            device=dev))
        total = 0.0
        for i, (a, b) in enumerate(zip(f1, f2)):
            a = a / torch.sqrt(torch.sum(a ** 2, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b ** 2, dim=1, keepdim=True) + 1e-10)
            d = (a - b) ** 2
            lin = getattr(self, f"lin{i}").reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * lin, dim=1), dim=(-2, -1))
        return total


def convert_lpips_state_dict(sd: T.Dict[str, T.Any]) -> T.Dict[str, np.ndarray]:
    """Map an ``lpips.LPIPS(net='alex')`` state dict to the npz layout. The
    package registers the backbone as
    ``net.slice{1..5}.<features_idx>.{weight,bias}`` (features conv indices
    0/3/6/8/10) and the heads as ``lins.{i}.model.1.weight``."""

    def host(v):
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    flat = {}
    conv_idx = [0, 3, 6, 8, 10]
    for i, li in enumerate(conv_idx):
        flat[f"conv{i}/kernel"] = host(sd[f"net.slice{i+1}.{li}.weight"])
        flat[f"conv{i}/bias"] = host(sd[f"net.slice{i+1}.{li}.bias"])
    for i in range(5):
        flat[f"lin{i}"] = host(sd[f"lins.{i}.model.1.weight"])
    return flat


def convert_torch_lpips(lpips_module) -> T.Dict[str, np.ndarray]:
    """The npz layout of a torch ``lpips.LPIPS(net='alex')`` module's
    weights; save it with ``np.savez(path, **flat)``."""
    return convert_lpips_state_dict(lpips_module.state_dict())


def convert_lpips_pth(pth_path: str, out_path: str = DEFAULT_WEIGHTS) -> str:
    """Read an ``lpips`` .pth state dict (bare or under 'state_dict') with
    ``torch.load(weights_only=True)``, map it to the npz layout and save
    it. Returns ``out_path``."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"expected a state dict in {pth_path}")
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    flat = convert_lpips_state_dict(sd)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(out_path, **flat)
    return out_path


def random_lpips(generator: T.Optional[torch.Generator] = None) -> LPIPS:
    """Random-weight LPIPS (architecture testing only, NOT a valid metric);
    ``generator`` defaults to ``torch.Generator().manual_seed(0)``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = {}
    for i, (o, c, k, _, _) in enumerate(_ALEX_CONVS):
        params[f"conv{i}"] = {
            "kernel": torch.randn(o, c, k, k, generator=generator)
            * (2.0 / (c * k * k)) ** 0.5,
            "bias": torch.zeros(o),
        }
        params[f"lin{i}"] = torch.randn(1, o, 1, 1,
                                        generator=generator).abs() * 0.01
    return LPIPS(params)
