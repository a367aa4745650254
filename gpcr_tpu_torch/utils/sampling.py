"""Sampling utilities (port of ``gpcr_tpu/utils/sampling.py``): dtype
maps, random / Latin-hypercube samples (host numpy, the same arrays as
JAX), per-slice shuffles and the von Mises-Fisher distribution on S²
(torch, on the device of their inputs; draws from a ``torch.Generator``
where JAX takes a key)."""

from __future__ import annotations

import math

import numpy as np
import torch


def get_np_dtype(dtype) -> np.dtype:
    """numpy dtype of a numpy / torch dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(str(dtype).replace("torch.", ""))
    return np.dtype(dtype)


def get_torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy / torch dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, get_np_dtype(dtype))).dtype


def get_samples(
    n: int, d: int, method: str = "random", seed: int = 0,
    low=0.0, high=1.0,
) -> np.ndarray:
    """(n, d) float32 samples in [low, high): 'random' or
    'latin_hypercube' QMC."""
    if method == "random":
        rng = np.random.RandomState(seed)
        u = rng.rand(n, d)
    elif method in ("latin_hypercube", "lhs", "qmc"):
        from scipy.stats import qmc

        u = qmc.LatinHypercube(d=d, seed=seed).random(n=n)
    else:
        raise NotImplementedError(method)
    return (np.asarray(low) + u * (np.asarray(high) - np.asarray(low))).astype(
        np.float32)


def shuffle_along_axis(generator: torch.Generator, a: torch.Tensor,
                       axis: int = 0) -> torch.Tensor:
    """An independent permutation of every slice along ``axis``;
    ``generator`` lives on ``a``'s device."""
    u = torch.rand(a.shape, generator=generator, device=a.device)
    return torch.take_along_dim(a, u.argsort(dim=axis), dim=axis)


class SphericalGaussian:
    """von Mises-Fisher distribution on S² with concentration ``kappa``."""

    def __init__(self, kappa: float):
        self.kappa = float(kappa)

    def log_prob(self, mu: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """log vMF density: log C(κ) + κ·muᵀx, with C(κ) = κ / (2π (e^κ −
        e^−κ)) in a log-stable form (float32, as in JAX)."""
        k = torch.tensor(self.kappa, dtype=torch.float32, device=mu.device)
        log_c = (torch.log(k) - math.log(2 * math.pi) - k
                 - torch.log1p(-torch.exp(-2 * k)))
        return log_c + k * torch.sum(mu * x, dim=-1)

    def nll(self, mu: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return -self.log_prob(mu, x)

    def direction(self, u: torch.Tensor, phi: torch.Tensor,
                  mu: torch.Tensor) -> torch.Tensor:
        """The sample of uniforms u in (0, 1] and φ in [0, 2π): w = cos of
        the angle to the mean by the inverse CDF of the vMF marginal, w =
        1 + log(u + (1 - u) e^{-2κ}) / κ, azimuth φ around +z, then the
        minimal rotation of +z onto mu (*, 3)."""
        from .rigid_motion import get_min_R

        k = self.kappa
        w = 1.0 + torch.log(u + (1.0 - u) * math.exp(-2.0 * k)) / k
        s = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
        v_local = torch.stack([s * torch.cos(phi), s * torch.sin(phi), w],
                              dim=-1)
        z = torch.tensor([0.0, 0.0, 1.0], dtype=mu.dtype,
                         device=mu.device).expand(mu.shape)
        R = get_min_R(z, mu)
        return (R @ v_local[..., None])[..., 0]

    def sample(self, generator: torch.Generator,
               mu: torch.Tensor) -> torch.Tensor:
        """One direction around each mean mu (*, 3); ``generator`` lives on
        mu's device."""
        kw = dict(generator=generator, device=mu.device, dtype=mu.dtype)
        shape = mu.shape[:-1]
        u = 1e-7 + (1.0 - 1e-7) * torch.rand(shape, **kw)
        phi = 2 * math.pi * torch.rand(shape, **kw)
        return self.direction(u, phi, mu)
