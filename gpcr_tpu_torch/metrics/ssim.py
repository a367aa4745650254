"""SSIM and MS-SSIM (port of ``gpcr_tpu/metrics/ssim.py``).

- SSIM (Wang et al. 2004): gaussian window 11x11 sigma 1.5, K1 = 0.01, K2 =
  0.03, luminance x contrast-structure over 'valid' windows (borders
  cropped). ``sample_covariance=True`` gives skimage's N / (N - 1)
  covariance normalisation, False pytorch_msssim's.
- MS-SSIM (Wang et al. 2003): 5 scales, weights (0.0448, 0.2856, 0.3001,
  0.2363, 0.1333), 2x average pool between scales (odd edges padded with
  zeros, as ``F.avg_pool2d(padding=shape % 2)`` pads), the
  contrast-structure terms of the fine scales times the full term of the
  coarsest, negative means clamped to 0, the product taken per channel
  before the mean (pytorch_msssim's conventions, data_range 255 on 0-255
  images as the reference's scorer calls it).

The window is applied as two 1-D ``F.conv2d`` passes in full float32 (the
JAX package uses ``conv_general_dilated`` at highest precision, outside
any kernel of its own). The functions run on the device of their inputs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel(win_size: int, sigma: float, device) -> torch.Tensor:
    half = (win_size - 1) / 2.0
    x = np.arange(win_size, dtype=np.float64) - half
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return torch.as_tensor(g.astype(np.float32), device=device)


def _filter2d_separable(img: torch.Tensor, kernel: torch.Tensor):
    """img: (..., H, W); valid convolution with a separable 1-D kernel."""
    k = kernel.shape[0]
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    # a convolution on the card would otherwise run in TF32
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        x = F.conv2d(x, kernel.reshape(1, 1, k, 1))
        x = F.conv2d(x, kernel.reshape(1, 1, 1, k))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return x.reshape(*lead, *x.shape[-2:])


def _ssim_maps(x, y, data_range, win_size, sigma, k1, k2, cov_norm_factor):
    kernel = _gaussian_kernel(win_size, sigma, x.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _filter2d_separable(x, kernel)
    mu_y = _filter2d_separable(y, kernel)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sxx = cov_norm_factor * (_filter2d_separable(x * x, kernel) - mu_xx)
    syy = cov_norm_factor * (_filter2d_separable(y * y, kernel) - mu_yy)
    sxy = cov_norm_factor * (_filter2d_separable(x * y, kernel) - mu_xy)
    lum = (2 * mu_xy + c1) / (mu_xx + mu_yy + c1)
    cs = (2 * sxy + c2) / (sxx + syy + c2)
    return lum, cs


def _as_f32(img, device=None) -> torch.Tensor:
    """A tensor stays on its device; an array goes to ``device``."""
    return torch.as_tensor(img, dtype=torch.float32, device=device)


def ssim(
    img1, img2, data_range: float = 1.0, win_size: int = 11,
    sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
    sample_covariance: bool = False,
) -> torch.Tensor:
    """Mean SSIM over (..., H, W) (channel-wise, then averaged)."""
    x = _as_f32(img1)
    y = _as_f32(img2, device=x.device)
    if sample_covariance:
        n = win_size * win_size
        factor = n / (n - 1.0)
    else:
        factor = 1.0
    lum, cs = _ssim_maps(x, y, data_range, win_size, sigma, k1, k2, factor)
    return torch.mean(lum * cs)


def _avg_pool2(img: torch.Tensor) -> torch.Tensor:
    """2x average pool; an odd side is padded with one zero row / column."""
    h, w = img.shape[-2], img.shape[-1]
    ph, pw = h % 2, w % 2
    if ph or pw:
        img = F.pad(img, (0, pw, 0, ph))
    lead = img.shape[:-2]
    x = img.reshape(*lead, img.shape[-2] // 2, 2, img.shape[-1] // 2, 2)
    return x.mean(dim=(-3, -1))


def ms_ssim(
    img1, img2, data_range: float = 255.0, win_size: int = 11,
    sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
    weights=MS_WEIGHTS,
) -> torch.Tensor:
    """Multi-scale SSIM over (..., H, W), averaged to a scalar.

    pytorch_msssim asserts min(H, W) > win_size * 2^4 (176 px); below it
    the scales are cut to those the window still fits and the weights are
    renormalised (the JAX package's documented deviation).
    """
    x = _as_f32(img1)
    y = _as_f32(img2, device=x.device)
    levels = len(weights)
    min_dim = min(x.shape[-2], x.shape[-1])
    feasible = 1
    while feasible < levels and (min_dim >> feasible) >= win_size:
        feasible += 1
    if feasible < levels:
        weights = tuple(w / sum(weights[:feasible]) for w in weights[:feasible])
        levels = feasible
    mcs = []  # per-channel cs means of the fine scales
    for i in range(levels):
        lum, cs = _ssim_maps(x, y, data_range, win_size, sigma, k1, k2, 1.0)
        if i < levels - 1:
            mcs.append(torch.clamp(torch.mean(cs, dim=(-2, -1)), min=0.0))
            x = _avg_pool2(x)
            y = _avg_pool2(y)
        else:
            ssim_last = torch.clamp(torch.mean(lum * cs, dim=(-2, -1)),
                                    min=0.0)
    out = ssim_last ** weights[-1]
    for i in range(levels - 1):
        out = out * mcs[i] ** weights[i]
    return torch.mean(out)
