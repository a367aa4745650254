"""One view's preprocess with the renderer's fused feature row
(``preprocess_view``): every field of ``rasterize.Preprocessed`` that
binning and the blend read, with the features [SH rgb | xyz | ones |
camera-facing normal] that ``render/renderer.py::split_view_channels``
reads back from the images.

CUDA tensors with no gradient to record launch ``csrc/preprocess.cu`` once
per view, on the current CUDA stream, or raise. The plain version is
``fuse_view_features`` followed by ``rasterize.preprocess``; CPU tensors
run it (the JAX parity tests hold it), and so does every call that records
a gradient (``config.differentiable``, the trainer, any input that
requires one), since the kernel has no backward. On the card the two give
the same bits (``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import sh as sh_utils
from ..utils import trace
from . import cuda_build
from . import rasterize as R

# views preprocessed on csrc/preprocess.cu in this process (one per
# launch); read and reset by callers that need to show a run went through
# the kernel
LAUNCHES_PREP = 0


def fuse_view_features(campos, means3d, shs, normal, sh_degree: int,
                       with_normal: bool) -> torch.Tensor:
    """One view's fused features (n, 9), or (n, 12) ``with_normal``: [SH
    rgb | xyz | ones | (normal turned to face the camera)]."""
    rgb = sh_utils.eval_sh_color(sh_degree, shs, means3d, campos)
    feats = [rgb, means3d, torch.ones_like(means3d)]
    if with_normal:
        cam_dir = means3d - campos[None, :]
        sgn = (torch.sum(cam_dir * normal, -1, keepdim=True) > 0).to(
            torch.float32) * 2.0 - 1.0
        feats.append(normal * (-1.0) * sgn)
    return torch.cat(feats, dim=-1)


def view_background(bg3: torch.Tensor, with_normal: bool) -> torch.Tensor:
    """The fused features' per-channel background: ``bg3`` (3,) for each
    block of three channels."""
    return torch.cat([bg3] * (4 if with_normal else 3), dim=-1)


def preprocess_view(settings: R.GaussianRasterizationSettings, means3d,
                    scales, rotations, opacity, shs, normal, valid,
                    config: R.RasterizeConfig,
                    with_normal: bool) -> R.Preprocessed:
    """The splats' ``Preprocessed`` in one view, features fused: one launch
    of ``csrc/preprocess.cu`` for CUDA tensors with no gradient to record,
    else ``fuse_view_features`` and ``rasterize.preprocess``. ``valid``
    (n,) bool or None; ``normal`` is read only ``with_normal``. The spans
    ``gpcr.raster.features`` and ``gpcr.raster.preprocess`` are the same
    on both paths; the kernel writes the features inside the second."""
    kernel = means3d.is_cuda and not config.differentiable and not (
        torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (means3d, scales, rotations, opacity, shs, normal,
                      settings.viewmatrix, settings.projmatrix,
                      settings.campos)))
    with trace.span("gpcr.raster.features"):
        features = None if kernel else fuse_view_features(
            settings.campos, means3d, shs, normal, settings.sh_degree,
            with_normal)
    with trace.span("gpcr.raster.preprocess"):
        if kernel:
            return _preprocess_view_cuda(settings, means3d, scales, rotations,
                                         opacity, shs, normal, valid, config,
                                         with_normal)
        return R.preprocess(means3d, opacity, settings, config, scales=scales,
                            rotations=rotations, colors_precomp=features,
                            valid_mask=valid)


def _preprocess_view_cuda(settings: R.GaussianRasterizationSettings, means3d,
                          scales, rotations, opacity, shs, normal, valid,
                          config: R.RasterizeConfig,
                          with_normal: bool) -> R.Preprocessed:
    """``preprocess_view`` on ``csrc/preprocess.cu``: inputs read through
    their strides, outputs allocated here."""
    global LAUNCHES_PREP
    n = means3d.shape[0]
    dev = means3d.device
    opacity = opacity.reshape(-1)
    if n >= 2**31 or shs.dim() != 3:
        raise ValueError(
            f"preprocess of {n} splats with SH {tuple(shs.shape)}")
    # the kernel reads raw float32 pointers, all on dev
    checked = [("means3d", means3d, (n, 3)), ("scales", scales, (n, 3)),
               ("rotations", rotations, (n, 4)), ("opacity", opacity, (n,)),
               ("shs", shs, (n, shs.shape[1], 3)),
               ("viewmatrix", settings.viewmatrix, (4, 4)),
               ("projmatrix", settings.projmatrix, (4, 4)),
               ("campos", settings.campos, (3,))]
    if with_normal:
        checked.append(("normal", normal, (n, 3)))
    if valid is not None:
        valid = valid.bool()
        checked.append(("valid", valid, (n,)))
    for name, t, shape in checked:
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}, not "
                             f"{shape} on {dev}")
        want = torch.bool if name == "valid" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    strides = (ctypes.c_longlong * 18)(
        *means3d.stride(), *scales.stride(), *rotations.stride(),
        *opacity.stride(), *shs.stride(),
        *(normal.stride() if with_normal else (0, 0)),
        *(valid.stride() if valid is not None else (0,)),
        *settings.viewmatrix.stride(), *settings.projmatrix.stride(),
        *settings.campos.stride())
    f32 = dict(dtype=torch.float32, device=dev)
    prep = R.Preprocessed(
        valid=torch.empty(n, dtype=torch.bool, device=dev),
        depth=torch.empty(n, **f32), mean2d=torch.empty((n, 2), **f32),
        conic=torch.empty((n, 3), **f32), radius=torch.empty(n, **f32),
        rect=torch.empty((n, 4), dtype=torch.int32, device=dev),
        features=torch.empty((n, 12 if with_normal else 9), **f32),
        opacity=opacity)
    H, W = settings.image_height, settings.image_width
    lib = _preprocess_lib()
    rc = lib.gpcr_preprocess(
        means3d.data_ptr(), scales.data_ptr(), rotations.data_ptr(),
        opacity.data_ptr(), shs.data_ptr(),
        normal.data_ptr() if with_normal else None,
        valid.data_ptr() if valid is not None else None,
        settings.viewmatrix.data_ptr(), settings.projmatrix.data_ptr(),
        settings.campos.data_ptr(), strides, n, shs.shape[1],
        settings.sh_degree, int(config.opacity_radius), W, H, config.tile_x,
        config.tile_y, W / (2.0 * settings.tanfovx),
        H / (2.0 * settings.tanfovy), 1.3 * settings.tanfovx,
        1.3 * settings.tanfovy, settings.scale_modifier,
        prep.valid.data_ptr(), prep.depth.data_ptr(), prep.mean2d.data_ptr(),
        prep.conic.data_ptr(), prep.radius.data_ptr(), prep.rect.data_ptr(),
        prep.features.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.gpcr_preprocess_error_string(rc).decode()
        raise RuntimeError(f"preprocess launch failed: {msg} ({rc})")
    LAUNCHES_PREP += 1
    trace.count("prep_kernel_views", 1)
    return prep


def _preprocess_lib():
    lib = cuda_build.load("preprocess")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gpcr_preprocess.argtypes = (
            [vp] * 10 + [ctypes.POINTER(ctypes.c_longlong)] + [ci] * 8
            + [cf] * 5 + [vp] * 8)
        lib.gpcr_preprocess.restype = ci
        lib.gpcr_preprocess_error_string.argtypes = [ci]
        lib.gpcr_preprocess_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib
