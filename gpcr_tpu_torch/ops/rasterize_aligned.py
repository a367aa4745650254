"""All-tiles blend over the chunk-aligned layout: binning, the blend
kernel's wrapper with its plain version, and the rasterizer entry point
(port of ``gpcr_tpu/ops/rasterize_pallas.py``: ``tile_bin_aligned``
:46-108, ``blend_pallas`` :237-296 with its kernel ``_blend_kernel``
:116-225, ``rasterize_gaussians_pallas`` :315-346; ``assemble_tiles`` is
the one in ``rasterize_stream.py``; the flat two-phase blend :354-483 is a
recorded negative and is not ported).

Layout. ``tile_bin_aligned`` sorts the entries by (tile, depth)
(``rasterize.tile_bin``) and gives every tile whole chunks of
``config.chunk_size`` slots: tile t owns chunks
[chunk_starts[t], chunk_starts[t + 1]). Per chunk there is one block of
scalars ``scal (Kc, 6, CH)`` (x, y, conic x / y / z, opacity) and one block
of features ``feat (Kc, C, CH)``, gaussians along the last axis. The slots
that pad a tile's last chunk are zero: opacity 0 gives alpha 0, which the
alpha < 1/255 test skips. The JAX layout pads the 6 fields to 8 rows and
the C channels to ``max(8, round_up(C, 8))`` for Mosaic's tiling and sizes
the slot axis to a static bound; the port drops both pads and holds
exactly the chunks in use.

The blend (``blend_aligned_tiles``) launches ``csrc/aligned_blend.cu`` for
CUDA tensors, one CTA per tile over ALL tiles of the image (an empty tile
gets acc 0 and T 1), and runs ``blend_aligned_plain`` for CPU tensors. It
never falls back: a CUDA run that cannot build or launch the kernel
raises. As in the JAX package the route is forward only, ignores
``config.downscale`` and drops the binning's overflow count.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import rasterize as R
from .rasterize_stream import assemble_tiles

SCAL_ROWS = 6  # x, y, conic_x, conic_y, conic_z, opacity

# launches of the CUDA kernel in this process (one per
# ``_blend_aligned_cuda`` call that reached the kernel)
LAUNCHES = 0


# --------------------------------------------------------------------------
# chunk-aligned binning
# --------------------------------------------------------------------------


def tile_bin_aligned(prep: R.Preprocessed, num_tiles: int, grid_x: int,
                     config: R.RasterizeConfig):
    """Sort duplications by (tile, depth) and lay them out chunk-aligned.

    Returns (scal (Kc, 6, CH) f32, feat (Kc, C, CH) f32, chunk_starts
    (num_tiles + 1,) i32 in chunk units, overflow () i64).

    With ``config.max_active_tiles`` the slot axis is clamped to the JAX
    function's static bound, round_up(k_sorted + max_active_tiles * CH,
    CH) with k_sorted the static entry capacity (``k_budget``, else n *
    dup cap): tiles past it lose their chunks and the cut slots are added
    to the overflow.
    """
    ch = config.chunk_size
    n = prep.depth.shape[0]
    dev = prep.depth.device
    sorted_gidx, starts, overflow = R.tile_bin(prep, num_tiles, grid_x, config)
    starts = starts.long()
    counts = starts[1:] - starts[:-1]
    cpad = ((counts + ch - 1) // ch) * ch
    astarts = torch.cat(
        [torch.zeros(1, dtype=torch.long, device=dev), torch.cumsum(cpad, 0)])
    if config.max_active_tiles is not None:
        kb = config.k_budget
        k_sorted = (kb if kb is not None and kb > 0
                    else n * config.max_dup_per_gaussian)
        k_static = -(-(k_sorted + config.max_active_tiles * ch) // ch) * ch
        overflow = overflow + torch.clamp(astarts[-1] - k_static, min=0)
        astarts = torch.clamp(astarts, max=k_static)
    n_slots = int(astarts[-1])

    # per slot: its tile, its position in the tile, the gaussian it holds
    # (n = the zero sentinel row for the slots that pad a last chunk)
    tile_of_slot = torch.repeat_interleave(
        torch.arange(num_tiles, device=dev), astarts[1:] - astarts[:-1],
        output_size=n_slots)
    j = torch.arange(n_slots, device=dev) - astarts[tile_of_slot]
    src = torch.where(j < counts[tile_of_slot], starts[tile_of_slot] + j,
                      torch.full_like(j, sorted_gidx.numel()))
    entry = torch.cat([sorted_gidx, sorted_gidx.new_tensor([n])])[src]

    scal_src = torch.cat(
        [prep.mean2d, prep.conic, prep.opacity[:, None]], dim=-1,
    ).to(torch.float32)
    channels = prep.features.shape[-1]
    feat_src = prep.features.to(torch.float32)
    zero_row = torch.zeros((1, SCAL_ROWS), dtype=torch.float32, device=dev)
    scal_src = torch.cat([scal_src, zero_row], dim=0)
    feat_src = torch.cat([feat_src, zero_row[:, :1].expand(1, channels)], dim=0)
    # (slots, F) -> (Kc, CH, F) -> (Kc, F, CH): gaussians along the last axis
    scal = scal_src[entry].reshape(n_slots // ch, ch, SCAL_ROWS)
    feat = feat_src[entry].reshape(n_slots // ch, ch, channels)
    chunk_starts = (astarts // ch).to(torch.int32)
    return (scal.transpose(1, 2).contiguous(),
            feat.transpose(1, 2).contiguous(), chunk_starts, overflow)


# --------------------------------------------------------------------------
# blend: kernel wrapper and its plain version
# --------------------------------------------------------------------------


def blend_aligned_tiles(chunk_starts, scal, feat, num_tiles: int, grid_x: int,
                        channels: int, config: R.RasterizeConfig):
    """Composite every tile over its chunks. Returns (acc (num_tiles, P,
    C), T (num_tiles, P)) without background. CUDA tensors run the CUDA
    kernel, CPU tensors the plain PyTorch version."""
    if scal.is_cuda:
        return _blend_aligned_cuda(chunk_starts, scal, feat, num_tiles,
                                   grid_x, channels, config)
    if scal.device.type != "cpu":
        raise ValueError(f"no blend for device {scal.device}")
    return blend_aligned_plain(chunk_starts, scal, feat, num_tiles, grid_x,
                               channels, config)


def blend_aligned_plain(chunk_starts, scal, feat, num_tiles: int, grid_x: int,
                        channels: int, config: R.RasterizeConfig):
    """The plain PyTorch version of the aligned blend kernel (any device).

    Tiles go in batches of ``config.tile_batch`` in descending chunk-count
    order, each batch stepping through its chunks together. Within a chunk
    the transmittance is a cumulative product along the slot axis seeded
    with the running T: the same left-to-right float32 products the kernel
    forms. The crossing entry (T * (1 - alpha) < 1e-4) and all later ones
    are excluded and T stays what it was before the crossing.
    """
    tx, ty = config.tile_x, config.tile_y
    p = tx * ty
    dev = scal.device
    acc_all = torch.zeros((num_tiles, p, channels), dtype=torch.float32,
                          device=dev)
    t_all = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    lx = (torch.arange(p, device=dev) % tx).to(torch.float32)
    ly = (torch.arange(p, device=dev) // tx).to(torch.float32)
    cs = chunk_starts.long()
    n_chunks = cs[1:] - cs[:-1]
    order = torch.argsort(-n_chunks, stable=True)
    order = order[:int((n_chunks > 0).sum())]

    for b0 in range(0, order.numel(), config.tile_batch):
        tiles = order[b0:b0 + config.tile_batch]
        c0, c1 = cs[tiles], cs[tiles + 1]
        nb = tiles.numel()
        px = ((tiles % grid_x) * tx).to(torch.float32)[:, None] + lx[None]
        py = ((tiles // grid_x) * ty).to(torch.float32)[:, None] + ly[None]
        px = px[:, None, :]  # (B, 1, P)
        py = py[:, None, :]
        T_run = torch.ones((nb, p), dtype=torch.float32, device=dev)
        acc = torch.zeros((nb, p, channels), dtype=torch.float32, device=dev)
        dead = torch.zeros((nb, p), dtype=torch.bool, device=dev)
        for k in range(int((c1 - c0).max())):
            in_r = (c0 + k < c1)[:, None, None]
            idx = torch.clamp(c0 + k, max=scal.shape[0] - 1)
            s = scal[idx].unsqueeze(-1)  # (B, 6, CH, 1)
            dx = s[:, 0] - px  # (B, CH, P)
            dy = s[:, 1] - py
            power = (-0.5 * (s[:, 2] * dx * dx + s[:, 4] * dy * dy)
                     - s[:, 3] * dx * dy)
            alpha = torch.clamp(s[:, 5] * torch.exp(power), max=0.99)
            a = torch.where(
                (power > 0.0) | (alpha < (1.0 / 255.0)) | ~in_r,
                torch.zeros_like(alpha), alpha)
            cum = torch.cumprod(
                torch.cat([T_run[:, None, :], 1.0 - a], dim=1), dim=1)
            t_excl = cum[:, :-1]
            t_incl = cum[:, 1:]
            crossed = t_incl < 1e-4  # a suffix of the chunk per pixel
            applied = ~dead[:, None, :] & ~crossed
            w = torch.where(applied, a * t_excl, torch.zeros_like(a))
            # (B, P, CH) x (B, CH, C)
            acc = acc + torch.bmm(w.transpose(1, 2),
                                  feat[idx].transpose(1, 2))
            T_run = torch.where(applied, t_incl, T_run[:, None, :]).amin(dim=1)
            dead = dead | crossed[:, -1, :]
            if bool(dead.all()):
                break
        acc_all[tiles] = acc
        t_all[tiles] = T_run
    return acc_all, t_all


def _check_inputs(chunk_starts, scal, feat, num_tiles, channels,
                  config: R.RasterizeConfig) -> None:
    """Raise on what the CUDA kernel does not take: it reads raw pointers,
    so device, dtype, shape and contiguity are checked here."""
    if (config.tile_x, config.tile_y) != (16, 16):
        raise ValueError("the CUDA blend kernel takes 16x16 tiles only")
    if not 1 <= channels <= 16:
        raise ValueError(
            f"the CUDA blend kernel takes 1..16 channels, got {channels}")
    dev = scal.device
    for name, t, dt in (("scal", scal, torch.float32),
                        ("feat", feat, torch.float32),
                        ("chunk_starts", chunk_starts, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, scal on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ch = config.chunk_size
    if scal.dim() != 3 or tuple(scal.shape[1:]) != (SCAL_ROWS, ch):
        raise ValueError(f"scal must be (Kc, {SCAL_ROWS}, {ch}), got "
                         f"{tuple(scal.shape)}")
    if tuple(feat.shape) != (scal.shape[0], channels, ch):
        raise ValueError(f"feat must be ({scal.shape[0]}, {channels}, {ch}), "
                         f"got {tuple(feat.shape)}")
    if chunk_starts.shape != (num_tiles + 1,):
        raise ValueError(f"chunk_starts must be ({num_tiles + 1},)")


def _blend_aligned_cuda(chunk_starts, scal, feat, num_tiles, grid_x, channels,
                        config: R.RasterizeConfig):
    """Launch ``csrc/aligned_blend.cu`` on the current CUDA stream."""
    global LAUNCHES
    _check_inputs(chunk_starts, scal, feat, num_tiles, channels, config)
    dev = scal.device
    # the kernel writes every tile, the empty ones too
    acc = torch.empty((num_tiles, 256, channels), dtype=torch.float32,
                      device=dev)
    t = torch.empty((num_tiles, 256), dtype=torch.float32, device=dev)
    if num_tiles == 0:
        return acc, t
    lib = _aligned_blend_lib()
    rc = lib.gpcr_aligned_blend(
        chunk_starts.data_ptr(), scal.data_ptr(), feat.data_ptr(),
        scal.shape[0], num_tiles, grid_x, channels, config.chunk_size,
        acc.data_ptr(), t.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.gpcr_cuda_error_string(rc).decode()
        raise RuntimeError(f"aligned_blend launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return acc, t


def _aligned_blend_lib():
    lib = cuda_build.load("aligned_blend")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gpcr_aligned_blend.argtypes = [
            vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
        lib.gpcr_aligned_blend.restype = ci
        lib.gpcr_cuda_error_string.argtypes = [ci]
        lib.gpcr_cuda_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib


# --------------------------------------------------------------------------
# public entry points
# --------------------------------------------------------------------------


def blend_aligned(prep: R.Preprocessed, bg: torch.Tensor, num_tiles: int,
                  grid_x: int, config: R.RasterizeConfig, channels: int):
    """Bin (chunk-aligned) + blend all tiles + background. Returns (out
    (num_tiles, P, C), final_T (num_tiles, P)). The binning's overflow
    count is dropped, as ``blend_pallas`` drops it."""
    scal, feat, chunk_starts, _ = tile_bin_aligned(prep, num_tiles, grid_x,
                                                   config)
    acc, t_run = blend_aligned_tiles(chunk_starts, scal, feat, num_tiles,
                                     grid_x, channels, config)
    out = acc + t_run[..., None] * bg.to(acc.dtype)[None, None, :]
    return out, t_run


def rasterize_gaussians_aligned(
    means3d,
    opacities,
    settings: R.GaussianRasterizationSettings,
    scales=None,
    rotations=None,
    cov3d_precomp=None,
    shs=None,
    colors_precomp=None,
    valid_mask=None,
    config: R.RasterizeConfig = R.RasterizeConfig(),
):
    """Forward rasterization through the aligned all-tiles blend: (color
    (C, H, W), radii (N,) i32), always at the settings' resolution."""
    H, W = settings.image_height, settings.image_width
    grid_x = -(-W // config.tile_x)
    grid_y = -(-H // config.tile_y)
    num_tiles = grid_x * grid_y
    prep = R.preprocess(
        means3d, opacities, settings, config,
        scales=scales, rotations=rotations, cov3d_precomp=cov3d_precomp,
        shs=shs, colors_precomp=colors_precomp, valid_mask=valid_mask,
    )
    channels = prep.features.shape[-1]
    out, t_run = blend_aligned(prep, settings.bg, num_tiles, grid_x, config,
                               channels)
    color, _ = assemble_tiles(out, t_run, H, W, config)
    return color, prep.radius.to(torch.int32)
