"""Stream rasterizer: binning into one tile-sorted stream, the blend
kernel wrapper, and its epilogue (port of ``gpcr_tpu/ops/rasterize_stream.py``
default path, plus ``rasterize_pallas.assemble_tiles``).

Binning is plain PyTorch (in JAX it is XLA sorts and gathers outside the
Pallas kernel):

1. presort gaussians by (depth, index) — a stable sort of depth with
   invalid gaussians keyed +inf, which is ``lax.sort`` over
   (depth, arange);
2. each valid gaussian at presort rank r emits the first
   min(area, max_dup) tiles of its rect, row-major; the rest count as
   overflow. Only live entries are emitted: dynamic shapes need no
   sentinel padding;
3. one sort of the unique int64 key tile * (n + 1) + rank — the
   (tile, depth-rank) order of the reference's 64-bit radix sort (int32
   overflows: 4096 tiles x 800K ranks > 2^31);
4. tile starts by ``searchsorted``;
5. one gather of the packed rows [x, y, conic(3), op, depth, 0, feat(C)]
   in sorted-entry order.

The blend (``blend_tiles``) launches the CUDA kernel
``csrc/stream_blend.cu`` for CUDA tensors and runs ``blend_tiles_plain``
for CPU tensors. It never falls back: a CUDA run that cannot build or
launch the kernel raises. With ``with_contrib`` (the training forward,
``ops/rasterize_stream_vjp.py``) both also return the per-pixel
contributor count the replay backward needs.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from . import rasterize as R

# stream row layout: [x, y, conic_x, conic_y, conic_z, op, depth, 0 | feat]
STREAM_FEAT_COL = 8

# launches of the CUDA blend kernel in this process (one per
# ``_blend_tiles_cuda`` call that reached the kernel); read and reset by
# callers that need to show a run went through the kernel
LAUNCHES = 0
# the same for the kernel's contributor-count instantiation (training)
LAUNCHES_CONTRIB = 0


def _round_up(x, m):
    return -(-x // m) * m


# --------------------------------------------------------------------------
# binning
# --------------------------------------------------------------------------


def bin_sorted_stream(
    prep: R.Preprocessed,
    num_tiles: int,
    grid_x: int,
    config: R.RasterizeConfig,
    return_entries: bool = False,
):
    """Depth presort -> rank emit -> one (tile, rank) sort -> stream gather.

    Returns (stream (E, 8 + C) f32, starts (num_tiles + 1,) i32,
    overflow () i64) with E the number of kept entries. ``overflow``
    counts entries never emitted (dup cap) or cut by a positive
    ``k_budget``. With ``return_entries`` also returns the sorted ranks
    (E,) and the presort permutation (n,) (rank -> original index).
    """
    n = prep.depth.shape[0]
    dev = prep.depth.device
    cap = config.max_dup_per_gaussian

    # 1. presort
    depth_key = torch.where(
        prep.valid, prep.depth, torch.full_like(prep.depth, float("inf")))
    _, gidx_s = torch.sort(depth_key, stable=True)

    # 2. rank emit
    rank, tile, overflow = R.emit_tiles(
        prep.rect[gidx_s], prep.valid[gidx_s], cap, grid_x)
    total = rank.numel()

    # 3. the (tile, rank) sort on one unique int64 key
    key_s, _ = torch.sort(tile * (n + 1) + rank)
    sorted_tile = key_s // (n + 1)
    sorted_rank = key_s - sorted_tile * (n + 1)

    kb = config.k_budget
    if kb is not None and kb > 0:
        # keep the first kb sorted entries (the JAX dense-emit semantics:
        # the tail of the last tiles is dropped) and count the rest
        kb = min(_round_up(kb, config.chunk_size), n * cap)
        overflow = overflow + max(total - kb, 0)
        sorted_tile = sorted_tile[:kb]
        sorted_rank = sorted_rank[:kb]

    # 4. starts
    starts = torch.searchsorted(
        sorted_tile, torch.arange(num_tiles + 1, device=dev),
        side="left").to(torch.int32)

    # 5. stream gather
    packed = torch.cat(
        [
            prep.mean2d,
            prep.conic,
            prep.opacity[:, None],
            prep.depth[:, None],
            torch.zeros((n, 1), dtype=prep.depth.dtype, device=dev),
            prep.features,
        ],
        dim=-1,
    ).to(torch.float32)
    stream = packed[gidx_s[sorted_rank]].contiguous()
    if return_entries:
        return stream, starts, overflow, sorted_rank, gidx_s
    return stream, starts, overflow


# --------------------------------------------------------------------------
# blend: kernel wrapper and its plain version
# --------------------------------------------------------------------------


def blend_tiles(
    stream: torch.Tensor,
    starts: torch.Tensor,
    order: torch.Tensor,
    num_tiles: int,
    grid_x: int,
    channels: int,
    config: R.RasterizeConfig,
    with_contrib: bool = False,
):
    """Composite the tiles listed in ``order`` over their stream ranges.

    Returns (acc (num_tiles, P_out, C), T (num_tiles, P_out)) in tile
    order; tiles not in ``order`` keep acc 0 and T 1. CUDA tensors run
    the CUDA kernel, CPU tensors the plain PyTorch version.

    ``with_contrib`` (``downscale == 1`` only) adds n_contrib
    (num_tiles, P) int32: per pixel, the number of positions of its
    tile's range it walked before it stopped — the in-tile index of the
    crossing entry where the pixel terminated, else the length of the
    range; skipped entries count. Tiles not in ``order`` keep 0.
    """
    if with_contrib and config.downscale != 1:
        raise ValueError("with_contrib renders at native resolution "
                         "(downscale 1)")
    if stream.is_cuda:
        return _blend_tiles_cuda(
            stream, starts, order, num_tiles, grid_x, channels, config,
            with_contrib)
    if stream.device.type != "cpu":
        raise ValueError(f"no blend for device {stream.device}")
    return blend_tiles_plain(
        stream, starts, order, num_tiles, grid_x, channels, config,
        with_contrib)


def blend_tiles_plain(
    stream: torch.Tensor,
    starts: torch.Tensor,
    order: torch.Tensor,
    num_tiles: int,
    grid_x: int,
    channels: int,
    config: R.RasterizeConfig,
    with_contrib: bool = False,
    with_live: bool = False,
):
    """The plain PyTorch version of the blend kernel (any device).

    Vectorised over (tiles, pixels): tiles go in batches of
    ``config.tile_batch`` (bounding every temporary to tile_batch x
    chunk x 256 floats), and each batch steps through its entries
    ``chunk_size`` at a time. Within a chunk the transmittance is a
    cumulative product along the entry axis seeded with the running T,
    so every T is the same left-to-right float32 product the kernel forms
    (``cumprod`` over a non-innermost dimension is sequential on both CPU
    and CUDA). The crossing entry (T·(1−α) < 1e-4) and all later ones are
    excluded, as in the kernel.

    ``with_live`` (with ``with_contrib``; measurement only, the kernel has
    no such output) adds n_live (num_tiles, P) int32: of the positions a
    pixel walked, those it composited (alpha neither skipped nor zero). The
    others cost only the alpha test, so a bound on the blend's work charges
    the compositing to ``n_live.sum()`` pairs and not to ``n_contrib.sum()``.
    """
    if with_live and not with_contrib:
        raise ValueError("with_live counts among the with_contrib positions")
    tx, ty = config.tile_x, config.tile_y
    p = tx * ty
    ds = config.downscale
    chunk = config.chunk_size
    dev = stream.device
    c0 = STREAM_FEAT_COL
    acc_all = torch.zeros((num_tiles, p, channels), dtype=torch.float32,
                          device=dev)
    t_all = torch.ones((num_tiles, p), dtype=torch.float32, device=dev)
    cnt_all = torch.zeros((num_tiles, p), dtype=torch.int32, device=dev)
    live_all = torch.zeros((num_tiles, p), dtype=torch.int32, device=dev)
    lx = (torch.arange(p, device=dev) % tx).to(torch.float32)
    ly = (torch.arange(p, device=dev) // tx).to(torch.float32)
    steps = torch.arange(chunk, device=dev)
    n_rows = stream.shape[0]

    order = order.long()
    for b0 in range(0, order.numel(), config.tile_batch):
        tiles = order[b0:b0 + config.tile_batch]
        s = starts[tiles].long()
        e = starts[tiles + 1].long()
        max_cnt = int((e - s).max())
        if max_cnt == 0:
            continue
        nb = tiles.numel()
        px = ((tiles % grid_x) * tx).to(torch.float32)[:, None] + lx[None]
        py = ((tiles // grid_x) * ty).to(torch.float32)[:, None] + ly[None]
        px = px[:, None, :]  # (B, 1, P)
        py = py[:, None, :]
        T_run = torch.ones((nb, p), dtype=torch.float32, device=dev)
        acc = torch.zeros((nb, p, channels), dtype=torch.float32, device=dev)
        dead = torch.zeros((nb, p), dtype=torch.bool, device=dev)
        cnt = torch.zeros((nb, p), dtype=torch.int32, device=dev)
        live = torch.zeros((nb, p), dtype=torch.int32, device=dev)
        for k0 in range(0, max_cnt, chunk):
            # a step spans at most the batch's longest remaining range
            rows_k = steps[:min(chunk, max_cnt - k0)]
            idx = s[:, None] + k0 + rows_k[None, :]  # (B, rows)
            in_r = (idx < e[:, None])[:, :, None]
            rows = stream[torch.clamp(idx, max=n_rows - 1)]  # (B, rows, ncols)
            dx = rows[:, :, 0:1] - px  # (B, rows, P)
            dy = rows[:, :, 1:2] - py
            power = (
                -0.5 * (rows[:, :, 2:3] * dx * dx + rows[:, :, 4:5] * dy * dy)
                - rows[:, :, 3:4] * dx * dy
            )
            alpha = torch.clamp(rows[:, :, 5:6] * torch.exp(power), max=0.99)
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
            acc = acc + torch.bmm(w.transpose(1, 2), rows[:, :, c0:c0 + channels])
            T_run = torch.where(applied, t_incl, T_run[:, None, :]).amin(dim=1)
            if with_contrib:
                # positions walked: in range, before the crossing entry
                cnt = cnt + (applied & in_r).sum(dim=1, dtype=torch.int32)
            if with_live:
                # a is zero out of range, so these are in-range positions
                live = live + (applied & (a > 0)).sum(dim=1, dtype=torch.int32)
            dead = dead | crossed[:, -1, :]
            if bool(dead.all()):
                break
        acc_all[tiles] = acc
        t_all[tiles] = T_run
        cnt_all[tiles] = cnt
        live_all[tiles] = live
    if with_live:
        return acc_all, t_all, cnt_all, live_all
    if with_contrib:
        return acc_all, t_all, cnt_all
    if ds == 1:
        return acc_all, t_all
    if ds != 2:
        raise ValueError(f"downscale {ds} not supported (1 or 2)")
    acc_d = acc_all.reshape(num_tiles, ty // 2, 2, tx // 2, 2, channels)
    t_d = t_all.reshape(num_tiles, ty // 2, 2, tx // 2, 2)
    return (acc_d.mean(dim=(2, 4)).reshape(num_tiles, p // 4, channels),
            t_d.mean(dim=(2, 4)).reshape(num_tiles, p // 4))


def check_blend_inputs(stream, starts, order, num_tiles, channels,
                       config: R.RasterizeConfig) -> None:
    """Raise on what the CUDA blend kernels (forward and backward) do not
    take: they read raw pointers, so device, dtype, shape and contiguity
    are checked here."""
    if (config.tile_x, config.tile_y) != (16, 16):
        raise ValueError("the CUDA blend kernel takes 16x16 tiles only")
    if not 1 <= channels <= 16:
        raise ValueError(f"the CUDA blend kernel takes 1..16 channels, got {channels}")
    dev = stream.device
    for name, t, dt in (("stream", stream, torch.float32),
                        ("starts", starts, torch.int32),
                        ("order", order, torch.int32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, stream on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if stream.dim() != 2 or stream.shape[1] < STREAM_FEAT_COL + channels:
        raise ValueError(f"stream shape {tuple(stream.shape)} has no "
                         f"{channels} feature columns")
    if starts.shape != (num_tiles + 1,):
        raise ValueError(f"starts must be ({num_tiles + 1},)")


def _blend_tiles_cuda(stream, starts, order, num_tiles, grid_x, channels,
                      config: R.RasterizeConfig, with_contrib: bool = False):
    """Launch ``csrc/stream_blend.cu`` on the current CUDA stream."""
    global LAUNCHES, LAUNCHES_CONTRIB
    if config.downscale not in (1, 2):
        raise ValueError(f"downscale {config.downscale} not supported (1 or 2)")
    check_blend_inputs(stream, starts, order, num_tiles, channels, config)
    dev = stream.device
    p_out = 256 // (config.downscale ** 2)
    acc = torch.zeros((num_tiles, p_out, channels), dtype=torch.float32,
                      device=dev)
    t = torch.ones((num_tiles, p_out), dtype=torch.float32, device=dev)
    cnt = (torch.zeros((num_tiles, p_out), dtype=torch.int32, device=dev)
           if with_contrib else None)
    if order.numel() == 0:
        return (acc, t, cnt) if with_contrib else (acc, t)
    lib = _stream_blend_lib()
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream
    if with_contrib:
        rc = lib.gpcr_stream_blend_contrib(
            stream.data_ptr(), stream.shape[1], starts.data_ptr(),
            order.data_ptr(), order.numel(), grid_x, channels,
            config.chunk_size, acc.data_ptr(), t.data_ptr(), cnt.data_ptr(),
            cuda_stream,
        )
    else:
        rc = lib.gpcr_stream_blend(
            stream.data_ptr(), stream.shape[1], starts.data_ptr(),
            order.data_ptr(), order.numel(), grid_x, channels,
            config.chunk_size, config.downscale, acc.data_ptr(), t.data_ptr(),
            cuda_stream,
        )
    if rc != 0:
        msg = lib.gpcr_cuda_error_string(rc).decode()
        raise RuntimeError(f"stream_blend launch failed: {msg} ({rc})")
    if with_contrib:
        LAUNCHES_CONTRIB += 1
        return acc, t, cnt
    LAUNCHES += 1
    return acc, t


def _stream_blend_lib():
    lib = cuda_build.load("stream_blend")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gpcr_stream_blend.argtypes = [
            vp, ci, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
        lib.gpcr_stream_blend.restype = ci
        lib.gpcr_stream_blend_contrib.argtypes = [
            vp, ci, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
        lib.gpcr_stream_blend_contrib.restype = ci
        lib.gpcr_cuda_error_string.argtypes = [ci]
        lib.gpcr_cuda_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib


# --------------------------------------------------------------------------
# epilogue and public entry points
# --------------------------------------------------------------------------


def render_order(starts, overflow, num_tiles: int,
                 config: R.RasterizeConfig):
    """Tiles to render, in descending entry-count order: (order (G,) i32,
    overflow). With ``max_active_tiles`` only the first ones render and
    the entries of the rest are added to ``overflow`` (their pixels keep
    the background)."""
    counts = starts[1:] - starts[:-1]
    order = torch.argsort(-counts, stable=True).to(torch.int32)
    n_grid = min(config.max_active_tiles or num_tiles, num_tiles)
    if n_grid < num_tiles:
        overflow = overflow + torch.sum(counts[order[n_grid:].long()])
    return order[:n_grid].contiguous(), overflow


def blend_stream(
    prep: R.Preprocessed,
    bg: torch.Tensor,  # (C,)
    num_tiles: int,
    grid_x: int,
    config: R.RasterizeConfig,
    channels: int,
):
    """Bin + blend. Returns (out (num_tiles, P_out, C), final_T
    (num_tiles, P_out), overflow () i64). Tiles render in
    ``render_order``."""
    stream, starts, overflow = bin_sorted_stream(prep, num_tiles, grid_x,
                                                 config)
    order, overflow = render_order(starts, overflow, num_tiles, config)
    acc, t_run = blend_tiles(stream, starts, order, num_tiles, grid_x,
                             channels, config)
    out = acc + t_run[..., None] * bg.to(acc.dtype)[None, None, :]
    return out, t_run, overflow


def assemble_tiles(out, t_run, H, W, config: R.RasterizeConfig):
    """(num_tiles, P, C) -> (C, H, W), (H, W)."""
    grid_x = -(-W // config.tile_x)
    grid_y = -(-H // config.tile_y)
    channels = out.shape[-1]
    img = out.reshape(grid_y, grid_x, config.tile_y, config.tile_x, channels)
    img = img.permute(4, 0, 2, 1, 3).reshape(
        channels, grid_y * config.tile_y, grid_x * config.tile_x
    )[:, :H, :W]
    t = t_run.reshape(grid_y, grid_x, config.tile_y, config.tile_x)
    t = t.permute(0, 2, 1, 3).reshape(
        grid_y * config.tile_y, grid_x * config.tile_x
    )[:H, :W]
    return img, t


def rasterize_gaussians_stream(
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
    return_extra: bool = False,
):
    """Forward rasterization through the stream path: (color (C, H, W),
    radii (N,) i32) plus {"final_T", "dup_overflow"} with
    ``return_extra``. ``config.downscale == 2`` returns H/2 x W/2."""
    H, W = settings.image_height, settings.image_width
    grid_x = -(-W // config.tile_x)
    grid_y = -(-H // config.tile_y)
    num_tiles = grid_x * grid_y
    ds = config.downscale
    if ds > 1 and (H % ds or W % ds or config.tile_x % ds
                   or config.tile_y % ds):
        raise ValueError("downscale requires even H/W/tile dims")

    prep = R.preprocess(
        means3d, opacities, settings, config,
        scales=scales, rotations=rotations, cov3d_precomp=cov3d_precomp,
        shs=shs, colors_precomp=colors_precomp, valid_mask=valid_mask,
    )
    channels = prep.features.shape[-1]
    out, t_run, overflow = blend_stream(
        prep, settings.bg, num_tiles, grid_x, config, channels)
    if ds > 1:
        acfg = config._replace(tile_x=config.tile_x // ds,
                               tile_y=config.tile_y // ds)
        color, t_img = assemble_tiles(out, t_run, H // ds, W // ds, acfg)
    else:
        color, t_img = assemble_tiles(out, t_run, H, W, config)
    radii = prep.radius.to(torch.int32)
    if return_extra:
        return color, radii, {"final_T": t_img, "dup_overflow": overflow}
    return color, radii
