"""Stream rasterizer: binning into one tile-sorted stream, the blend
kernel wrapper, and the serving tile core ``STREAM`` (port of
``gpcr_tpu/ops/rasterize_stream.py`` default path).

Binning (``bin_sorted_stream``; in JAX it is XLA sorts and gathers outside
the Pallas kernel):

1. presort gaussians by (depth, index) — a stable sort of depth with
   invalid gaussians keyed +inf, which is ``lax.sort`` over
   (depth, arange);
2. each valid gaussian at presort rank r emits the first
   min(area, max_dup) tiles of its rect, row-major; the rest count as
   overflow. Only live entries are emitted: dynamic shapes need no
   sentinel padding;
3. the entries in (tile, depth-rank) order, the order of the reference's
   radix sort;
4. tile starts;
5. the rows [x, y, conic(3), op, depth, 0, feat(C)] in sorted-entry order.

For CUDA tensors steps 2-5 run on ``csrc/bin_stream.cu``: since the emit
walks the splats in rank order, a stable sort of the tile ids alone, over
bit_length(tiles) bits, gives step 3's order; the rows are written
straight from the preprocess outputs. ``bin_sorted_stream_plain``, which
CPU tensors run, sorts one unique int64 key tile * (n + 1) + rank (int32
overflows: 4096 tiles x 800K ranks > 2^31), finds the starts by
``searchsorted`` and gathers a packed (n, 8 + C) table; both give the same
bits.

The blend (``blend_tiles``) launches the CUDA kernel
``csrc/stream_blend.cu`` for CUDA tensors and runs ``blend_tiles_plain``
for CPU tensors. Both of its kernels skip, per warp of 8x4 pixels, the
entries whose alpha cannot reach the warp's pixels; ``block_mask_plain``
is that predicate in plain PyTorch. Neither binning nor blend falls back:
a CUDA run that cannot build or launch a kernel raises. With
``with_contrib`` (the training forward, ``ops/rasterize_stream_vjp.py``)
both blends also return the per-pixel contributor count the replay
backward needs.
"""

from __future__ import annotations

import ctypes
import functools
import typing as T

import torch

from ..utils import trace
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
# views binned on csrc/bin_stream.cu in this process (one per
# ``_bin_sorted_stream_cuda`` call that reached the row kernel)
LAUNCHES_BIN = 0


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
    tile_window=None,
):
    """Depth presort -> rank emit -> (tile, rank) order -> tile starts ->
    stream rows.

    Returns (stream (E, 8 + C) f32, starts (num_tiles + 1,) i32,
    overflow () i64) with E the number of kept entries. ``overflow``
    counts entries never emitted (dup cap) or cut by a positive
    ``k_budget``. With ``return_entries`` also returns the sorted ranks
    (E,) i64 and the presort permutation (n,) (rank -> original index).

    ``tile_window=(base, count)`` bins only tiles [base, base + count), in
    LOCAL tile ids (the per-window binning of the tile-sharded path,
    ``parallel/render.py``): the emit is the full one, entries of other
    tiles are dropped before the cut, ``starts`` has count + 1 rows, and
    ``k_budget`` cuts and counts LOCAL entries only (the dup-cap overflow
    stays the whole frame's, as in ``gpcr_tpu``).

    CUDA tensors run ``csrc/bin_stream.cu`` (one host read of the emit
    size, and with a window one more of the window's size), CPU tensors
    ``bin_sorted_stream_plain``; the two give the same bits.
    """
    if prep.depth.is_cuda:
        return _bin_sorted_stream_cuda(prep, num_tiles, grid_x, config,
                                       return_entries, tile_window)
    if prep.depth.device.type != "cpu":
        raise ValueError(f"no binning for device {prep.depth.device}")
    return bin_sorted_stream_plain(prep, num_tiles, grid_x, config,
                                   return_entries, tile_window)


def bin_sorted_stream_plain(
    prep: R.Preprocessed,
    num_tiles: int,
    grid_x: int,
    config: R.RasterizeConfig,
    return_entries: bool = False,
    tile_window=None,
):
    """The plain PyTorch version of ``bin_sorted_stream`` (any device):
    ``emit_tiles``, one sort of the unique int64 key tile * (n + 1) +
    rank, ``searchsorted`` and a gather of the packed rows."""
    n = prep.depth.shape[0]
    dev = prep.depth.device
    cap = config.max_dup_per_gaussian

    # 1. presort
    gidx_s = _presort(prep)

    # 2. rank emit
    rank, tile, overflow = R.emit_tiles(
        prep.rect[gidx_s], prep.valid[gidx_s], cap, grid_x)
    if tile_window is not None:
        base, num_tiles = tile_window
        local = (tile >= base) & (tile < base + num_tiles)
        rank, tile = rank[local], tile[local] - base
    total = rank.numel()

    # 3. the (tile, rank) sort on one unique int64 key
    key_s, _ = torch.sort(tile * (n + 1) + rank)
    sorted_tile = key_s // (n + 1)
    sorted_rank = key_s - sorted_tile * (n + 1)

    kb = _budget(config, n)
    if kb >= 0:
        # keep the first kb sorted entries (the JAX dense-emit semantics:
        # the tail of the last tiles is dropped) and count the rest
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


def _presort(prep: R.Preprocessed) -> torch.Tensor:
    """Ranks -> splats: a stable sort of the depths, invalid ones last."""
    depth_key = torch.where(
        prep.valid, prep.depth, torch.full_like(prep.depth, float("inf")))
    return torch.sort(depth_key, stable=True)[1]


def _budget(config: R.RasterizeConfig, n: int) -> int:
    """Sorted entries kept by a positive ``k_budget`` (rounded up to whole
    chunks, at most every entry the emit can make), or -1 for no cut."""
    kb = config.k_budget
    if kb is None or kb <= 0:
        return -1
    return min(_round_up(kb, config.chunk_size),
               n * config.max_dup_per_gaussian)


def _bin_sorted_stream_cuda(prep: R.Preprocessed, num_tiles: int,
                            grid_x: int, config: R.RasterizeConfig,
                            return_entries: bool = False, tile_window=None):
    """``bin_sorted_stream`` on ``csrc/bin_stream.cu``, on the current CUDA
    stream."""
    global LAUNCHES_BIN
    n = prep.depth.shape[0]
    dev = prep.depth.device
    cap = config.max_dup_per_gaussian
    base, count = (0, num_tiles) if tile_window is None else tile_window
    if cap < 0 or count < 1 or n >= 2**31:
        raise ValueError(f"binning of {n} splats, dup cap {cap}, into "
                         f"{count} tiles")
    # the kernels read raw pointers: every field one row per splat, on dev
    channels = prep.features.shape[-1]
    for name, t, shape in (
            ("valid", prep.valid, (n,)), ("rect", prep.rect, (n, 4)),
            ("mean2d", prep.mean2d, (n, 2)), ("conic", prep.conic, (n, 3)),
            ("opacity", prep.opacity, (n,)),
            ("features", prep.features, (n, channels))):
        if t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} on {t.device}, not "
                             f"{shape} on {dev}")
    lib = _bin_stream_lib()
    cuda_stream = torch.cuda.current_stream(dev).cuda_stream

    def check(rc, what):
        if rc != 0:
            msg = lib.gpcr_bin_error_string(rc).decode()
            raise RuntimeError(f"bin_stream {what} failed: {msg} ({rc})")

    gidx_s = _presort(prep)
    rect = prep.rect.to(torch.int32).contiguous()
    valid = prep.valid.to(torch.bool).contiguous()
    srcs = [t.to(torch.float32) for t in (prep.mean2d, prep.conic,
                                          prep.opacity, prep.depth,
                                          prep.features)]
    strides = (ctypes.c_longlong * 8)(*(d for t in srcs for d in t.stride()))
    starts = torch.empty(count + 1, dtype=torch.int32, device=dev)
    kb = _budget(config, n)
    area = torch.empty(n, dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    check(lib.gpcr_bin_count(rect.data_ptr(), valid.data_ptr(),
                             gidx_s.data_ptr(), n, cap, area.data_ptr(),
                             overflow.data_ptr(), cuda_stream), "count")
    incl = torch.cumsum(area, 0)
    total = int(incl[-1]) if n else 0  # the one host read: sizes the emit
    if total >= 2**31:
        raise ValueError(f"{total} entries: the kernels index with int32")

    # keys: tiles 0 .. count - 1 and a window's sentinel bucket ``count``
    # (13 bits at 4,096 tiles, 15 at 16,384: two 8-bit radix passes)
    bits = count.bit_length()
    # the sort's double buffer: (keys, values) x 2
    keys = [torch.empty(total, dtype=torch.int32, device=dev)
            for _ in range(2)]
    vals = [torch.empty(total, dtype=torch.int32, device=dev)
            for _ in range(2)]
    temp_bytes = ctypes.c_size_t(0)
    if total:
        check(lib.gpcr_bin_sort_temp_bytes(total, bits,
                                           ctypes.byref(temp_bytes)),
              "sort size query")
    temp = torch.empty(temp_bytes.value, dtype=torch.uint8, device=dev)
    selector = ctypes.c_int(0)
    check(lib.gpcr_bin_sort(
        rect.data_ptr(), gidx_s.data_ptr(), incl.data_ptr(), n, grid_x, base,
        count, keys[0].data_ptr(), vals[0].data_ptr(), keys[1].data_ptr(),
        vals[1].data_ptr(), total, bits, temp.data_ptr(), temp_bytes.value,
        kb, starts.data_ptr(), overflow.data_ptr(), ctypes.byref(selector),
        cuda_stream), "sort")
    if tile_window is None:
        kept = total if kb < 0 else min(total, kb)
    else:
        kept = int(starts[count])  # the window's entries, after the cut

    ranks = vals[selector.value][:kept]
    stream = torch.empty((kept, STREAM_FEAT_COL + channels),
                         dtype=torch.float32, device=dev)
    check(lib.gpcr_bin_rows(
        ranks.data_ptr(), gidx_s.data_ptr(), kept, channels,
        *(t.data_ptr() for t in srcs), strides, stream.data_ptr(),
        cuda_stream), "rows")
    LAUNCHES_BIN += 1
    trace.count("bin_kernel_views", 1)
    if return_entries:
        return stream, starts, overflow, ranks.long(), gidx_s
    return stream, starts, overflow


def _bin_stream_lib():
    lib = cuda_build.load("bin_stream")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gpcr_bin_count.argtypes = [vp, vp, vp, ci, ci, vp, vp, vp]
        lib.gpcr_bin_count.restype = ci
        lib.gpcr_bin_sort_temp_bytes.argtypes = [
            ci, ci, ctypes.POINTER(ctypes.c_size_t)]
        lib.gpcr_bin_sort_temp_bytes.restype = ci
        lib.gpcr_bin_sort.argtypes = [
            vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, ci, ci, vp,
            ctypes.c_size_t, ctypes.c_longlong, vp, vp, ctypes.POINTER(ci),
            vp]
        lib.gpcr_bin_sort.restype = ci
        lib.gpcr_bin_rows.argtypes = [
            vp, vp, ci, ci, vp, vp, vp, vp, vp,
            ctypes.POINTER(ctypes.c_longlong), vp, vp]
        lib.gpcr_bin_rows.restype = ci
        lib.gpcr_bin_error_string.argtypes = [ci]
        lib.gpcr_bin_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib


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
    tile_base: int = 0,
):
    """Composite the tiles listed in ``order`` over their stream ranges.

    Returns (acc (num_tiles, P_out, C), T (num_tiles, P_out)) in tile
    order; tiles not in ``order`` keep acc 0 and T 1. CUDA tensors run
    the CUDA kernel, CPU tensors the plain PyTorch version.

    ``tile_base``: ``starts``, ``order`` and the outputs index the tiles of
    a window that starts at global tile ``tile_base`` (``bin_sorted_stream
    (tile_window=...)``); the pixel coordinates are those of global tile
    ``tile_base + t``. The training forward (``with_contrib``) takes no
    window.

    ``with_contrib`` (``downscale == 1`` only) adds n_contrib
    (num_tiles, P) int32: per pixel, the number of positions of its
    tile's range it walked before it stopped — the in-tile index of the
    crossing entry where the pixel terminated, else the length of the
    range; skipped entries count. Tiles not in ``order`` keep 0.
    """
    if with_contrib and config.downscale != 1:
        raise ValueError("with_contrib renders at native resolution "
                         "(downscale 1)")
    if with_contrib and tile_base:
        raise ValueError("with_contrib takes no tile window")
    if stream.is_cuda:
        return _blend_tiles_cuda(
            stream, starts, order, num_tiles, grid_x, channels, config,
            with_contrib, tile_base)
    if stream.device.type != "cpu":
        raise ValueError(f"no blend for device {stream.device}")
    return blend_tiles_plain(
        stream, starts, order, num_tiles, grid_x, channels, config,
        with_contrib, tile_base=tile_base)


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
    tile_base: int = 0,
):
    """The plain PyTorch version of the blend kernel (any device);
    ``tile_base`` as in ``blend_tiles``.

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
        gt = tiles + tile_base  # pixel coordinates are global
        px = ((gt % grid_x) * tx).to(torch.float32)[:, None] + lx[None]
        py = ((gt // grid_x) * ty).to(torch.float32)[:, None] + ly[None]
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


def block_mask_plain(rows: torch.Tensor, x0: float, y0: float) -> torch.Tensor:
    """The blend kernels' cull predicate (``block_mask`` in
    ``csrc/blend_common.cuh``), op for op in float32: for stream rows
    (n, >= 6) and a tile at pixel origin (x0, y0), (n, 8) bool, True where
    the entry's alpha may reach >= 1/255 somewhere in the 8x4 pixel block
    at (x0 + (w % 2) * 8, y0 + (w // 2) * 4) (warp w of the kernel). A
    False pair is one the plain version skips (power > 0 or alpha < 1/255
    at every pixel of the block); the kernel's warp walks only True
    ones."""
    return block_mask_values(*rows[:, :6].to(torch.float32).unbind(1),
                             x0, y0)


def block_mask_values(mx, my, a, b, c, op, x0: float,
                      y0: float) -> torch.Tensor:
    """``block_mask_plain`` on the six scalars given as tensors of one
    shape S (the kernels' value overload of ``block_mask``): S + (8,)
    bool."""
    det = a * c - b * b
    regular = ((a > 0) & (c > 0) & (det > 1e-3 * (a * c))
               & (mx.abs() < 1e30) & (my.abs() < 1e30) & ~torch.isnan(op))
    hdif = 0.5 * (a - c)
    lmax = 0.5 * (a + c) + torch.sqrt(hdif * hdif + b * b)
    shrink = 1.0 - 1e-5 * ((torch.maximum(a, c) + b.abs()) * lmax / det)
    tau = torch.log(255.0 * op)
    tau_eff = (tau + 1e-5 * tau.abs() + 2e-5) / shrink
    hx = (torch.sqrt(2.0 * tau_eff * c / det) * 1.001 + 0.05)[..., None]
    hy = (torch.sqrt(2.0 * tau_eff * a / det) * 1.001 + 0.05)[..., None]
    w = torch.arange(8, device=mx.device)
    bx = (x0 + (w % 2) * 8).to(torch.float32)
    by = (y0 + (w // 2) * 4).to(torch.float32)
    mx, my = mx[..., None], my[..., None]
    hit = ((mx - hx <= bx + 7.0) & (mx + hx >= bx)
           & (my - hy <= by + 3.0) & (my + hy >= by))
    hit = hit & ~(tau_eff < 0)[..., None]
    culls = (regular & (op > 0) & (shrink > 0.5))[..., None]
    every = (~regular | ((op > 0) & ~(shrink > 0.5)))[..., None]
    return torch.where(culls, hit, every.expand_as(hit))


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
                      config: R.RasterizeConfig, with_contrib: bool = False,
                      tile_base: int = 0):
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
            order.data_ptr(), order.numel(), grid_x, tile_base, channels,
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


def count_ring_stages(ncols: int, chunk: int):
    """(stages, dynamic shared bytes) of the contributor-count kernel's
    chunk ring for stream rows of ``ncols`` floats and ``chunk`` rows per
    chunk (builds the library on first use)."""
    smem = ctypes.c_int(0)
    stages = _stream_blend_lib().gpcr_count_ring(ncols, chunk,
                                                 ctypes.byref(smem))
    return stages, smem.value


def _stream_blend_lib():
    lib = cuda_build.load("stream_blend")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gpcr_stream_blend.argtypes = [
            vp, ci, vp, vp, ci, ci, ci, ci, ci, ci, vp, vp, vp]
        lib.gpcr_stream_blend.restype = ci
        lib.gpcr_stream_blend_contrib.argtypes = [
            vp, ci, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp]
        lib.gpcr_stream_blend_contrib.restype = ci
        if hasattr(lib, "gpcr_count_ring"):  # not in older builds
            lib.gpcr_count_ring.argtypes = [ci, ci, ctypes.POINTER(ci)]
            lib.gpcr_count_ring.restype = ci
        lib.gpcr_cuda_error_string.argtypes = [ci]
        lib.gpcr_cuda_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib


# --------------------------------------------------------------------------
# the serving tile core
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
    bg: T.Optional[torch.Tensor],  # (C,)
    num_tiles: int,
    grid_x: int,
    config: R.RasterizeConfig,
    channels: int,
    tile_base: int = 0,
    tile_count: T.Optional[int] = None,
):
    """Bin + blend + background of tiles [tile_base, tile_base +
    tile_count) of a ``num_tiles`` grid (all of them by default): (out
    (count, P_out, C), final_T (count, P_out), overflow () i64) in local
    tile order. ``bg=None`` leaves the background out (the tile-sharded
    path composites it once the windows are gathered). Tiles render in
    ``render_order``, so ``max_active_tiles`` is a budget per window."""
    count = num_tiles if tile_count is None else tile_count
    window = None if tile_count is None else (tile_base, tile_count)
    with trace.span("gpcr.raster.bin"):
        stream, starts, overflow = bin_sorted_stream(
            prep, num_tiles, grid_x, config, tile_window=window)
    trace.count("entries", stream.shape[0])
    with trace.span("gpcr.raster.order"):
        order, overflow = render_order(starts, overflow, count, config)
    trace.count("tiles_rendered", order.shape[0])
    with trace.span("gpcr.raster.blend"):
        acc, t_run = blend_tiles(stream, starts, order, count, grid_x,
                                 channels, config, tile_base=tile_base)
    if bg is None:
        return acc, t_run, overflow
    out = acc + t_run[..., None] * bg.to(acc.dtype)[None, None, :]
    return out, t_run, overflow


# the serving route: the frame skeleton around ``blend_stream``
STREAM = R.TileCore(blend_stream)
rasterize_gaussians_stream = functools.partial(R.rasterize_frame, STREAM)
