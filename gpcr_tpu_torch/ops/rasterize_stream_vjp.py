"""Differentiable stream rasterizer: a ``torch.autograd.Function`` whose
forward is the stream blend with a contributor count and whose backward
is the replay kernel (port of ``gpcr_tpu/ops/rasterize_stream_vjp.py``).

The Function sits at the bin + blend boundary, so ordinary autograd
handles ``preprocess`` (EWA projection, SH, quaternions) on both sides:

- forward: ``bin_sorted_stream`` -> ``blend_tiles(with_contrib=True)``
  (``csrc/stream_blend.cu``) -> ``acc + T * bg``; the stream, the final
  transmittance and the per-pixel contributor count are kept;
- backward: ``blend_tiles_bwd`` (``csrc/stream_blend_bwd.cu``) splits
  each rendered tile's range into segments (``segment_plan``), walks each
  back to front from its segment factors and writes one gradient row per
  entry, ``[dmean2d(2), dconic(3), dopacity, 0, 0, dfeat(C)]``; the
  epilogue here adds entry rows into per-rank rows, permutes ranks back to
  the original gaussian order, and forms ``d bg = sum T * g_out``.

Gradient semantics follow ``gpcr_tpu``: no gradient through the 1/255
skip, the power > 0 skip, entries at or past a pixel's contributor count,
or the depth order; at the 0.99 alpha clamp the clamped branch has zero
gradient to power and opacity.

Not ported from the JAX module, because they exist only for the TPU
kernel's way of writing its output: the "written" mask of the epilogue
(Pallas output memory is uninitialised and chunks are written full width;
here ``grads`` is allocated with ``torch.zeros`` and the kernel writes
only rows of its own range) and the ascending tile order (which lets a
later tile overwrite an earlier tile's zero spill; here no row is written
by two tiles). ``tiles_per_step`` and the shift scans are TPU devices too.

For CUDA tensors the wrappers launch the kernels or raise; the plain
PyTorch versions run for CPU tensors only.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from . import rasterize as R
from . import rasterize_stream as S

# launches of the CUDA replay-backward kernel in this process
LAUNCHES_BWD = 0


# --------------------------------------------------------------------------
# replay backward: kernel wrapper and its plain version
# --------------------------------------------------------------------------


def blend_tiles_bwd(
    stream: torch.Tensor,     # (E, 8 + C) f32, the forward's stream
    starts: torch.Tensor,     # (num_tiles + 1,) i32
    order: torch.Tensor,      # (G,) i32 rendered tiles
    dl_dout: torch.Tensor,    # (num_tiles, P, C) f32 upstream of acc
    n_contrib: torch.Tensor,  # (num_tiles, P) i32 from the forward
    dt_tot: torch.Tensor,     # (num_tiles, P) f32 upstream of final T
    t_final: torch.Tensor,    # (num_tiles, P) f32 from the forward
    grid_x: int,
    channels: int,
    config: R.RasterizeConfig,
) -> torch.Tensor:
    """Per-entry gradient rows (E, 8 + C) of the blend: columns
    [dmean2d.x, dmean2d.y, dconic.x, dconic.y, dconic.z, dopacity, 0, 0,
    dfeat(C)]. Rows of tiles not in ``order`` are zero. CUDA tensors run
    the CUDA kernel, CPU tensors the plain PyTorch version."""
    if stream.is_cuda:
        return _blend_tiles_bwd_cuda(
            stream, starts, order, dl_dout, n_contrib, dt_tot, t_final,
            grid_x, channels, config)
    if stream.device.type != "cpu":
        raise ValueError(f"no blend backward for device {stream.device}")
    return blend_tiles_bwd_plain(
        stream, starts, order, dl_dout, n_contrib, dt_tot, t_final,
        grid_x, channels, config)


def blend_tiles_bwd_plain(stream, starts, order, dl_dout, n_contrib, dt_tot,
                          t_final, grid_x, channels,
                          config: R.RasterizeConfig) -> torch.Tensor:
    """The plain PyTorch version of the replay-backward kernel (any
    device).

    Vectorised over (tile batch, chunk, pixel). Each batch walks its
    chunks in reverse; within a chunk the per-entry transmittance is
    T_out times the inclusive suffix product of 1 / (1 - a) and the
    behind-colour term B is B_out plus the exclusive suffix sum of
    a * T_excl * G (flipped ``cumprod`` / ``cumsum`` along the entry
    axis), with (T_out, B_out) carried from the chunk behind.
    """
    tx, ty = config.tile_x, config.tile_y
    p = tx * ty
    chunk = config.chunk_size
    dev = stream.device
    c0 = S.STREAM_FEAT_COL
    n_rows, ncols = stream.shape
    grads = torch.zeros((n_rows, ncols), dtype=torch.float32, device=dev)
    lx = (torch.arange(p, device=dev) % tx).to(torch.float32)
    ly = (torch.arange(p, device=dev) // tx).to(torch.float32)
    steps = torch.arange(chunk, device=dev)

    order = order.long()
    for b0 in range(0, order.numel(), config.tile_batch):
        tiles = order[b0:b0 + config.tile_batch]
        s = starts[tiles].long()
        e = starts[tiles + 1].long()
        nc = n_contrib[tiles].long()  # (B, P)
        # entries past every pixel's contributor count have a == 0
        lim = torch.minimum(e - s, nc.amax(dim=1))
        max_lim = int(lim.max())
        if max_lim == 0:
            continue
        px = ((tiles % grid_x) * tx).to(torch.float32)[:, None] + lx[None]
        py = ((tiles // grid_x) * ty).to(torch.float32)[:, None] + ly[None]
        px = px[:, None, :]  # (B, 1, P)
        py = py[:, None, :]
        dL = dl_dout[tiles]  # (B, P, C)
        T_out = t_final[tiles]  # (B, P)
        B_out = T_out * dt_tot[tiles]
        nch = -(-max_lim // chunk)
        for c in range(nch - 1, -1, -1):
            k0 = c * chunk
            pos = k0 + steps[:min(chunk, max_lim - k0)]  # in-tile index
            idx = s[:, None] + pos[None, :]  # (B, rows)
            in_lim = pos[None, :] < lim[:, None]  # (B, rows)
            rows = stream[torch.clamp(idx, max=n_rows - 1)]
            con_x, con_y, con_z = (rows[:, :, 2:3], rows[:, :, 3:4],
                                   rows[:, :, 4:5])
            dx = rows[:, :, 0:1] - px  # (B, rows, P)
            dy = rows[:, :, 1:2] - py
            power = -0.5 * (con_x * dx * dx + con_z * dy * dy) - con_y * dx * dy
            gauss = torch.exp(power)
            alpha_raw = rows[:, :, 5:6] * gauss
            alpha = torch.clamp(alpha_raw, max=0.99)
            contrib = (pos[None, :, None] < nc[:, None, :]) & in_lim[:, :, None]
            zero = torch.zeros_like(alpha)
            a = torch.where(
                (power > 0.0) | (alpha < (1.0 / 255.0)) | ~contrib, zero, alpha)
            r_om = 1.0 / (1.0 - a)  # 1 - a >= 0.01 where a > 0
            sp = torch.flip(torch.cumprod(torch.flip(r_om, [1]), dim=1), [1])
            T_excl = T_out[:, None, :] * sp
            feat = rows[:, :, c0:c0 + channels]  # (B, rows, C)
            G = torch.bmm(feat, dL.transpose(1, 2))  # (B, rows, P)
            contr = a * T_excl * G
            suffix = torch.flip(torch.cumsum(torch.flip(contr, [1]), dim=1), [1])
            B = B_out[:, None, :] + (suffix - contr)
            live = a > 0.0
            dL_da = torch.where(live, T_excl * G - B * r_om, zero)
            unclamped = live & (alpha_raw < 0.99)
            dpow = torch.where(unclamped, dL_da * a, zero)
            dop_px = torch.where(unclamped, dL_da * gauss, zero)
            w = a * T_excl
            grow = torch.zeros((*idx.shape, ncols), dtype=torch.float32,
                               device=dev)
            grow[:, :, 0] = torch.sum(-dpow * (con_x * dx + con_y * dy), dim=2)
            grow[:, :, 1] = torch.sum(-dpow * (con_z * dy + con_y * dx), dim=2)
            grow[:, :, 2] = torch.sum(-0.5 * dpow * dx * dx, dim=2)
            grow[:, :, 3] = torch.sum(-dpow * dx * dy, dim=2)
            grow[:, :, 4] = torch.sum(-0.5 * dpow * dy * dy, dim=2)
            grow[:, :, 5] = torch.sum(dop_px, dim=2)
            grow[:, :, c0:c0 + channels] = torch.bmm(w, dL)
            grads[idx[in_lim]] = grow[in_lim]
            T_out = T_out * sp[:, 0, :]
            B_out = B_out + contr.sum(dim=1)
    return grads


def _blend_tiles_bwd_cuda(stream, starts, order, dl_dout, n_contrib, dt_tot,
                          t_final, grid_x, channels,
                          config: R.RasterizeConfig) -> torch.Tensor:
    """Launch ``csrc/stream_blend_bwd.cu`` on the current CUDA stream."""
    global LAUNCHES_BWD
    num_tiles = starts.shape[0] - 1
    S.check_blend_inputs(stream, starts, order, num_tiles, channels, config)
    dev = stream.device
    for name, t, dt, shape in (
            ("dl_dout", dl_dout, torch.float32, (num_tiles, 256, channels)),
            ("n_contrib", n_contrib, torch.int32, (num_tiles, 256)),
            ("dt_tot", dt_tot, torch.float32, (num_tiles, 256)),
            ("t_final", t_final, torch.float32, (num_tiles, 256))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, stream on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    grads = torch.zeros_like(stream)
    if order.numel() == 0 or stream.shape[0] == 0:
        return grads
    lib = _stream_blend_bwd_lib()
    seg_len = lib.gpcr_bwd_segment_length(config.chunk_size)
    plan, n_seg_bound = segment_plan(starts, order, n_contrib, seg_len,
                                     stream.shape[0])
    scratch = torch.empty((n_seg_bound, 2, 256), dtype=torch.float32,
                          device=dev)
    rc = lib.gpcr_stream_blend_bwd(
        stream.data_ptr(), stream.shape[1], starts.data_ptr(),
        order.data_ptr(), order.numel(), grid_x, channels, config.chunk_size,
        dl_dout.data_ptr(), n_contrib.data_ptr(), dt_tot.data_ptr(),
        t_final.data_ptr(), grads.data_ptr(), plan.data_ptr(), n_seg_bound,
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        msg = lib.gpcr_bwd_cuda_error_string(rc).decode()
        raise RuntimeError(f"stream_blend_bwd launch failed: {msg} ({rc})")
    LAUNCHES_BWD += 1
    return grads


def segment_plan(starts, order, n_contrib, seg_len: int, n_entries: int):
    """How the replay-backward kernel splits the rendered tiles into
    segments of ``seg_len`` entries: (plan (2, G) int32, n_seg_bound).

    plan[1] is each ordered tile's walked range lim = min(range, max
    n_contrib over its pixels) (entries past it have a == 0 at every
    pixel); plan[0] the inclusive prefix sum of ceil(lim / seg_len), so
    segment b belongs to the first tile whose plan[0] exceeds b.
    n_seg_bound = ceil(n_entries / seg_len) + G is at least the number of
    segments (lim <= range and the ranges are disjoint), so the grid is
    sized without reading plan back to the host."""
    o = order.long()
    lim = torch.minimum((starts[1:] - starts[:-1])[o],
                        n_contrib[o].amax(dim=1))
    nseg = (lim + seg_len - 1) // seg_len
    plan = torch.stack([torch.cumsum(nseg, 0), lim.long()])
    return (plan.to(torch.int32).contiguous(),
            -(-n_entries // seg_len) + order.numel())


def _stream_blend_bwd_lib():
    lib = cuda_build.load("stream_blend_bwd")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gpcr_stream_blend_bwd.argtypes = [
            vp, ci, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp, ci, vp, vp]
        lib.gpcr_stream_blend_bwd.restype = ci
        lib.gpcr_bwd_segment_length.argtypes = [ci]
        lib.gpcr_bwd_segment_length.restype = ci
        lib.gpcr_bwd_cuda_error_string.argtypes = [ci]
        lib.gpcr_bwd_cuda_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib


# --------------------------------------------------------------------------
# autograd Function at the bin + blend boundary
# --------------------------------------------------------------------------


class _BlendCore(torch.autograd.Function):
    """(mean2d, conic, opacity, features, bg | depth, rect, valid) ->
    (out (num_tiles, P, C), T (num_tiles, P), overflow). The first five
    inputs are differentiable; depth, rect and valid get no gradient and
    the overflow count is marked non-differentiable."""

    @staticmethod
    def forward(ctx, mean2d, conic, opacity, features, bg, depth, rect, valid,
                num_tiles, grid_x, config, channels):
        n = mean2d.shape[0]
        prep = R.Preprocessed(
            valid=valid, depth=depth, mean2d=mean2d, conic=conic,
            radius=torch.zeros((n,), dtype=torch.float32,
                               device=mean2d.device),
            rect=rect, features=features.to(torch.float32), opacity=opacity)
        stream, starts, overflow, sorted_rank, gidx_s = S.bin_sorted_stream(
            prep, num_tiles, grid_x, config, return_entries=True)
        order, overflow = S.render_order(starts, overflow, num_tiles, config)
        acc, t_run, n_contrib = S.blend_tiles(
            stream, starts, order, num_tiles, grid_x, channels, config,
            with_contrib=True)
        bg = bg.to(acc.dtype)
        out = acc + t_run[..., None] * bg[None, None, :]
        ctx.save_for_backward(stream, starts, order, sorted_rank, gidx_s,
                              t_run, n_contrib, bg)
        ctx.meta = (n, grid_x, config, channels, features.dtype)
        ctx.mark_non_differentiable(overflow)
        return out, t_run, overflow

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_out, g_t, _g_overflow):
        (stream, starts, order, sorted_rank, gidx_s, t_run, n_contrib,
         bg) = ctx.saved_tensors
        n, grid_x, config, channels, feat_dtype = ctx.meta
        # an output the loss does not use arrives as zeros (autograd
        # materialises undefined gradients), never as None
        g_out = g_out.contiguous()
        dt_tot = g_t + torch.einsum("tpc,c->tp", g_out, bg)
        grads = blend_tiles_bwd(
            stream, starts, order, g_out, n_contrib, dt_tot.contiguous(),
            t_run, grid_x, channels, config)
        # epilogue: entry rows -> per-rank rows -> original gaussian order
        # (rank r belongs to gaussian gidx_s[r])
        cols = S.STREAM_FEAT_COL + channels
        per_rank = torch.zeros((n, cols), dtype=torch.float32,
                               device=grads.device)
        per_rank.index_add_(0, sorted_rank, grads[:, :cols])
        per_g = torch.empty_like(per_rank)
        per_g[gidx_s] = per_rank
        d_bg = torch.einsum("tp,tpc->c", t_run, g_out)
        return (per_g[:, 0:2], per_g[:, 2:5], per_g[:, 5],
                per_g[:, 8:8 + channels].to(feat_dtype), d_bg,
                None, None, None, None, None, None, None)


def blend_stream_diff(prep: R.Preprocessed, bg, num_tiles: int, grid_x: int,
                      config: R.RasterizeConfig, channels: int):
    """The differentiable tile core: ``_BlendCore`` on ``prep``'s fields,
    at native resolution. Gradients of preprocess (means3d / scales /
    rotations / shs) flow through ordinary autograd outside the
    Function."""
    return _BlendCore.apply(
        prep.mean2d, prep.conic, prep.opacity, prep.features, bg,
        prep.depth.detach(), prep.rect, prep.valid,
        num_tiles, grid_x, config, channels)


# the differentiable route: drop-in for ``rasterize_gaussians`` with
# ``differentiable=True``; ``downscale`` is forced to 1 (resize outside)
DIFF = R.TileCore(blend_stream_diff, native=True)
rasterize_gaussians_stream_diff = functools.partial(R.rasterize_frame, DIFF)
