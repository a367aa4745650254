"""Serialized patch attention of Point Transformer V3: per patch of K
consecutive points of an order and per head, softmax(q k^T d^-0.5) v in
float32, written back in the voxel order.

``patch_attention`` takes the block's ``qkv`` (N, 3 C) in the voxel order
(channel (s H + h) d + j is component s of q, k, v, head h, lane j) and one
order's ``serialize.Patches``, and returns (N, C) with channel h d + j. On a
CUDA device and without a gradient it launches ``csrc/patch_attn.cu``
(head dim 16; anything else raises: there is no fallback); on the
CPU, or under a gradient, ``patch_attention_plain`` computes the same thing
with torch ops over blocks of patches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import trace
from . import cuda_build
from .serialize import Patches

HEAD_DIM = 16  # the kernel's one instantiation: Pointcept's C / H
SCORE_BUDGET = 1 << 26  # float32 scores per block of patches on the plain path

# launches of csrc/patch_attn.cu in this process
LAUNCHES = 0


def patch_attention(qkv: torch.Tensor, pt: Patches,
                    heads: int) -> torch.Tensor:
    """(N, 3 C) -> (N, C) attention over ``pt``'s patches."""
    trace.count("attn_patches", pt.patches)
    trace.count("attn_pairs", pt.patches * heads * pt.k * pt.k)
    trace.count("attn_pad_rows", pt.pad_rows_shared)
    if qkv.device.type == "cpu" or (torch.is_grad_enabled()
                                    and qkv.requires_grad):
        return patch_attention_plain(qkv, pt, heads)
    return _patch_attention_cuda(qkv, pt, heads)


def patch_attention_plain(qkv: torch.Tensor, pt: Patches,
                          heads: int) -> torch.Tensor:
    """The plain version (any device): gather each patch's rows, attend in
    blocks of patches whose scores fit ``SCORE_BUDGET``, keep each voxel's
    slot."""
    n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    k = pt.k
    out = qkv.new_empty((pt.patches * k, c))
    per = max(1, SCORE_BUDGET // (heads * k * k))
    for p0 in range(0, pt.patches, per):
        rows = pt.pad_rows[p0 * k:(p0 + per) * k]
        t = qkv.index_select(0, rows).view(-1, k, 3, heads, d)
        q, kk, v = t.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, K, d)
        attn = torch.softmax((q * d ** -0.5) @ kk.transpose(-2, -1), dim=-1)
        out[p0 * k:p0 * k + rows.shape[0]] = (
            (attn @ v).transpose(1, 2).reshape(-1, c))
    return out.index_select(0, pt.unpad_slots)


def check_attn_inputs(qkv: torch.Tensor, pt: Patches, heads: int) -> int:
    """Raise on what ``csrc/patch_attn.cu`` does not take (it reads raw
    pointers); returns the head dim."""
    if qkv.dtype != torch.float32 or pt.order.dtype != torch.int32:
        raise TypeError("patch attention takes float32 qkv, int32 order")
    if not qkv.is_contiguous() or not pt.order.is_contiguous():
        raise ValueError("qkv and order must be contiguous")
    if pt.order.device != qkv.device:
        raise ValueError(f"order is on {pt.order.device}, qkv on "
                         f"{qkv.device}")
    n, c3 = qkv.shape
    if n != pt.n or c3 % (3 * heads):
        raise ValueError(f"qkv shape {tuple(qkv.shape)} does not fit {pt.n} "
                         f"points and {heads} heads")
    d = c3 // (3 * heads)
    if d != HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIM}")
    if not 1 <= pt.k <= n:
        raise ValueError(f"patch size {pt.k} for {n} points")
    return d


def _patch_attention_cuda(qkv, pt: Patches, heads: int) -> torch.Tensor:
    """Launch ``csrc/patch_attn.cu`` on the current CUDA stream."""
    global LAUNCHES
    d = check_attn_inputs(qkv, pt, heads)
    out = torch.empty((pt.n, heads * d), dtype=torch.float32,
                      device=qkv.device)
    lib = _patch_attn_lib()
    rc = lib.gpcr_patch_attn(
        qkv.data_ptr(), qkv.shape[1], pt.order.data_ptr(), pt.n, pt.k,
        heads, d, ctypes.c_float(math.log2(math.e) / math.sqrt(d)),
        out.data_ptr(), torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        msg = lib.gpcr_patch_attn_error_string(rc).decode()
        raise RuntimeError(f"patch_attn launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return out


def _patch_attn_lib():
    lib = cuda_build.load("patch_attn")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gpcr_patch_attn.argtypes = [vp, ci, vp, ci, ci, ci, ci,
                                        ctypes.c_float, vp, vp]
        lib.gpcr_patch_attn.restype = ci
        lib.gpcr_patch_attn_error_string.argtypes = [ci]
        lib.gpcr_patch_attn_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib
