"""Grouped vector attention of Point Transformer V2 (Pointcept's
``GroupedVectorAttention``, ``pe_multiplier=False``, ``pe_bias=True``) over
each point's k nearest neighbours, in evaluation, float32:

    pe_ij  = W2 ReLU(BNp(W1 delta_ij + b1)) + b2
    w_ij   = Wg2 ReLU(BNg(Wg1 (k_j - q_i + pe_ij) + bg1)) + bg2
    a_ij   = softmax over j of w_ij, per group of C / G channels
    out_i  = sum_j a_ij (v_j + pe_ij), per group

computed in its folded form (``fold``): with ``M = BNg o Wg1`` (G x C) the
logits are ``M k_j - M q_i + P h_ij + c0``, ``P = M W2``, ``h_ij =
ReLU(W1' delta_ij + b1')`` (BNp folded), ``c0 = M b2 + bg1'``; and the
position term of the output is ``W2 (sum_j a_ij h_ij) + b2`` per group, W2
applied once per point. No (n, k, C) tensor of the kernel path reaches
memory.

``grouped_vector_attention`` takes q, k, v (n, C), the neighbour list (n,
>= K) and the relative positions (n, >= K, 3) of the plan, and uses their
first K columns. On a CUDA device without a gradient it launches
``csrc/gva.cu`` (one launch; ``M q`` and ``M k`` are two cuBLAS products
before it); on the CPU, or under a gradient, ``gva_plain`` computes the
same folded function with torch ops over blocks of points.
"""

from __future__ import annotations

import ctypes
import typing as T

import torch

from ..utils import trace
from . import cuda_build

GROUP_WIDTH = 8  # channels per group: Pointcept's C / G at every stage
GROUPS = (6, 12, 24, 48, 64)  # the kernel's instantiations (K 8 or 16)
NEIGHBOURS = (8, 16)
PAIR_BUDGET = 1 << 25  # float32 values per (block, G, C) tensor, plain path

# launches of csrc/gva.cu in this process
LAUNCHES = 0


class Folded(T.NamedTuple):
    """The attention's MLP parameters with both BatchNorms folded."""

    w1: torch.Tensor  # (C, 3)
    b1: torch.Tensor  # (C,)
    m: torch.Tensor  # (G, C)
    p: torch.Tensor  # (G, C): M W2
    c0: torch.Tensor  # (G,): M b2 + the weight encoding's first bias
    wg2: torch.Tensor  # (G, G)
    bg2: torch.Tensor  # (G,)
    w2: torch.Tensor  # (C, C)
    b2: torch.Tensor  # (C,)
    pt: torch.Tensor  # (C, G): P^T, contiguous, the kernel's layout
    w2t: torch.Tensor  # (C, C): W2^T, contiguous


def _bn_scale(bn: dict, eps: float):
    scale = bn["weight"] / torch.sqrt(bn["running_var"] + eps)
    return scale, bn["bias"] - bn["running_mean"] * scale


def fold(pe_fc1, pe_norm: dict, pe_fc2, we_fc1, we_norm: dict, we_fc2,
         eps: float) -> Folded:
    """``pe_fc1`` etc. are (weight, bias) pairs, the norms dicts of
    weight, bias, running_mean and running_var."""
    sp, tp = _bn_scale(pe_norm, eps)
    sg, tg = _bn_scale(we_norm, eps)
    m = we_fc1[0] * sg[:, None]
    w2, b2 = pe_fc2
    p = m @ w2
    return Folded(
        w1=pe_fc1[0] * sp[:, None], b1=pe_fc1[1] * sp + tp, m=m, p=p,
        c0=m @ b2 + (we_fc1[1] * sg + tg), wg2=we_fc2[0], bg2=we_fc2[1],
        w2=w2, b2=b2, pt=p.T.contiguous(), w2t=w2.T.contiguous())


def grouped_vector_attention(q, k, v, nbr, delta, neighbours: int,
                             f: Folded) -> torch.Tensor:
    """(n, C) -> (n, C) over the first ``neighbours`` columns of ``nbr``
    (n, >= K) int32 and ``delta`` (n, >= K, 3) float32."""
    n = q.shape[0]
    trace.count("gva_launches", 1)
    trace.count("gva_pairs", n * neighbours)
    if q.device.type == "cpu" or (torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad
            or f.w2.requires_grad)):
        return gva_plain(q, k, v, nbr, delta, neighbours, f)
    return _gva_cuda(q, k, v, nbr, delta, neighbours, f)


def gva_plain(q, k, v, nbr, delta, neighbours: int,
              f: Folded) -> torch.Tensor:
    """The folded function with torch ops (any device, differentiable),
    over blocks of points whose (block, G, C) sums fit ``PAIR_BUDGET``."""
    n, c = q.shape
    g = f.m.shape[0]
    mq, mk = q @ f.m.T, k @ f.m.T
    w2 = f.w2.view(g, c // g, c)
    out = []
    block = max(1, PAIR_BUDGET // (g * c + neighbours * c))
    for b0 in range(0, n, block):
        idx = nbr[b0:b0 + block, :neighbours].long()
        h = torch.relu(delta[b0:b0 + block, :neighbours] @ f.w1.T + f.b1)
        u = mk[idx] - mq[b0:b0 + block, None] + (h @ f.p.T + f.c0)
        a = torch.softmax(torch.relu(u) @ f.wg2.T + f.bg2, dim=1)  # (B, K, G)
        hv = torch.einsum("bkg,bkc->bgc", a, h)  # sum_j a_jg h_j
        val = v[idx].view(idx.shape[0], neighbours, g, c // g)
        y = (torch.einsum("bkgt,bkg->bgt", val, a)
             + torch.einsum("bgc,gtc->bgt", hv, w2))
        out.append(y.reshape(-1, c) + f.b2)
    return torch.cat(out) if out else q.new_empty((0, c))


def check_gva_inputs(q, k, v, nbr, delta, neighbours: int, f: Folded) -> int:
    """Raise on what ``csrc/gva.cu`` does not take (it reads raw
    pointers); returns the number of groups."""
    n, c = q.shape
    g = f.m.shape[0]
    if c != GROUP_WIDTH * g or g not in GROUPS:
        raise ValueError(f"{c} channels in {g} groups: the kernel takes "
                         f"groups {GROUPS} of {GROUP_WIDTH} channels")
    if neighbours not in NEIGHBOURS or (g != 6 and neighbours != 16):
        raise ValueError(f"{neighbours} neighbours at {g} groups: the kernel "
                         "takes 16, and 8 at 6 groups")
    for name, t, shape in (("q", q, (n, c)), ("k", k, (n, c)),
                           ("v", v, (n, c))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or (
                not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 {shape}")
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[0] != n or (
            nbr.shape[1] < neighbours) or not nbr.is_contiguous():
        raise ValueError("nbr must be a contiguous int32 (n, >= K)")
    if delta.dtype != torch.float32 or tuple(delta.shape) != (
            n, nbr.shape[1], 3) or not delta.is_contiguous():
        raise ValueError("delta must be a contiguous float32 (n, nbr width, "
                         "3)")
    for t in (k, v, nbr, delta):
        if t.device != q.device:
            raise ValueError(f"inputs on {t.device} and {q.device}")
    return g


def _gva_cuda(q, k, v, nbr, delta, neighbours: int, f: Folded):
    """Launch ``csrc/gva.cu`` on the current CUDA stream."""
    global LAUNCHES
    g = check_gva_inputs(q, k, v, nbr, delta, neighbours, f)
    n, c = q.shape
    mq = (q @ f.m.T).contiguous()
    mk = (k @ f.m.T).contiguous()
    params = [t.detach().contiguous() for t in (
        f.w1, f.b1, f.pt, f.c0, f.wg2, f.bg2, f.w2t, f.b2)]
    out = torch.empty((n, c), dtype=torch.float32, device=q.device)
    lib = _gva_lib()
    rc = lib.gpcr_gva(
        mq.data_ptr(), mk.data_ptr(), v.data_ptr(), nbr.data_ptr(),
        delta.data_ptr(), nbr.shape[1], n, g, neighbours,
        *[t.data_ptr() for t in params], out.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = lib.gpcr_gva_error_string(rc).decode()
        raise RuntimeError(f"gva launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return out


def _gva_lib():
    lib = cuda_build.load("gva")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gpcr_gva.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                 vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
        lib.gpcr_gva.restype = ci
        lib.gpcr_gva_error_string.argtypes = [ci]
        lib.gpcr_gva_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib
