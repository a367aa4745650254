"""Swin3D's window attention over sparse voxels with its contextual
relative signal encoding (cRSE; Yang et al., "Swin3D", arXiv:2304.06906,
``WindowAttention`` with ``cRSE="XYZ_RGB"``), in evaluation, float32.

The points of a level fall into cubic windows of w cells (``partition``:
window ``floor((cell + shift) / w)`` per axis, any number of points from
1 to w^3 in a window, none dropped). Per window, head h and query i, over
every key j of its window:

    delta_a = clamp(floor((s_ia - s_ja) Q_a) + L_a / 2, 0, L_a - 1)
    e_ij    = q'_i . k_j + sum_a (q'_i . Tq_a[delta_a] + k_j . Tk_a[delta_a])
    o_i     = sum_j softmax_j(e_ij) (v_j + sum_a Tv_a[delta_a])

with q' = d^-0.5 q (Swin3D scales the query before its attention kernel,
so the key-table term is not scaled), the signals s of the six axes a
(position x, y, z in the level's cells, Q = quant size, L = 2 w Q; colour
r, g, b, Q = 2 quant size, L = 2 * 2 * Q), and per block three tables
(bins of the six axes, H, d).

``window_attention`` takes the block's ``qkv`` (n, 3 C) in the points'
order (channel (s H + h) d + t is component s of q, k, v, head h, lane t),
a ``Windows`` partition, the level's signals (n, 6) and the block's
``Tables``, and returns (n, C). On a CUDA device without a gradient it
launches ``csrc/swin_attn.cu`` (head dim 8 or 16; anything else raises:
there is no fallback); on the CPU, or under a gradient,
``window_attention_plain`` computes the same thing with torch ops over
blocks of windows, in the kernel's form: per point the dots of q' and k
with every bin of the tables, per pair the 12 looked-up terms, and the
value term as a per-bin histogram of the probabilities times Tv.
"""

from __future__ import annotations

import ctypes
import typing as T

import torch

from ..utils import trace
from . import cuda_build

HEAD_DIMS = (8, 16)  # the kernel's instantiations: Swin3D-S's C / H
CHUNK = 32  # queries per CTA of the kernel (``Windows.chunks``)
MAX_ROWS = 552  # table rows whose shared memory fits a CTA (227 KB)
PAIR_BUDGET = 1 << 25  # float32 values per (block, H, m, bins) tensor, plain

# launches of csrc/swin_attn.cu in this process
LAUNCHES = 0


class Windows(T.NamedTuple):
    """One partition of a level into windows."""

    perm: torch.Tensor  # (n,) int32: the points by window id, then index
    offsets: torch.Tensor  # (W + 1,) int64 into perm
    chunks: torch.Tensor  # (chunks, 4) int32: start, occupancy, first query, 0
    count: int  # windows
    most: int  # largest occupancy
    pairs: int  # sum over windows of occupancy^2


class Tables(T.NamedTuple):
    """A block's cRSE tables, the bins of x, y, z (``lp`` each, quant
    ``qp``) then r, g, b (``lc`` each, quant ``qc``) along the first axis."""

    q: torch.Tensor  # (3 lp + 3 lc, H, d)
    k: torch.Tensor
    v: torch.Tensor
    lp: int
    lc: int
    qp: float
    qc: float

    def axes(self):
        """(offset, length, quant) of each of the six axes."""
        lp, lc = self.lp, self.lc
        return ([(a * lp, lp, self.qp) for a in range(3)]
                + [(3 * lp + a * lc, lc, self.qc) for a in range(3)])


def partition(cells: torch.Tensor, window: int, shift: int) -> Windows:
    """The windows of ``window`` cells of a level's integer cells (n, 3)
    int64 (counted from 0), shifted by ``shift`` cells."""
    w = torch.div(cells + shift, window, rounding_mode="floor")
    dims = (w.max(dim=0).values + 1).tolist()
    ids = w[:, 0] + dims[0] * (w[:, 1] + dims[1] * w[:, 2])
    perm = torch.argsort(ids, stable=True)
    counts = torch.unique_consecutive(ids[perm], return_counts=True)[1]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    per = (counts + CHUNK - 1) // CHUNK
    win = torch.repeat_interleave(torch.arange(counts.shape[0],
                                               device=cells.device), per)
    first = torch.arange(win.shape[0], device=cells.device) - (
        torch.cumsum(per, 0) - per)[win]
    chunks = torch.stack([offsets[win], counts[win], first * CHUNK,
                          torch.zeros_like(win)], 1)
    return Windows(perm=perm.int().contiguous(), offsets=offsets,
                   chunks=chunks.int().contiguous(), count=counts.shape[0],
                   most=int(counts.max()),
                   pairs=int((counts * counts).sum()))


def window_attention(qkv: torch.Tensor, win: Windows, sig: torch.Tensor,
                     t: Tables, heads: int) -> torch.Tensor:
    """(n, 3 C) -> (n, C) attention within ``win``'s windows."""
    trace.count("swin_attn_launches", 1)
    trace.count("swin_attn_pairs", win.pairs * heads)
    if qkv.device.type == "cpu" or (torch.is_grad_enabled() and (
            qkv.requires_grad or t.q.requires_grad)):
        return window_attention_plain(qkv, win, sig, t, heads)
    return _swin_attn_cuda(qkv, win, sig, t, heads)


def bins(sig_i: torch.Tensor, sig_j: torch.Tensor, t: Tables):
    """(..., 6) int64 table rows of the pairs (query signals ``sig_i``,
    key signals ``sig_j``, broadcast (..., 6)): each axis's bin plus its
    offset."""
    diff = sig_i - sig_j
    out = []
    for a, (off, length, quant) in enumerate(t.axes()):
        b = torch.floor(diff[..., a] * quant).long() + length // 2
        out.append(b.clamp(0, length - 1) + off)
    return torch.stack(out, -1)


def window_attention_plain(qkv: torch.Tensor, win: Windows,
                           sig: torch.Tensor, t: Tables,
                           heads: int) -> torch.Tensor:
    """The plain version (any device, differentiable): windows in blocks
    padded to the block's largest occupancy, whose (block, H, m, bins)
    tensors fit ``PAIR_BUDGET``."""
    n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    rows_of = t.q.shape[0]
    parts = qkv.view(n, 3, heads, d)
    q = parts[:, 0] * d ** -0.5
    k, v = parts[:, 1], parts[:, 2]
    counts = win.offsets[1:] - win.offsets[:-1]
    sizes = counts.tolist()
    perm = win.perm.long()
    out = qkv.new_empty((n, c))
    w0 = 0
    while w0 < win.count:
        m = sizes[w0]
        w1 = w0 + 1
        while w1 < win.count:
            mm = max(m, sizes[w1])
            if (w1 - w0 + 1) * heads * mm * max(mm, rows_of) > PAIR_BUDGET:
                break
            m, w1 = mm, w1 + 1
        slot = torch.arange(m, device=qkv.device)
        valid = slot < counts[w0:w1, None]  # (B, m)
        at = (win.offsets[w0:w1, None] + slot).clamp(max=n - 1)
        rows = perm[at]  # (B, m)
        qb, kb, vb = q[rows], k[rows], v[rows]  # (B, m, H, d)
        s = sig[rows]
        idx = bins(s[:, :, None], s[:, None, :], t)  # (B, i, j, 6)
        aq = torch.einsum("bihd,rhd->bhir", qb, t.q)  # (B, H, m, rows)
        bk = torch.einsum("bjhd,rhd->bhjr", kb, t.k)
        e = torch.einsum("bihd,bjhd->bhij", qb, kb)
        for a in range(6):
            ia = idx[..., a][:, None].expand(-1, heads, -1, -1)  # (B,H,i,j)
            e = e + aq.gather(3, ia) + bk.gather(3, ia.transpose(2, 3)
                                                 ).transpose(2, 3)
        e = e.masked_fill(~valid[:, None, None, :], float("-inf"))
        e = e.masked_fill(~valid[:, None, :, None], 0.0)
        p = torch.softmax(e, dim=-1)  # (B, H, i, j)
        o = torch.einsum("bhij,bjhd->bihd", p, vb)
        hist = p.new_zeros(p.shape[:3] + (rows_of,))
        for a in range(6):
            ia = idx[..., a][:, None].expand(-1, heads, -1, -1)
            hist = hist.scatter_add(3, ia, p)
        o = o + torch.einsum("bhir,rhd->bihd", hist, t.v)
        out[rows[valid]] = o.reshape(w1 - w0, m, c)[valid]
        w0 = w1
    return out


def check_swin_inputs(qkv, win: Windows, sig, t: Tables, heads: int) -> int:
    """Raise on what ``csrc/swin_attn.cu`` does not take (it reads raw
    pointers); returns the head dim."""
    if qkv.dtype != torch.float32 or sig.dtype != torch.float32:
        raise TypeError("window attention takes float32 qkv and signals")
    n, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"qkv width {c3} does not fit {heads} heads")
    d = c3 // (3 * heads)
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    rows = 3 * t.lp + 3 * t.lc
    for name, tab in (("q", t.q), ("k", t.k), ("v", t.v)):
        if tab.dtype != torch.float32 or tuple(tab.shape) != (
                rows, heads, d) or not tab.is_contiguous():
            raise ValueError(f"table {name} must be a contiguous float32 "
                             f"{(rows, heads, d)}")
    if t.lp % 2 or t.lc % 2 or not 0 < rows <= MAX_ROWS:
        raise ValueError(f"bins {t.lp} / {t.lc}: even, at most {MAX_ROWS} "
                         "rows")
    if tuple(sig.shape) != (n, 6) or not sig.is_contiguous() or (
            not qkv.is_contiguous()):
        raise ValueError("qkv and signals (n, 6) must be contiguous")
    if win.perm.dtype != torch.int32 or win.chunks.dtype != torch.int32 or (
            win.perm.shape[0] != n or win.chunks.shape[1] != 4):
        raise ValueError("the partition's perm (n,) and chunks (c, 4) must "
                         "be int32")
    for x in (sig, win.perm, win.chunks, t.q, t.k, t.v):
        if x.device != qkv.device:
            raise ValueError(f"inputs on {x.device} and {qkv.device}")
    return d


def _swin_attn_cuda(qkv, win: Windows, sig, t: Tables, heads: int):
    """Launch ``csrc/swin_attn.cu`` on the current CUDA stream."""
    global LAUNCHES
    d = check_swin_inputs(qkv, win, sig, t, heads)
    n = qkv.shape[0]
    out = torch.empty((n, heads * d), dtype=torch.float32, device=qkv.device)
    tables = [x.detach() for x in (t.q, t.k, t.v)]
    lib = _swin_attn_lib()
    rc = lib.gpcr_swin_attn(
        qkv.data_ptr(), sig.data_ptr(), win.perm.data_ptr(),
        win.chunks.data_ptr(), win.chunks.shape[0], heads, d,
        *[x.data_ptr() for x in tables], t.lp, t.lc, ctypes.c_float(t.qp),
        ctypes.c_float(t.qc), ctypes.c_float(d ** -0.5), out.data_ptr(),
        torch.cuda.current_stream(qkv.device).cuda_stream)
    if rc != 0:
        msg = lib.gpcr_swin_attn_error_string(rc).decode()
        raise RuntimeError(f"swin_attn launch failed: {msg} ({rc})")
    LAUNCHES += 1
    return out


def _swin_attn_lib():
    lib = cuda_build.load("swin_attn")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gpcr_swin_attn.argtypes = [vp, vp, vp, vp, ci, ci, ci, vp, vp, vp,
                                       ci, ci, cf, cf, cf, vp, vp]
        lib.gpcr_swin_attn.restype = ci
        lib.gpcr_swin_attn_error_string.argtypes = [ci]
        lib.gpcr_swin_attn_error_string.restype = ctypes.c_char_p
        lib._gpcr_typed = True
    return lib
