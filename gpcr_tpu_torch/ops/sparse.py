"""Sparse voxel convolution engine (port of ``gpcr_tpu/ops/sparse.py``,
the MinkowskiEngine replacement).

Coordinates are non-negative integer voxels packed into one code
``(x << 20) | (y << 10) | z`` (grid <= 1024 per axis) and kept sorted: the
sorted code list is the hash table, and a neighbour lookup is
``torch.searchsorted`` plus an equality check.

Shapes are dynamic: a level holds exactly its voxels (no capacity padding,
no sentinel codes). Convolutions are gather-GEMM: for each kernel offset,
``index_select`` the neighbour rows and ``matmul`` with that offset's
weight, accumulated — never a materialized K³ im2col. A miss reads an
appended zero row.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch

from . import segment

GRID_BITS = 10  # coordinates < 1024 per axis
GRID_MAX = 1 << GRID_BITS


def pack_coords(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) int -> (N,) int64 lexicographic code."""
    c = coords.long()
    return (c[:, 0] << (2 * GRID_BITS)) | (c[:, 1] << GRID_BITS) | c[:, 2]


def unpack_coords(codes: torch.Tensor) -> torch.Tensor:
    mask = GRID_MAX - 1
    x = (codes >> (2 * GRID_BITS)) & mask
    y = (codes >> GRID_BITS) & mask
    z = codes & mask
    return torch.stack([x, y, z], dim=-1)


@dataclasses.dataclass
class SparseGrid:
    """A sorted sparse voxel tensor at one resolution level. Codes are of
    coordinates NORMALIZED by the level stride (kernel offsets are unit
    steps); ``stride`` is the world stride."""

    codes: torch.Tensor  # (N,) int64, strictly ascending
    feats: torch.Tensor  # (N, C)
    stride: int = 1

    @property
    def num(self) -> int:
        return self.codes.shape[0]

    def coords(self) -> torch.Tensor:
        return unpack_coords(self.codes)

    def replace(self, **kw) -> "SparseGrid":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# construction / quantization
# --------------------------------------------------------------------------


def quantize_average(
    coords_f: torch.Tensor,  # (N, 3) float, rounded here
    feats: torch.Tensor,  # (N, C)
    valid: T.Optional[torch.Tensor] = None,  # (N,)
) -> SparseGrid:
    """Round to integer voxels and average the features of duplicates
    (MinkowskiEngine UNWEIGHTED_AVERAGE quantization)."""
    coords = torch.clamp(torch.round(coords_f), 0, GRID_MAX - 1).long()
    codes = pack_coords(coords)
    if valid is not None:
        keep = valid.bool()
        codes, feats = codes[keep], feats[keep]
    ucodes, inv = torch.unique(codes, sorted=True, return_inverse=True)
    fmean = segment.segment_mean(feats, inv, ucodes.shape[0])
    return SparseGrid(codes=ucodes, feats=fmean, stride=1)


# --------------------------------------------------------------------------
# kernel maps
# --------------------------------------------------------------------------


def _offsets_cube(k: int, device=None) -> torch.Tensor:
    """K³ integer offsets in MinkowskiEngine order: the FIRST axis varies
    fastest; odd kernels span -(k//2)..k//2, even kernels 0..k-1."""
    if k % 2 == 1:
        rng = torch.arange(-(k // 2), k // 2 + 1, device=device)
    else:
        rng = torch.arange(0, k, device=device)
    ox = rng.repeat(k * k)
    oy = rng.repeat_interleave(k).repeat(k)
    oz = rng.repeat_interleave(k * k)
    return torch.stack([ox, oy, oz], dim=-1)  # (k³, 3)


def lookup(codes_sorted: torch.Tensor, queries: torch.Tensor):
    """Find query codes in a sorted code list. Returns (idx, found); misses
    get idx == len(codes_sorted), the zero row callers append."""
    n = codes_sorted.shape[0]
    if n == 0:
        return (torch.zeros_like(queries),
                torch.zeros(queries.shape, dtype=torch.bool,
                            device=queries.device))
    pos = torch.searchsorted(codes_sorted, queries)
    pos_c = torch.clamp(pos, max=n - 1)
    found = codes_sorted[pos_c] == queries
    return torch.where(found, pos_c, torch.full_like(pos_c, n)), found


def build_kernel_map(grid: SparseGrid, kernel_size: int) -> torch.Tensor:
    """(N, K³) int64 gather indices into grid.feats; misses -> N. Built
    once per coordinate set and shared by every conv at that level."""
    offs = _offsets_cube(kernel_size, device=grid.codes.device)
    nbr = grid.coords()[:, None, :] + offs[None, :, :]  # (N, K, 3)
    in_range = torch.all((nbr >= 0) & (nbr < GRID_MAX), dim=-1)
    q = pack_coords(nbr.reshape(-1, 3).clamp(0, GRID_MAX - 1)).reshape(
        nbr.shape[:2])
    idx, _ = lookup(grid.codes, q)
    return torch.where(in_range, idx, torch.full_like(idx, grid.num))


# --------------------------------------------------------------------------
# convolutions
# --------------------------------------------------------------------------


def _pad_zero_row(feats: torch.Tensor) -> torch.Tensor:
    return torch.cat([feats, feats.new_zeros((1, feats.shape[1]))], dim=0)


def conv(
    grid: SparseGrid,
    kmap: torch.Tensor,  # (N, K³) from build_kernel_map
    weight: torch.Tensor,  # (K³, Cin, Cout)
    bias: T.Optional[torch.Tensor] = None,  # (Cout,)
) -> torch.Tensor:
    """Stride-1 sparse conv on a fixed coordinate set -> (N, Cout)."""
    return conv_multi(grid, kmap, [grid.feats], [weight], [bias])[0]


def conv_multi(
    grid: SparseGrid,
    kmap: torch.Tensor,  # (N, K³)
    feats_list: T.Sequence[torch.Tensor],  # inputs (N, C_i) on grid's coords
    weights: T.Sequence[torch.Tensor],  # (K³, C_i, Cout_i)
    biases: T.Sequence[T.Optional[torch.Tensor]],
) -> T.List[torch.Tensor]:
    """Several stride-1 convs over the SAME kernel map with ONE neighbour
    gather per offset (inputs channel-concatenated)."""
    packed = _pad_zero_row(torch.cat(list(feats_list), dim=-1))
    splits = [f.shape[1] for f in feats_list]
    n = kmap.shape[0]
    outs = [packed.new_zeros((n, w.shape[2])) for w in weights]
    for o in range(kmap.shape[1]):
        g = packed.index_select(0, kmap[:, o])
        lo = 0
        for j, (w, c) in enumerate(zip(weights, splits)):
            outs[j] = outs[j] + g[:, lo:lo + c] @ w[o]
            lo += c
    return [out if b is None else out + b for out, b in zip(outs, biases)]


def _octant(coords: torch.Tensor) -> torch.Tensor:
    """ME k2s2 kernel index of a child voxel: x&1 * 4 + y&1 * 2 + z&1."""
    return (coords[:, 0] & 1) * 4 + (coords[:, 1] & 1) * 2 + (coords[:, 2] & 1)


def downsample_coords(grid: SparseGrid):
    """Unique parent voxels (coord >> 1). Returns (parent_grid (codes only,
    zero feats, stride x2), parent_slot (N,), octant (N,))."""
    coords = grid.coords()
    pcodes = pack_coords(coords >> 1)
    ucodes, parent_slot = torch.unique(pcodes, sorted=True,
                                       return_inverse=True)
    pgrid = SparseGrid(
        codes=ucodes,
        feats=grid.feats.new_zeros((ucodes.shape[0], grid.feats.shape[1])),
        stride=grid.stride * 2,
    )
    return pgrid, parent_slot, _octant(coords)


def conv_down(
    grid: SparseGrid,
    parent_grid: SparseGrid,
    parent_slot: torch.Tensor,  # (N,) from downsample_coords
    octant: torch.Tensor,  # (N,)
    weight: torch.Tensor,  # (8, Cin, Cout)
    bias: T.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k2s2 downsampling conv: each parent sums W_octant @ child over its
    children (per-child transform, then a segment sum into parents)."""
    out_i = grid.feats.new_zeros((grid.num, weight.shape[2]))
    for o in range(8):
        m = octant == o
        out_i[m] = grid.feats[m] @ weight[o]
    out = segment.segment_sum(out_i, parent_slot, parent_grid.num)
    return out if bias is None else out + bias


def conv_up_generative(
    coarse: SparseGrid,
    fine_codes: torch.Tensor,  # (M,) target coords (the encoder level)
    weight: torch.Tensor,  # (8, Cin, Cout)
    bias: T.Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generative transposed conv k2s2 onto a cached finer coordinate set
    (MinkowskiGenerativeConvolutionTranspose with a coordinate_map_key
    target): each fine voxel reads its parent and the weight of its
    octant. Returns (M, Cout)."""
    fcoords = unpack_coords(fine_codes)
    pidx, _ = lookup(coarse.codes, pack_coords(fcoords >> 1))
    pf = _pad_zero_row(coarse.feats).index_select(0, pidx)
    octant = _octant(fcoords)
    out = pf.new_zeros((fine_codes.shape[0], weight.shape[2]))
    for o in range(8):
        m = octant == o
        out[m] = pf[m] @ weight[o]
    return out if bias is None else out + bias
