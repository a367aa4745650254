"""Sparse voxel convolution engine (port of ``gpcr_tpu/ops/sparse.py``,
the MinkowskiEngine replacement).

Coordinates are non-negative integer voxels packed into one code
``(x << 20) | (y << 10) | z`` (grid <= 1024 per axis) and kept sorted: the
sorted code list is the hash table, and a neighbour lookup is
``torch.searchsorted`` plus an equality check.

Shapes are dynamic: a level holds exactly its voxels (no capacity padding,
no sentinel codes). The differentiable convolutions (``conv``,
``conv_multi``, ``conv_down``, ``conv_up_generative``) are gather-GEMM: for
each kernel offset, ``index_select`` the neighbour rows and ``matmul`` with
that offset's weight, accumulated — never a materialized K³ im2col. A miss
reads an appended zero row.

``conv_map`` runs one convolution over a ``ConvMap`` of a plan: on a CUDA
device and without a gradient, the kernel ``csrc/sparse_conv.cu`` over the
map's ``TiledMap`` (rows sorted by their neighbour mask, tiles of
``TILE_ROWS``; ``tile_map`` builds it at the map's first launch and the map
keeps it, so a cached plan builds it once per cloud and a CPU or gradient
plan never); otherwise the differentiable ops above. ``conv_map_plain`` is
the kernel's plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import typing as T

import torch

from ..utils import trace
from . import cuda_build, segment

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

    def world_coords(self) -> torch.Tensor:
        """Coordinates in the original (stride-1) grid units."""
        return self.coords() * self.stride

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
    return build_offset_map(
        grid, _offsets_cube(kernel_size, device=grid.codes.device))


def build_offset_map(grid: SparseGrid, offs: torch.Tensor) -> torch.Tensor:
    """(N, K) int64 gather indices into grid.feats for the (K, 3) integer
    offsets ``offs``; misses -> N."""
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


# --------------------------------------------------------------------------
# map-driven convolutions: the plan's maps and the CUDA kernel
# --------------------------------------------------------------------------

TILE_ROWS = 64  # rows per tile of a TiledMap; csrc/sparse_conv.cu's kRows

# launches of csrc/sparse_conv.cu in this process (one per conv_map weight
# that reached the kernel); read and reset by callers that need to show a
# run went through the kernel
LAUNCHES = 0


@dataclasses.dataclass
class TiledMap:
    """A convolution's neighbour map as ``csrc/sparse_conv.cu`` reads it.
    Output rows are sorted by their hit mask (bit k: offset k has an input
    row), so the rows of one tile of ``TILE_ROWS`` share most offsets;
    ``pairs`` and ``slots`` are host integers (``pairs / slots`` is the
    fill the kernel reaches)."""

    nbr: torch.Tensor  # (K, n_pad) i32: input row per offset, sorted order; -1 miss
    rows: torch.Tensor  # (n_pad,) i32: output row of each sorted row; -1 pads
    tile_masks: torch.Tensor  # (n_pad // TILE_ROWS,) i32: OR of the rows' masks
    pairs: int  # (output row, offset) pairs with an input row
    slots: int  # (row, offset) slots computed: per tile, TILE_ROWS x its offsets


def tile_map(nbr: torch.Tensor) -> TiledMap:
    """(N, K) input row per (output row, offset) in code order, -1 for a
    miss, K <= 27 -> the TiledMap the kernel reads. Reads ``pairs`` and
    ``slots`` to the host (one sync): built once per cloud."""
    n, k = nbr.shape
    dev = nbr.device
    hit = nbr >= 0
    bits = torch.arange(k, device=dev, dtype=torch.int32)
    masks = (hit.to(torch.int32) << bits).sum(dim=1, dtype=torch.int32)
    order = torch.sort(masks, stable=True).indices
    n_tiles = -(-n // TILE_ROWS)
    pad = n_tiles * TILE_ROWS - n
    fill = torch.full((pad,), -1, dtype=torch.int32, device=dev)
    nbr_s = torch.cat([nbr.index_select(0, order).to(torch.int32).T,
                       fill.expand(k, pad)], dim=1)
    tile_hit = torch.cat([hit.index_select(0, order),
                          hit.new_zeros((pad, k))]).reshape(
        n_tiles, TILE_ROWS, k).any(dim=1)
    tile_masks = (tile_hit.to(torch.int32) << bits).sum(dim=1,
                                                        dtype=torch.int32)
    pairs, tile_offsets = torch.stack(
        [hit.sum(), tile_hit.sum()]).tolist()
    return TiledMap(
        nbr=nbr_s.contiguous(),
        rows=torch.cat([order.to(torch.int32), fill]),
        tile_masks=tile_masks, pairs=int(pairs),
        slots=int(tile_offsets) * TILE_ROWS)


@dataclasses.dataclass
class ConvMap:
    """One convolution of a plan, from the rows of ``src`` to those of
    ``dst``: the arguments of the differentiable ops and, once the kernel
    has run over it, the kernel's ``tiles`` (``tiled_map``).

    kind "cube": stride 1 over ``kmap``'s offsets ((N, 27) for a 3³ conv,
    (N, 25) for a slice of PTv3's 5³ stem; misses N); "down": k2s2,
    each parent sums W[octant] @ child (``parent_slot``, ``octant`` of the
    children); "up": generative k2s2, each fine row reads its parent with
    W[its octant] (the same two, of the fine rows)."""

    kind: str
    src: SparseGrid
    dst: SparseGrid
    kmap: T.Optional[torch.Tensor] = None
    parent_slot: T.Optional[torch.Tensor] = None
    octant: T.Optional[torch.Tensor] = None
    tiles: T.Optional[TiledMap] = None  # built by tiled_map()

    def neighbours(self) -> torch.Tensor:
        """(dst rows, K) int64 input row per offset in code order; -1 for
        a miss."""
        if self.kind == "cube":
            return torch.where(self.kmap < self.src.num, self.kmap,
                               torch.full_like(self.kmap, -1))
        n_fine = self.octant.shape[0]
        fine = torch.arange(n_fine, device=self.octant.device)
        if self.kind == "down":  # a parent's child in its octant's column
            out = torch.full((self.dst.num, 8), -1, dtype=torch.int64,
                             device=self.octant.device)
            out[self.parent_slot, self.octant] = fine
            return out
        if self.kind == "up":  # a fine row's parent in its octant's column
            out = torch.full((n_fine, 8), -1, dtype=torch.int64,
                             device=self.octant.device)
            out[fine, self.octant] = self.parent_slot
            return out
        raise ValueError(f"unknown map kind {self.kind!r}")

    def tiled_map(self) -> TiledMap:
        """The kernel's TiledMap of this map, built on the first call (on
        the device of the map's indices; one host sync) and kept."""
        if self.tiles is None:
            self.tiles = tile_map(self.neighbours())
        return self.tiles


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def conv_map(
    cmap: ConvMap,
    feats_list: T.Sequence[torch.Tensor],  # inputs (src rows, C_i)
    weights: T.Sequence[torch.Tensor],  # (K, C_i, Cout_i)
    biases: T.Sequence[T.Optional[torch.Tensor]],
    relu: bool = False,
) -> T.List[torch.Tensor]:
    """The convolutions of ``cmap`` with each (input, weight, bias), ReLU
    applied where ``relu``: a list of (dst rows, Cout_i).

    CPU tensors, and a call that needs a gradient, take the differentiable
    ops (one shared neighbour gather for a cube map's inputs); any other
    CUDA call launches ``csrc/sparse_conv.cu`` once per weight, and raises
    on what the kernel does not take. There is no fallback."""
    tensors = [*feats_list, *weights, *biases]
    if feats_list[0].device.type == "cpu" or _needs_grad(*tensors):
        outs = _conv_ops(cmap, feats_list, weights, biases)
        return [torch.relu(o) for o in outs] if relu else outs
    if not feats_list[0].is_cuda:
        raise ValueError(f"no sparse conv for device {feats_list[0].device}")
    return [_conv_map_cuda(cmap, f, w, b, relu)
            for f, w, b in zip(feats_list, weights, biases)]


def _conv_ops(cmap, feats_list, weights, biases):
    if cmap.kind == "cube":
        return conv_multi(cmap.src.replace(feats=feats_list[0]), cmap.kmap,
                          feats_list, weights, biases)
    outs = []
    for f, w, b in zip(feats_list, weights, biases):
        src = cmap.src.replace(feats=f)
        if cmap.kind == "down":
            outs.append(conv_down(src, cmap.dst, cmap.parent_slot,
                                  cmap.octant, w, b))
        elif cmap.kind == "up":
            outs.append(conv_up_generative(src, cmap.dst.codes, w, b))
        else:
            raise ValueError(f"unknown map kind {cmap.kind!r}")
    return outs


def conv_map_plain(
    tiles: TiledMap,
    feats: torch.Tensor,  # (src rows, Cin)
    weight: torch.Tensor,  # (K, Cin, Cout)
    bias: T.Optional[torch.Tensor],
    n_out: int,
    relu: bool = False,
) -> torch.Tensor:
    """The plain PyTorch version of the kernel (any device): the sum over
    every (row, offset) pair of ``tiles``, one offset at a time in sorted
    row order, then bias and ReLU. Returns (n_out, Cout)."""
    n_pad = tiles.rows.shape[0]
    out = feats.new_zeros((n_pad, weight.shape[2]))
    for k in range(tiles.nbr.shape[0]):
        j = tiles.nbr[k].long()
        g = feats.index_select(0, j.clamp(min=0))
        g = torch.where((j >= 0)[:, None], g, torch.zeros_like(g))
        out = out + g @ weight[k]
    if bias is not None:
        out = out + bias
    if relu:
        out = torch.relu(out)
    # padded rows (rows == -1) all follow the n_out real ones
    res = feats.new_empty((n_out, weight.shape[2]))
    res[tiles.rows[:n_out].long()] = out[:n_out]
    return res


def check_conv_inputs(cmap: ConvMap, feats, weight, bias) -> None:
    """Raise on what ``csrc/sparse_conv.cu`` does not take: it reads raw
    pointers, so device, dtype, shape and contiguity are checked here.
    Builds the map's TiledMap if it has none yet."""
    tiles = cmap.tiled_map()
    dev = feats.device
    k = tiles.nbr.shape[0]
    named = [("feats", feats, torch.float32), ("weight", weight, torch.float32),
             ("nbr", tiles.nbr, torch.int32), ("rows", tiles.rows, torch.int32),
             ("tile_masks", tiles.tile_masks, torch.int32)]
    if bias is not None:
        named.append(("bias", bias, torch.float32))
    for name, t, dt in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, feats on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if feats.dim() != 2 or feats.shape[0] != cmap.src.num:
        raise ValueError(f"feats shape {tuple(feats.shape)} is not "
                         f"({cmap.src.num}, Cin)")
    if weight.dim() != 3 or weight.shape[0] != k or \
            weight.shape[1] != feats.shape[1]:
        raise ValueError(f"weight shape {tuple(weight.shape)} is not ({k}, "
                         f"{feats.shape[1]}, Cout)")
    if bias is not None and bias.shape != (weight.shape[2],):
        raise ValueError(f"bias must be ({weight.shape[2]},)")
    n_pad = tiles.rows.shape[0]
    if not 1 <= k <= 27 or tiles.nbr.shape != (k, n_pad) or \
            n_pad % TILE_ROWS or tiles.tile_masks.shape != (
                n_pad // TILE_ROWS,):
        raise ValueError("malformed TiledMap")


def _conv_map_cuda(cmap: ConvMap, feats, weight, bias, relu: bool):
    """Launch ``csrc/sparse_conv.cu`` on the current CUDA stream."""
    global LAUNCHES
    check_conv_inputs(cmap, feats, weight, bias)
    tiles = cmap.tiled_map()
    out = torch.empty((cmap.dst.num, weight.shape[2]), dtype=torch.float32,
                      device=feats.device)
    lib = _sparse_conv_lib()
    rc = lib.gpcr_sparse_conv(
        feats.data_ptr(), feats.shape[1], weight.data_ptr(), weight.shape[2],
        None if bias is None else bias.data_ptr(), tiles.nbr.data_ptr(),
        tiles.nbr.shape[0], tiles.rows.data_ptr(),
        tiles.tile_masks.data_ptr(), tiles.tile_masks.shape[0], int(relu),
        out.data_ptr(), torch.cuda.current_stream(feats.device).cuda_stream)
    if rc != 0:
        msg = lib.gpcr_sparse_conv_error_string(rc).decode()
        raise RuntimeError(f"sparse_conv launch failed: {msg} ({rc})")
    LAUNCHES += 1
    trace.count("sparse_conv_launches", 1)
    trace.count("sparse_conv_pairs", tiles.pairs)
    trace.count("sparse_conv_slots", tiles.slots)
    return out


def sparse_conv_plan(cin: int, cout: int) -> dict:
    """The parameters ``csrc/sparse_conv.cu`` takes for a (Cin, Cout)
    conv (builds the library on first use): the consumer group's columns
    ``bn``, its register tile ``tm`` x ``tn``, the chunk ``kc`` of Cin per
    step, the consumer ``groups`` per CTA, the ring's ``stages``, the
    CTA's ``threads`` and dynamic ``smem`` bytes."""
    info = (ctypes.c_int * 8)()
    rc = _sparse_conv_lib().gpcr_sparse_conv_plan(cin, cout, info)
    if rc != 0:
        raise ValueError(f"no sparse conv plan for {cin} -> {cout}")
    return dict(zip(("bn", "tm", "tn", "kc", "groups", "stages", "threads",
                     "smem"), info))


def _sparse_conv_lib():
    lib = cuda_build.load("sparse_conv")
    if not getattr(lib, "_gpcr_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.gpcr_sparse_conv.argtypes = [
            vp, ci, vp, ci, vp, vp, ci, vp, vp, ci, ci, vp, vp]
        lib.gpcr_sparse_conv.restype = ci
        if hasattr(lib, "gpcr_sparse_conv_plan"):  # not in older builds
            lib.gpcr_sparse_conv_plan.argtypes = [ci, ci, ctypes.POINTER(ci)]
            lib.gpcr_sparse_conv_plan.restype = ci
        lib.gpcr_sparse_conv_tile_rows.argtypes = []
        lib.gpcr_sparse_conv_tile_rows.restype = ci
        lib.gpcr_sparse_conv_error_string.argtypes = [ci]
        lib.gpcr_sparse_conv_error_string.restype = ctypes.c_char_p
        if lib.gpcr_sparse_conv_tile_rows() != TILE_ROWS:
            raise RuntimeError("csrc/sparse_conv.cu tiles rows differently "
                               "from ops/sparse.py TILE_ROWS")
        lib._gpcr_typed = True
    return lib


# --------------------------------------------------------------------------
# interpolation / pruning
# --------------------------------------------------------------------------


def interpolate_trilinear(grid: SparseGrid,
                          points: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of the grid's features at continuous points
    (MinkowskiInterpolation), points in the grid's normalized
    coordinates; a corner that is not a voxel (or lies off the grid)
    reads zero. Returns (P, C) float32."""
    base = torch.floor(points)
    frac = points - base
    base = base.long()
    feats_pad = _pad_zero_row(grid.feats)
    out = torch.zeros((points.shape[0], grid.feats.shape[1]),
                      dtype=torch.float32, device=points.device)
    for dx in range(2):
        for dy in range(2):
            for dz in range(2):
                c = base + torch.tensor([dx, dy, dz], device=points.device)
                w = ((frac[:, 0] if dx else 1 - frac[:, 0])
                     * (frac[:, 1] if dy else 1 - frac[:, 1])
                     * (frac[:, 2] if dz else 1 - frac[:, 2]))
                in_range = torch.all((c >= 0) & (c < GRID_MAX), dim=-1)
                idx, found = lookup(grid.codes,
                                    pack_coords(c.clamp(0, GRID_MAX - 1)))
                found = found & in_range
                idx = torch.where(found, idx, torch.full_like(idx, grid.num))
                out = out + (w[:, None] * feats_pad[idx]) * found[:, None]
    return out


def prune(grid: SparseGrid, keep: torch.Tensor) -> SparseGrid:
    """Drop the voxels where ``keep`` is False (MinkowskiPruning). The
    survivors stay in code order."""
    keep = keep.bool()
    return grid.replace(codes=grid.codes[keep], feats=grid.feats[keep])
