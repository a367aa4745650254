"""Multi-GPU rendering's tile core: one frame's tile grid split over the
ranks of a mesh axis (port of ``gpcr_tpu/parallel/render.py``;
``render_views_sharded`` lives beside ``render_views_fused`` in
``render/renderer.py``).

A frame too large or too slow for one card is split in tile space: every
rank holds the (small) per-gaussian arrays, preprocesses them all, bins
and blends one contiguous window of the tile grid through the serving
kernel (``ops/rasterize_stream.py::blend_stream`` with a window, whose
kernel takes the window's base tile), and the image is assembled from one
``all_gather`` of the windows' (acc, T) blocks.
"""

from __future__ import annotations

from ..ops import rasterize as R
from ..ops import rasterize_stream as RS
from .sharding import Mesh


def window_of(num_tiles: int, n: int, d: int):
    """(base, count) of window ``d`` of an ``n``-way split of ``num_tiles``
    tiles: ceil(num_tiles / n) tiles each, trailing windows running past
    the end of the grid (their tiles have no entries)."""
    per = -(-num_tiles // n)
    return d * per, per


def tile_sharded_core(mesh: Mesh, axis: str = "sp") -> R.TileCore:
    """The tile core of a frame whose tile grid is split over ``axis``,
    for ``ops.rasterize.rasterize_frame``; its result is the same on
    every rank of the axis.

    Rank ``d`` bins and blends window ``d`` (``window_of``); one
    ``all_gather`` per output brings the (acc, T) blocks together, the
    padded tiles are dropped and the background is composited. The
    overflow is the MAX of the windows' overflows: exact for the dup cap
    (the whole frame's, the same on every rank), conservative for a
    per-window ``k_budget`` or ``max_active_tiles``, as in ``gpcr_tpu``.
    ``config.downscale`` 2 halves the tiles, as in the serving core."""

    def blend(prep, bg, num_tiles, grid_x, config, channels):
        base, count = window_of(num_tiles, mesh.shape[axis],
                                mesh.coords[axis])
        acc, t_run, overflow = RS.blend_stream(
            prep, None, num_tiles, grid_x, config, channels, base, count)
        acc = mesh.all_gather(acc, axis)[:num_tiles]
        t_run = mesh.all_gather(t_run, axis)[:num_tiles]
        overflow = mesh.all_reduce(overflow, "max", (axis,))
        out = acc + t_run[..., None] * bg.to(acc.dtype)[None, None, :]
        return out, t_run, overflow

    return R.TileCore(blend)
