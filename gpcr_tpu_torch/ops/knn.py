"""Exact k nearest neighbours in a point set, for plan-time geometry
(``pointops.knn_query``): of the points themselves (Point Transformer V2's
neighbour lists) or of the points of another set (Swin3D's downsampling,
16 fine points per coarse one, and its upsampling, 3 coarse points per
fine one).

Squared distances are ``dx^2 + dy^2 + dz^2`` in float64; neighbours come
in (distance, index) order, so in a set's own lists each point is its own
first neighbour, and ties go to the smaller index. The search is a uniform
grid of cubic cells over the points and the queries: each query orders
the points of the 3^3 cells around its own, which is exact once its k-th
distance is below the cell width (every point outside those cells lies
farther than one width); queries that miss it (too few points near them,
or a far k-th neighbour) search again with cells twice as wide, until the
cells cover both sets. Torch ops on the points' device, in chunks of
queries whose candidate table fits ``BUDGET``; a build reads a few sizes to
the host (plan time only, never per request).
"""

from __future__ import annotations

import typing as T

import torch

from ..utils import trace

BUDGET = 1 << 24  # candidate slots per chunk of queries
MARGIN = 1e-9  # relative: the k-th distance must stay below the width


def _cube(device) -> torch.Tensor:
    r = torch.arange(-1, 2, device=device)
    return torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(-1, 3)


class _Cells:
    """The points sorted into cubic cells of width ``width``, and the
    queries' cells (the points' own without ``queries``)."""

    def __init__(self, coords, width, origin, queries=None):
        self.cc = torch.floor((coords - origin) / width).long()
        self.qc = self.cc if queries is None else torch.floor(
            (queries - origin) / width).long()
        self.dims = (torch.maximum(self.cc.max(dim=0).values,
                                   self.qc.max(dim=0).values) + 1).tolist()
        cid = self._id(self.cc)
        self.order = torch.argsort(cid, stable=True)  # index order within
        self.sorted = cid[self.order]
        self.most = int(torch.unique_consecutive(
            self.sorted, return_counts=True)[1].max())

    def _id(self, c):
        d = self.dims
        return c[..., 0] + d[0] * (c[..., 1] + d[1] * c[..., 2])

    def covers_all(self) -> bool:
        """Every query's 3^3 cells hold every point."""
        return max(self.dims) <= 2


def _search(coords, qxyz, queries, k, cells: _Cells):
    """(neighbours (Q, k), k-th squared distance (Q,), +inf where fewer than
    k points lie in the 3^3 cells, candidates evaluated) of the queries
    ``queries`` (indices), at ``qxyz`` (Q, 3)."""
    n = coords.shape[0]
    dev = coords.device
    qc = cells.qc[queries][:, None] + _cube(dev)  # (Q, 27, 3)
    inside = ((qc >= 0)
              & (qc < torch.tensor(cells.dims, device=dev))).all(-1)
    qid = cells._id(qc)
    start = torch.searchsorted(cells.sorted, qid)
    count = torch.where(
        inside, torch.searchsorted(cells.sorted, qid, right=True) - start, 0)
    slot = torch.arange(max(cells.most, k), device=dev)
    real = slot < count[..., None]  # (Q, 27, slots)
    pos = (start[..., None] + slot).clamp(max=n - 1)
    cand = torch.where(real, cells.order[pos], n).reshape(queries.shape[0], -1)
    d = coords[cand.clamp(max=n - 1)] - qxyz[:, None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(cand < n, d2, float("inf"))
    # (distance, index): order by index, then a stable sort by distance
    cand, by_idx = torch.sort(cand, dim=1)
    d2, by_d = torch.sort(d2.gather(1, by_idx), dim=1, stable=True)
    return cand.gather(1, by_d[:, :k]), d2[:, k - 1], count.sum()


def knn(coords: torch.Tensor, k: int, cell: float,
        queries: T.Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, k) int64 rows of ``coords`` (n, 3) float64: the k nearest points
    of every query, ``queries`` (Q, 3) float64 of another set, or without
    it the points themselves (Q = n); searched first in cells of width
    ``cell`` (about three spacings of the points keeps most queries to one
    pass). Raises on fewer than k points."""
    n = coords.shape[0]
    if n < k:
        raise ValueError(f"a level of {n} points has fewer than k = {k}")
    if coords.dtype != torch.float64 or (
            queries is not None and queries.dtype != torch.float64):
        raise TypeError("knn takes float64 coordinates")
    qxyz = coords if queries is None else queries
    origin = coords.min(dim=0).values
    if queries is not None:
        origin = torch.minimum(origin, queries.min(dim=0).values)
    nq = qxyz.shape[0]
    out = torch.empty((nq, k), dtype=torch.int64, device=coords.device)
    todo = torch.arange(nq, device=coords.device)
    width = float(cell)
    candidates = torch.zeros((), dtype=torch.int64, device=coords.device)
    while todo.numel():
        cells = _Cells(coords, width, origin, queries)
        per = max(1, BUDGET // (27 * max(cells.most, k)))
        missed = []
        for q0 in range(0, todo.numel(), per):
            batch = todo[q0:q0 + per]
            nbr, kth, seen = _search(coords, qxyz[batch], batch, k, cells)
            candidates += seen
            if cells.covers_all():
                out[batch] = nbr
                continue
            ok = kth < (width * width) * (1.0 - MARGIN)
            out[batch[ok]] = nbr[ok]
            missed.append(batch[~ok])
        todo = torch.cat(missed) if missed else todo[:0]
        width *= 2.0
    trace.count("knn_queries", nq)
    trace.count("knn_candidates", int(candidates))
    return out
