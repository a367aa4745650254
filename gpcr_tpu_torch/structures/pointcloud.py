"""Batched point clouds (port of ``gpcr_tpu/structures/pointcloud.py``):
(b, n, ·) attribute tensors with a validity mask, ragged ``cat`` with
padding, PLY and state-dict persistence, Gaussian-weighted voxel
downsampling and radius outlier removal, all on the cloud's device.

As in the JAX package, operations that shrink the cloud (voxel
downsampling, outlier removal) keep the padded length and update
``valid_mask`` instead of reallocating. The surfel z-buffer runs on the
cloud's device; normal estimation and meshing (voxel, alpha shape,
Poisson) run on the host in numpy.
"""

from __future__ import annotations

import dataclasses
import itertools
import typing as T

import numpy as np
import torch

from ..ops import segment


@dataclasses.dataclass(frozen=True)
class PointCloud:
    xyz_w: torch.Tensor  # (b, n, 3)
    rgb: T.Optional[torch.Tensor] = None  # (b, n, 3)
    normal_w: T.Optional[torch.Tensor] = None  # (b, n, 3)
    valid_mask: T.Optional[torch.Tensor] = None  # (b, n, 1) bool
    feature: T.Optional[torch.Tensor] = None  # (b, n, f)
    captured_z_direction_w: T.Optional[torch.Tensor] = None  # (b, n, 3)
    captured_view_direction_w: T.Optional[torch.Tensor] = None  # (b, n, 3)
    captured_dps: T.Optional[torch.Tensor] = None  # (b, n, 1)
    captured_dps_u_w: T.Optional[torch.Tensor] = None  # (b, n, 3)
    captured_dps_v_w: T.Optional[torch.Tensor] = None  # (b, n, 3)
    img_idxs: T.Optional[torch.Tensor] = None  # (b, n, 1)

    _ATTRS = (
        "xyz_w", "rgb", "normal_w", "valid_mask", "feature",
        "captured_z_direction_w", "captured_view_direction_w",
        "captured_dps", "captured_dps_u_w", "captured_dps_v_w", "img_idxs",
    )
    _DIRECTION_ATTRS = (
        "normal_w", "captured_z_direction_w", "captured_view_direction_w",
    )

    # ---- basics ------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.xyz_w.device

    @property
    def batch_size(self) -> int:
        return self.xyz_w.shape[0]

    def get_num_points(self) -> int:
        return self.xyz_w.shape[1]

    def get_valid_mask(self) -> torch.Tensor:
        """(b, n, 1) bool; all-true when unset."""
        if self.valid_mask is None:
            return torch.ones((*self.xyz_w.shape[:2], 1), dtype=torch.bool,
                              device=self.xyz_w.device)
        return self.valid_mask.bool()

    def get_num_valid_points(self, bidx: int = 0) -> torch.Tensor:
        return self.get_valid_mask()[bidx, :, 0].sum()

    def _map(self, fn) -> dict:
        return {k: (None if getattr(self, k) is None else fn(getattr(self, k)))
                for k in self._ATTRS}

    def __getitem__(self, ib) -> "PointCloud":
        if isinstance(ib, int):
            ib = slice(ib, ib + 1)
        return PointCloud(**self._map(lambda a: a[ib]))

    def replace(self, **kw) -> "PointCloud":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PointCloud":
        return PointCloud(**self._map(lambda a: a.to(device)))

    @staticmethod
    def cat(pcds: T.Sequence["PointCloud"], dim: int = 0) -> "PointCloud":
        """Concatenate; ragged batches are right-padded with invalid
        points. An attribute missing from any cloud is dropped."""
        n_max = max(p.get_num_points() for p in pcds)
        padded = [p.pad_to(n_max) for p in pcds]
        out = {}
        for k in PointCloud._ATTRS:
            arrs = [getattr(p, k) for p in padded]
            out[k] = (None if any(a is None for a in arrs)
                      else torch.cat(arrs, dim=dim))
        return PointCloud(**out)

    def pad_to(self, n: int) -> "PointCloud":
        """Right-pad to n points with zeros, marking the padding invalid;
        the result always carries a ``valid_mask``."""
        cur = self.get_num_points()
        if cur == n:
            return self if self.valid_mask is not None else self.replace(
                valid_mask=self.get_valid_mask())
        if cur > n:
            raise ValueError(f"cannot pad {cur} points down to {n}")

        def _pad(a):
            return torch.cat(
                [a, a.new_zeros((a.shape[0], n - cur, *a.shape[2:]))], dim=1)

        out = self._map(_pad)
        out["valid_mask"] = _pad(self.get_valid_mask())
        return PointCloud(**out)

    def extract_valid_point_cloud(self, bidx: int = 0) -> "PointCloud":
        """Batch item ``bidx`` with its valid points moved to the front in
        their order (a stable partition; the length stays n)."""
        mask = self.get_valid_mask()[bidx, :, 0]
        order = torch.argsort((~mask).to(torch.uint8), stable=True)
        out = self._map(lambda a: a[bidx:bidx + 1, order])
        out["valid_mask"] = mask[order][None, :, None]
        return PointCloud(**out)

    # ---- IO -----------------------------------------------------------------

    @staticmethod
    def from_ply(path: str, device=None) -> "PointCloud":
        """Load from PLY (``gpcr_tpu_torch.io.read_ply``)."""
        from ..io import read_ply

        d = read_ply(path)
        return PointCloud.from_numpy(d["xyz"], d.get("rgb"), d.get("normal"),
                                     device=device)

    @staticmethod
    def from_numpy(xyz, rgb=None, normal=None, device=None) -> "PointCloud":
        def _a(x):
            if x is None:
                return None
            x = torch.as_tensor(np.asarray(x, np.float32), device=device)
            return x[None] if x.dim() == 2 else x

        return PointCloud(xyz_w=_a(xyz), rgb=_a(rgb), normal_w=_a(normal))

    def save(self, path: str, bidx: int = 0, overwrite: bool = True):
        """Save batch item ``bidx``'s valid points (xyz, rgb, normals where
        present) to a binary PLY."""
        from ..io import write_ply

        mask = self.get_valid_mask()[bidx, :, 0].cpu().numpy()

        def host(a):
            return None if a is None else a[bidx].detach().cpu().numpy()[mask]

        write_ply(path, host(self.xyz_w), rgb=host(self.rgb),
                  normal=host(self.normal_w), overwrite=overwrite)

    def state_dict(self) -> dict:
        return {k: getattr(self, k).detach().cpu().numpy()
                for k in self._ATTRS if getattr(self, k) is not None}

    @staticmethod
    def from_state_dict(d: dict, device=None) -> "PointCloud":
        return PointCloud(**{k: torch.as_tensor(np.asarray(v), device=device)
                             for k, v in d.items()})

    # ---- voxel downsampling ----------------------------------------------------

    def voxel_downsampling(self, cell_width: float, sigma: float = 0.5,
                           drop_features: bool = True) -> "PointCloud":
        """Gaussian-weighted voxel averaging: per occupied cell, xyz is the
        plain mean of its points; every other attribute the sum weighted by
        exp(-d² / 2σ²) (d to the cell's mean, σ = ``sigma * cell_width``),
        normalized per cell; direction attributes are renormalized.
        ``drop_features`` keeps only rgb, normal_w and feature.

        The cell grid spans the valid points' bounds widened by 1e-3, each
        axis cut into ceil(width / cell_width) equal cells. The output keeps
        the padded length n, with one valid point per occupied cell at the
        front (the cells in key order) and a fresh ``valid_mask``."""
        if cell_width < 0:
            return self
        return PointCloud.cat(
            [self._voxel_downsample_one(ib, cell_width, sigma, drop_features)
             for ib in range(self.batch_size)], dim=0)

    def _voxel_downsample_one(self, ib, cell_width, sigma, drop_features):
        mask = self.get_valid_mask()[ib, :, 0]
        xyz = self.xyz_w[ib]
        n = xyz.shape[0]
        # the unadjusted width sets sigma; the cells use the adjusted cw
        sigma = sigma * cell_width

        inf = torch.tensor(float("inf"), dtype=xyz.dtype, device=xyz.device)
        grid_from = torch.where(mask[:, None], xyz, inf).min(0).values - 1e-3
        grid_to = torch.where(mask[:, None], xyz, -inf).max(0).values + 1e-3
        grid_width = grid_to - grid_from
        grid_size = torch.ceil(grid_width / cell_width)
        cw = grid_width / grid_size  # per-axis adjusted cell width

        sub = torch.floor((xyz - grid_from) / cw).to(torch.int32).long()
        gs = grid_size.long()
        inds = sub[:, 2] + sub[:, 1] * gs[2] + sub[:, 0] * (gs[1] * gs[2])
        inds = torch.where(mask, inds, torch.iinfo(torch.int64).max)

        # cells by sort: segment ids in key order, scattered back
        sorted_inds, order = torch.sort(inds, stable=True)
        newseg = torch.ones_like(sorted_inds)
        newseg[0] = 0
        newseg[1:] = (sorted_inds[1:] != sorted_inds[:-1]).long()
        seg = torch.empty_like(order)
        seg[order] = torch.cumsum(newseg, 0)
        # invalid points land in the last slot with zero weight
        seg = torch.where(mask, seg, n - 1)

        fm = mask.to(xyz.dtype)[:, None]
        cnt = segment.segment_sum(fm, seg, n)
        xyz_mean = segment.segment_sum(xyz * fm, seg, n) / torch.clamp(
            cnt, min=1.0)

        d2 = torch.sum((xyz - xyz_mean[seg]) ** 2, dim=-1)
        w = torch.exp(-d2 / (2 * sigma ** 2)) * mask
        w_sum = segment.segment_sum(w, seg, n)
        w_norm = (w / torch.clamp(w_sum[seg], min=1e-20))[:, None]

        out = {"xyz_w": xyz_mean[None], "valid_mask": (cnt[:, 0] > 0)[None, :, None]}
        keep = ("rgb", "normal_w", "feature")
        for name in self._ATTRS:
            if name in ("xyz_w", "valid_mask"):
                continue
            arr = getattr(self, name)
            if (arr is None or name == "img_idxs"
                    or (drop_features and name not in keep)):
                out[name] = None
                continue
            a = segment.segment_sum(arr[ib] * w_norm, seg, n)
            if name in self._DIRECTION_ATTRS:
                a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                                    min=1e-12)
            out[name] = a[None]
        return PointCloud(**out)

    # ---- outlier removal -------------------------------------------------------

    def remove_outlier(self, radius: float, min_neighbors: int = 2,
                       bidx: int = 0, chunk: int = 1 << 16) -> "PointCloud":
        """Mark invalid the valid points of batch item ``bidx`` that have
        fewer than ``min_neighbors`` other valid points within ``radius``.

        Vectorised: points sorted by their cell key (cells of width
        ``radius``), each point's candidates are the points of its 27
        neighbouring cells; the squared distance is summed in float32 as
        (dx² + dy²) + dz² and compared with radius² in float32. ``chunk``
        points are handled at a time."""
        vm = self.get_valid_mask().clone()
        mask = vm[bidx, :, 0]
        idx = torch.nonzero(mask)[:, 0]
        p = self.xyz_w[bidx, idx]
        dev = p.device
        cell = torch.floor(p / radius).long()
        if len(p) == 0:
            return self.replace(valid_mask=vm)
        lo = cell.min(0).values - 1
        span = cell.max(0).values - lo + 2
        if float(span.double().prod()) >= 2.0 ** 62:
            raise ValueError(f"radius {radius} cuts the cloud into too many "
                             "cells for an int64 key")
        strides = torch.stack([span[1] * span[2], span[2], torch.ones_like(span[2])])

        def key(c):
            return ((c - lo) * strides).sum(-1)

        skey, order = torch.sort(key(cell))
        sp, scell = p[order], cell[order]
        r2 = float(radius) * float(radius)
        counts = torch.zeros(len(sp), dtype=torch.long, device=dev)
        offsets = torch.tensor(list(itertools.product((-1, 0, 1), repeat=3)),
                               device=dev)
        for a in range(0, len(sp), chunk):
            ci = torch.arange(a, min(a + chunk, len(sp)), device=dev)
            for off in offsets:
                nk = key(scell[ci] + off)
                start = torch.searchsorted(skey, nk, right=False)
                ln = torch.searchsorted(skey, nk, right=True) - start
                rep = torch.repeat_interleave(torch.arange(len(ci), device=dev),
                                              ln)
                first = torch.cumsum(ln, 0) - ln
                j = start[rep] + (torch.arange(len(rep), device=dev)
                                  - first[rep])
                i = ci[rep]
                d = sp[j] - sp[i]
                d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
                ok = (d2 <= r2) & (j != i)
                counts.index_add_(0, i, ok.long())
        keep = torch.zeros_like(mask)
        keep[idx[order]] = counts >= min_neighbors
        vm[bidx, :, 0] = keep
        return self.replace(valid_mask=vm)

    # ---- normals ---------------------------------------------------------------

    def estimate_normals(self, k: int = 30) -> "PointCloud":
        """PCA normals per batch item (the estimate of the reference's
        ``simple`` task), computed on the host. Returns a new PointCloud
        with ``normal_w`` filled."""
        from . import reconstruct

        outs = []
        for ib in range(self.batch_size):
            xyz = self.xyz_w[ib].detach().cpu().numpy()
            mask = self.get_valid_mask()[ib, :, 0].cpu().numpy()
            nrm = np.zeros_like(xyz)
            nrm[mask] = reconstruct.estimate_normals(xyz[mask], k=k)
            outs.append(nrm)
        return self.replace(normal_w=torch.as_tensor(
            np.stack(outs), device=self.device))

    # ---- surfel rasterization ---------------------------------------------------

    def rasterize_surfel(self, camera, point_size: int = 1, shading: str = "raw",
                         light_dir=(0.0, 0.0, 1.0), bg_color=1.0,
                         bidx: int = 0):
        """Z-buffer point splatting on the cloud's device: each valid point
        in front of a camera falls on the pixel floor(uv); a pixel shows
        the lowest-index point among those within 1e-6 of its nearest z,
        else ``bg_color``. shading: 'raw' (albedo), 'directional'
        (lambert |n.l|), 'half' ((n.l + 1) / 2), the latter two only with
        normals. ``point_size`` is accepted and unused, as in JAX. Returns
        an RGBDImage (b = 1, q, h, w) of ``camera[bidx]``."""
        from ..ops.segment import segment_min
        from ..utils.geometry import pinhole_projection
        from .rgbd_image import RGBDImage

        h, w = camera.height_px, camera.width_px
        q = camera.H_c2w.shape[1]
        xyz = self.xyz_w[bidx]
        dev, n = xyz.device, xyz.shape[0]
        rgb = self.rgb[bidx] if self.rgb is not None else torch.ones_like(xyz)
        nrm = self.normal_w[bidx] if self.normal_w is not None else None
        mask = self.get_valid_mask()[bidx, :, 0]

        if shading != "raw" and nrm is not None:
            ld = torch.tensor(light_dir, dtype=torch.float32, device=dev)
            ld = ld / torch.linalg.norm(ld)
            cos = torch.sum(nrm * ld, dim=-1, keepdim=True)
            if shading == "directional":
                shade = torch.abs(cos)
            elif shading == "half":
                shade = (cos + 1.0) / 2.0
            else:
                raise NotImplementedError(shading)
            rgb = rgb * shade

        bg = torch.as_tensor(bg_color, dtype=rgb.dtype, device=dev)
        big = torch.iinfo(torch.int64).max
        point_idx = torch.arange(n, device=dev)
        imgs, depths, hits = [], [], []
        for iq in range(q):
            proj = pinhole_projection(
                xyz[None], camera.intrinsic[bidx, iq][None].to(dev),
                camera.H_c2w[bidx, iq][None].to(dev))
            uv, z = proj["uv"][0], proj["z"][0]
            px = torch.floor(uv[:, 0]).long()
            py = torch.floor(uv[:, 1]).long()
            ok = (mask & proj["in_front"][0] & (px >= 0) & (px < w)
                  & (py >= 0) & (py < h))
            pid = torch.where(ok, py * w + px, h * w)
            zq = torch.where(ok, z, float("inf"))
            zmin = segment_min(zq, pid, h * w + 1)[:-1]
            win = ok & (z <= zmin[torch.clamp(pid, 0, h * w - 1)] + 1e-6)
            idx_win = segment_min(torch.where(win, point_idx, big), pid,
                                  h * w + 1)[:-1]
            has = idx_win < big
            img = torch.where(has[:, None], rgb[torch.clamp(idx_win, 0, n - 1)],
                              bg)
            imgs.append(img.reshape(h, w, 3))
            depths.append(torch.where(has, zmin, float("inf")).reshape(h, w))
            hits.append(has.to(torch.float32).reshape(h, w))
        return RGBDImage(rgb=torch.stack(imgs)[None],
                         depth=torch.stack(depths)[None],
                         camera=camera[bidx],
                         hit_map=torch.stack(hits)[None])

    # ---- meshing ------------------------------------------------------------------

    def get_mesh(self, method: str = "voxel", cell_width: float = 0.05,
                 bidx: int = 0, alpha: float = 0.1, depth: int = 6):
        """Point cloud -> mesh, on the host in numpy. Methods:

        - 'alpha' / 'alpha_shape': Delaunay alpha shape
          (``reconstruct.alpha_shape_mesh``);
        - 'poisson': grid Poisson reconstruction from oriented normals
          (``reconstruct.poisson_mesh``; estimates normals if absent);
        - 'voxel': the boundary faces of the occupied cells of width
          ``cell_width``, two triangles each;
        - 'ball_pivot' is not implemented: its pivoting front has no
          vectorised form; 'alpha' with alpha near the ball radius stands
          in for it.
        """
        from . import reconstruct
        from .mesh import Mesh

        xyz = self.xyz_w[bidx].detach().cpu().numpy()
        mask = self.get_valid_mask()[bidx, :, 0].cpu().numpy()
        if method in ("alpha", "alpha_shape"):
            v, f = reconstruct.alpha_shape_mesh(xyz[mask], alpha)
            return Mesh({"vertices": v, "triangles": f}, scale=None,
                        center_w=None)
        if method == "poisson":
            if self.normal_w is not None:
                nrm = self.normal_w[bidx].detach().cpu().numpy()[mask]
            else:
                nrm = reconstruct.estimate_normals(xyz[mask])
            v, f = reconstruct.poisson_mesh(xyz[mask], nrm, depth=depth)
            return Mesh({"vertices": v, "triangles": f}, scale=None,
                        center_w=None)
        if method != "voxel":
            raise NotImplementedError(
                f"'{method}': supported methods are alpha/poisson/voxel "
                f"(ball_pivot dropped — see get_mesh docstring)")
        v, f = _voxel_boundary_mesh(xyz[mask], cell_width)
        return Mesh({"vertices": v, "triangles": f, "textures": [],
                     "material_ids": np.zeros(len(f), np.int32)},
                    scale=None, center_w=None)


# the six faces of a unit cell (the JAX table's order): the outward step to
# the neighbour cell that hides the face, and the face's four corners
_FACE_NORMALS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                          [0, 0, 1], [0, 0, -1]], np.int64)
_FACE_CORNERS = np.array([
    [(1, 0, 0), (1, 1, 0), (1, 1, 1), (1, 0, 1)],
    [(0, 0, 1), (0, 1, 1), (0, 1, 0), (0, 0, 0)],
    [(0, 1, 0), (0, 1, 1), (1, 1, 1), (1, 1, 0)],
    [(0, 0, 0), (1, 0, 0), (1, 0, 1), (0, 0, 1)],
    [(0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
    [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 0, 0)],
], np.int64)


def _voxel_boundary_mesh(xyz: np.ndarray, cell_width: float):
    """Boundary faces of the occupied cells, vectorised: cells in
    lexicographic order, faces in table order, vertices numbered by first
    occurrence in (cell, face, corner) order. Returns (vertices (V, 3)
    float32, triangles (F, 3) int32)."""
    cells = np.unique(np.floor(xyz / cell_width).astype(np.int64), axis=0)
    if len(cells) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    lo = cells.min(0) - 1
    span = cells.max(0) - lo + 2

    def key(c):  # lexicographic, so ``cells`` are sorted by it
        c = c - lo
        return (c[..., 0] * span[1] + c[..., 1]) * span[2] + c[..., 2]

    occ = key(cells)
    nb = key(cells[:, None, :] + _FACE_NORMALS[None])  # (C, 6)
    pos = np.clip(np.searchsorted(occ, nb), 0, len(occ) - 1)
    ic, jf = np.nonzero(occ[pos] != nb)  # exposed faces, (cell, face) order
    corners = (cells[ic][:, None, :] + _FACE_CORNERS[jf]).reshape(-1, 3)
    _, first, inv = np.unique(key(corners), return_index=True,
                              return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    ids = rank[inv.reshape(-1)].reshape(-1, 4)
    tris = np.stack([ids[:, [0, 1, 2]], ids[:, [0, 2, 3]]], axis=1)
    verts = corners[np.sort(first)].astype(np.float64) * cell_width
    return verts.astype(np.float32), tris.reshape(-1, 3).astype(np.int32)
