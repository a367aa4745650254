"""Batched point clouds (port of the render- and training-path part of
``gpcr_tpu/structures/pointcloud.py``): (b, n, ·) attribute tensors with a
validity mask."""

from __future__ import annotations

import dataclasses
import typing as T

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PointCloud:
    xyz_w: torch.Tensor  # (b, n, 3)
    rgb: T.Optional[torch.Tensor] = None  # (b, n, 3)
    normal_w: T.Optional[torch.Tensor] = None  # (b, n, 3)
    valid_mask: T.Optional[torch.Tensor] = None  # (b, n, 1) bool

    _ATTRS = ("xyz_w", "rgb", "normal_w", "valid_mask")

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

    def __getitem__(self, ib) -> "PointCloud":
        if isinstance(ib, int):
            ib = slice(ib, ib + 1)
        return dataclasses.replace(self, **{
            k: (getattr(self, k)[ib] if getattr(self, k) is not None else None)
            for k in self._ATTRS
        })

    def replace(self, **kw) -> "PointCloud":
        return dataclasses.replace(self, **kw)

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
