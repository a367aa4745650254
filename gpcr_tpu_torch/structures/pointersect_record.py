"""Ray-intersection records (port of
``gpcr_tpu/structures/pointersect_record.py``), on the device of their
tensors.

Per ray: the intersection's xyz, normal and rgb, blending weights and
neighbour indices, the ray's t, hit flag and hit logit; with reshaping,
``chunk`` / ``cat``, averaging of several records, conversion of a
per-pixel record to an RGBD image, and a confidence gate.
"""

from __future__ import annotations

import dataclasses
import typing as T

import torch

from .camera import Camera


@dataclasses.dataclass(frozen=True)
class PointersectRecord:
    intersection_xyz_w: T.Optional[torch.Tensor] = None  # (b, m, 3)
    intersection_surface_normal_w: T.Optional[torch.Tensor] = None  # (b, m, 3)
    intersection_rgb: T.Optional[torch.Tensor] = None  # (b, m, 3)
    blending_weights: T.Optional[torch.Tensor] = None  # (b, m, k)
    neighbor_point_idxs: T.Optional[torch.Tensor] = None  # (b, m, k)
    ray_t: T.Optional[torch.Tensor] = None  # (b, m)
    ray_hit: T.Optional[torch.Tensor] = None  # (b, m) bool/float
    ray_hit_logit: T.Optional[torch.Tensor] = None  # (b, m)
    model_attn_weights: T.Optional[torch.Tensor] = None  # (b, m, k)

    _ATTRS = (
        "intersection_xyz_w", "intersection_surface_normal_w",
        "intersection_rgb", "blending_weights", "neighbor_point_idxs",
        "ray_t", "ray_hit", "ray_hit_logit", "model_attn_weights",
    )

    # ---- reshaping ----------------------------------------------------------

    def _map(self, fn) -> "PointersectRecord":
        return dataclasses.replace(self, **{
            k: (None if getattr(self, k) is None else fn(getattr(self, k)))
            for k in self._ATTRS})

    def reshape(self, *m_shape) -> "PointersectRecord":
        """Reshape the ray axes (b, *m) of every attribute to (b,
        *m_shape); ``ray_t`` sets how many axes are ray axes."""
        ray_ndim = self.ray_t.dim()

        def fn(a):
            return a.reshape(a.shape[0], *m_shape, *a.shape[ray_ndim:])

        return self._map(fn)

    def chunk(self, chunks: int, dim: int = 1) -> T.List["PointersectRecord"]:
        """``chunks`` parts along ``dim`` (``np.array_split`` sizes)."""
        outs = None
        for k in self._ATTRS:
            arr = getattr(self, k)
            if arr is None:
                continue
            parts = torch.tensor_split(arr, chunks, dim=dim)
            if outs is None:
                outs = [dict() for _ in parts]
            for i, p in enumerate(parts):
                outs[i][k] = p
        return [PointersectRecord(**d) for d in (outs or [])]

    @staticmethod
    def cat(records: T.Sequence["PointersectRecord"],
            dim: int = 1) -> "PointersectRecord":
        """Concatenate; an attribute missing from any record is dropped."""
        out = {}
        for k in PointersectRecord._ATTRS:
            arrs = [getattr(r, k) for r in records]
            out[k] = (None if any(a is None for a in arrs)
                      else torch.cat(arrs, dim=dim))
        return PointersectRecord(**out)

    @staticmethod
    def aggregate(
            records: T.Sequence["PointersectRecord"]) -> "PointersectRecord":
        """The mean of several records, normals renormalized."""
        out = {}
        for k in PointersectRecord._ATTRS:
            arrs = [getattr(r, k) for r in records]
            if any(a is None for a in arrs):
                out[k] = None
                continue
            m = sum(arrs) / len(arrs)
            if k == "intersection_surface_normal_w":
                m = m / torch.clamp(torch.linalg.norm(m, dim=-1, keepdim=True),
                                    min=1e-12)
            out[k] = m
        return PointersectRecord(**out)

    # ---- conversion -----------------------------------------------------------

    def get_rgbd_image(self, camera: Camera):
        """A per-pixel record of ``camera``'s (b, q, h, w) rays as an
        RGBDImage: depth is the camera z of the intersection, inf where
        the ray missed (``ray_hit`` <= 0.5, or a non-finite z without
        ``ray_hit``)."""
        from ..utils.rigid_motion import inv_homogeneous
        from .rgbd_image import RGBDImage

        b, q = camera.H_c2w.shape[:2]
        h, w = camera.height_px, camera.width_px
        xyz = self.intersection_xyz_w.reshape(b, q, h, w, 3)
        H_w2c = inv_homogeneous(camera.H_c2w).to(xyz.device)
        xyz_c = (torch.einsum("bqij,bqhwj->bqhwi", H_w2c[..., :3, :3], xyz)
                 + H_w2c[..., :3, 3][:, :, None, None, :])
        z = xyz_c[..., 2]
        hit = (self.ray_hit.reshape(b, q, h, w) if self.ray_hit is not None
               else torch.isfinite(z).to(torch.float32))
        z = torch.where(hit > 0.5, z, float("inf"))
        nrm = self.intersection_surface_normal_w
        return RGBDImage(
            rgb=self.intersection_rgb.reshape(b, q, h, w, 3),
            depth=z, camera=camera,
            normal_w=None if nrm is None else nrm.reshape(b, q, h, w, 3),
            hit_map=hit)

    # ---- confidence -------------------------------------------------------------

    def compute_confidence(self, zdir_w: T.Optional[torch.Tensor] = None,
                           hit_threshold: float = 0.5,
                           max_angle_deg: float = 85.0) -> torch.Tensor:
        """Hit-probability gate (sigmoid of the logit, else ``ray_hit`` >
        threshold) times the gate of normals within ``max_angle_deg`` of
        the capture direction ``zdir_w``."""
        conf = torch.ones_like(self.ray_t)
        if self.ray_hit_logit is not None:
            conf = conf * (1.0 / (1.0 + torch.exp(-self.ray_hit_logit)))
        elif self.ray_hit is not None:
            conf = conf * (self.ray_hit > hit_threshold)
        if zdir_w is not None and self.intersection_surface_normal_w is not None:
            cos = torch.abs(torch.sum(
                self.intersection_surface_normal_w * zdir_w, dim=-1))
            lim = torch.cos(torch.deg2rad(torch.tensor(
                max_angle_deg, dtype=torch.float32)))
            conf = conf * (cos > lim.to(cos.device))
        return conf

    def state_dict(self) -> dict:
        return {k: getattr(self, k).detach().cpu().numpy()
                for k in self._ATTRS if getattr(self, k) is not None}
