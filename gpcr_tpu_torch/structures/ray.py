"""Ray bundles (port of ``gpcr_tpu/structures/ray.py``)."""

from __future__ import annotations

import dataclasses
import math
import typing as T

import torch


@dataclasses.dataclass(frozen=True)
class Ray:
    origins_w: torch.Tensor  # (b, *m, 3)
    directions_w: torch.Tensor  # (b, *m, 3)

    @property
    def shape(self):
        return self.origins_w.shape[:-1]

    def reshape(self, *shape) -> "Ray":
        return Ray(origins_w=self.origins_w.reshape(*shape, 3),
                   directions_w=self.directions_w.reshape(*shape, 3))

    def chunk(self, chunks: int, dim: int = 1) -> T.List["Ray"]:
        """``chunks`` parts along ``dim`` (``np.array_split`` sizes)."""
        os_ = torch.tensor_split(self.origins_w, chunks, dim=dim)
        ds = torch.tensor_split(self.directions_w, chunks, dim=dim)
        return [Ray(o, d) for o, d in zip(os_, ds)]

    @staticmethod
    def cat(rays: T.Sequence["Ray"], dim: int = 1) -> "Ray":
        return Ray(
            origins_w=torch.cat([r.origins_w for r in rays], dim=dim),
            directions_w=torch.cat([r.directions_w for r in rays], dim=dim))

    def random_perturb_direction(self, generator: torch.Generator,
                                 max_angle_deg: float) -> "Ray":
        """Perturb each direction inside a fixed-angle cone; ``generator``
        lives on the rays' device."""
        d = self.directions_w
        kw = dict(generator=generator, device=d.device, dtype=d.dtype)
        ang = torch.rand(d.shape[:-1], **kw) * math.radians(max_angle_deg)
        phi = torch.rand(d.shape[:-1], **kw) * 2 * math.pi
        # orthonormal basis around d
        ex = torch.tensor([1.0, 0.0, 0.0], device=d.device, dtype=d.dtype)
        ey = torch.tensor([0.0, 1.0, 0.0], device=d.device, dtype=d.dtype)
        helper = torch.where(torch.abs(d[..., 0:1]) < 0.9, ex.expand_as(d),
                             ey.expand_as(d))
        u = torch.linalg.cross(d, helper)
        u = u / torch.linalg.norm(u, dim=-1, keepdim=True)
        v = torch.linalg.cross(d, u)
        sa, ca = torch.sin(ang)[..., None], torch.cos(ang)[..., None]
        new_d = ca * d + sa * (torch.cos(phi)[..., None] * u
                               + torch.sin(phi)[..., None] * v)
        new_d = new_d / torch.linalg.norm(new_d, dim=-1, keepdim=True)
        return dataclasses.replace(self, directions_w=new_d)

    def state_dict(self) -> dict:
        return {"origins_w": self.origins_w.detach().cpu().numpy(),
                "directions_w": self.directions_w.detach().cpu().numpy()}
