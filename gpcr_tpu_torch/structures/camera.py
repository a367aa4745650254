"""Batched pinhole cameras (port of ``gpcr_tpu/structures/camera.py``):
rays, slicing (``index_select``, ``chunk``, pixel-budget ``split``, ``cat``),
geodesic resampling, persistence, and the coordinate-frame meshes of the
debug view (``get_camera_frames`` / ``save_camera_frames``, host numpy in
float64, as in JAX, so both write the same OBJ).

``H_c2w`` is (b, q, 4, 4) camera-to-world with image y pointing down;
``intrinsic`` is (b, q, 3, 3) with f = 0.5 * width / tan(fov/2). Rays
leave pixel centers: uv + 0.5, direction = H_c2w[:3,:3] @ inv(K) @
[u, v, 1], normalized.
"""

from __future__ import annotations

import dataclasses
import json
import typing as T

import numpy as np
import torch


def derive_camera_intrinsics(width_px: int, height_px: int, fov: float,
                             device=None) -> torch.Tensor:
    """3x3 intrinsics from fov in degrees."""
    f = 0.5 * float(width_px) / np.tan(0.5 * fov / 180.0 * np.pi)
    return torch.tensor(
        [[f, 0.0, width_px * 0.5], [0.0, f, height_px * 0.5], [0.0, 0.0, 1.0]],
        dtype=torch.float32, device=device,
    )


def generate_camera_rays_from_uv(cam_poses, intrinsics, uv):
    """Rays in world coordinates through given sensor uv points.

    cam_poses (m, 4, 4) H_c2w; intrinsics (m, 3, 3); uv (m, *p, 2) with u in
    [0, w], v in [0, h], origin top-left. Returns (origins (m, *p, 3),
    directions (m, *p, 3) unit-norm).
    """
    m = cam_poses.shape[0]
    ones = [1] * (uv.dim() - 2)
    uv1 = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    inv_K = torch.linalg.inv(intrinsics).reshape(m, *ones, 3, 3)
    dirs_c = (inv_K @ uv1[..., None])[..., 0]
    R = cam_poses[:, :3, :3].reshape(m, *ones, 3, 3)
    dirs_w = (R @ dirs_c[..., None])[..., 0]
    dirs_w = dirs_w / torch.linalg.norm(dirs_w, dim=-1, keepdim=True)
    origins = cam_poses[:, :3, 3].reshape(m, *ones, 3).expand_as(dirs_w)
    return origins, dirs_w


@dataclasses.dataclass(frozen=True)
class Camera:
    """(b, q) batch of pinhole cameras."""

    H_c2w: torch.Tensor  # (b, q, 4, 4)
    intrinsic: torch.Tensor  # (b, q, 3, 3)
    width_px: int
    height_px: int

    @property
    def device(self) -> torch.device:
        return self.H_c2w.device

    @property
    def batch_shape(self):
        return self.H_c2w.shape[:-2]

    def get_camera_origin_w(self) -> torch.Tensor:
        """(b, q, 3) camera origins in world."""
        return self.H_c2w[..., :3, 3]

    def get_H_w2c(self) -> torch.Tensor:
        """Closed-form rigid inverse of ``H_c2w``."""
        from ..utils.rigid_motion import inv_homogeneous

        return inv_homogeneous(self.H_c2w)

    def generate_camera_rays(self, subsample: int = 1, offsets="center"):
        """Per-pixel rays. Returns (origins, dirs): (b, q, h', w', 3).

        ``offsets='center'`` gives pixel-center rays (+0.5); a float or
        (..., 2) array adds a custom sensor offset.
        """
        b, q = self.H_c2w.shape[:2]
        f32 = dict(dtype=torch.float32, device=self.device)
        u = torch.arange(0, self.width_px, subsample, **f32) + 0.5
        v = torch.arange(0, self.height_px, subsample, **f32) + 0.5
        uu, vv = torch.meshgrid(u, v, indexing="xy")
        uv = torch.stack([uu, vv], dim=-1)  # (h', w', 2)
        if isinstance(offsets, str):
            if offsets != "center":
                raise NotImplementedError(offsets)
        else:
            uv = uv + torch.as_tensor(np.asarray(offsets, np.float32), **f32)
        uv = uv.expand(b * q, *uv.shape)
        o, d = generate_camera_rays_from_uv(
            self.H_c2w.reshape(b * q, 4, 4),
            self.intrinsic.reshape(b * q, 3, 3), uv)
        hw = uv.shape[1:3]
        return o.reshape(b, q, *hw, 3), d.reshape(b, q, *hw, 3)

    def __getitem__(self, ib) -> "Camera":
        if isinstance(ib, int):
            ib = slice(ib, ib + 1)
        return dataclasses.replace(
            self, H_c2w=self.H_c2w[ib], intrinsic=self.intrinsic[ib])

    def index_select(self, dim: int, index) -> "Camera":
        """The cameras at ``index`` along ``dim`` (``jnp.take``: an int
        drops the axis, a 1-D index keeps it)."""
        idx = torch.as_tensor(index, device=self.device)

        def take(a):
            if idx.dim() == 0:
                return a.select(dim, int(idx))
            return a.index_select(dim, idx.long())

        return dataclasses.replace(self, H_c2w=take(self.H_c2w),
                                   intrinsic=take(self.intrinsic))

    def chunk(self, chunks: int, dim: int = 0) -> T.List["Camera"]:
        """``chunks`` parts along ``dim`` (``np.array_split`` sizes: the
        first ``len % chunks`` parts one longer)."""
        hs = torch.tensor_split(self.H_c2w, chunks, dim=dim)
        ks = torch.tensor_split(self.intrinsic, chunks, dim=dim)
        return [dataclasses.replace(self, H_c2w=h, intrinsic=k)
                for h, k in zip(hs, ks)]

    def split(self, max_pixels: int) -> T.List["Camera"]:
        """Split the view axis so each part renders at most ``max_pixels``
        (q_part * h * w) pixels, at least one view per part."""
        q = self.H_c2w.shape[1]
        per_view = self.width_px * self.height_px
        step = max(1, max_pixels // max(per_view, 1))
        return [dataclasses.replace(self, H_c2w=self.H_c2w[:, s:s + step],
                                    intrinsic=self.intrinsic[:, s:s + step])
                for s in range(0, q, step)]

    def to(self, device) -> "Camera":
        return dataclasses.replace(
            self, H_c2w=self.H_c2w.to(device),
            intrinsic=self.intrinsic.to(device))

    @staticmethod
    def cat(cameras: T.Sequence["Camera"], dim: int) -> "Camera":
        assert len({c.width_px for c in cameras}) == 1
        assert len({c.height_px for c in cameras}) == 1
        return dataclasses.replace(
            cameras[0],
            H_c2w=torch.cat([c.H_c2w for c in cameras], dim=dim),
            intrinsic=torch.cat([c.intrinsic for c in cameras], dim=dim))

    def uniformly_sample(self, num_samples: int) -> "Camera":
        """Geodesically resample the (b, q) trajectory to q = num_samples."""
        from ..utils.rigid_motion import interp_homogeneous

        q = self.H_c2w.shape[1]
        if q == 1:
            return dataclasses.replace(
                self,
                H_c2w=self.H_c2w.repeat_interleave(num_samples, dim=1),
                intrinsic=self.intrinsic[:, :1].repeat_interleave(
                    num_samples, dim=1))
        t = torch.linspace(0.0, q - 1.0, num_samples, device=self.device)
        i0 = torch.clamp(torch.floor(t).long(), 0, q - 2)
        H = interp_homogeneous(self.H_c2w[:, i0], self.H_c2w[:, i0 + 1],
                               (t - i0)[None, :])
        return dataclasses.replace(self, H_c2w=H,
                                   intrinsic=self.intrinsic[:, i0])

    # ---- persistence: the JAX package's files, read and written alike ----

    def state_dict(self) -> dict:
        return {
            "H_c2w": self.H_c2w.detach().cpu().numpy(),
            "intrinsic": self.intrinsic.detach().cpu().numpy(),
            "width_px": self.width_px,
            "height_px": self.height_px,
        }

    @staticmethod
    def from_state_dict(d: dict, device=None) -> "Camera":
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        return Camera(H_c2w=f32(d["H_c2w"]), intrinsic=f32(d["intrinsic"]),
                      width_px=int(d["width_px"]),
                      height_px=int(d["height_px"]))

    def get_camera_frames(
        self, camera_frame_size: float = 0.1
    ) -> T.List[T.List[dict]]:
        """Per-camera coordinate-frame meshes for debug views: +X red / +Y
        green / +Z blue shafts and a gray origin block, posed in world by
        H_c2w (in float64). Returns a [b][q] nested list of mesh dicts
        with ``vertices (V, 3) f32``, ``triangles (F, 3) i32`` and
        ``colors (V, 3) f32``."""
        H = self.H_c2w.detach().cpu().numpy().astype(np.float64)
        b, q = H.shape[:2]
        return [[coordinate_frame_mesh(H[ib, iq], frame_size=camera_frame_size)
                 for iq in range(q)] for ib in range(b)]

    def save_camera_frames(
        self,
        filename: str,
        camera_frame_size: float = 0.1,
        world_frame_size: T.Optional[float] = None,
    ) -> None:
        """Write every camera frame (and, with ``world_frame_size``, a world
        frame at the origin) into one OBJ with per-vertex colours (``v x y
        z r g b``; loaders that read three floats per ``v`` line, such as
        ``structures.mesh.load_obj``, ignore the colours)."""
        meshes = [m for row in self.get_camera_frames(camera_frame_size)
                  for m in row]
        if world_frame_size is not None:
            meshes.append(
                coordinate_frame_mesh(np.eye(4), frame_size=world_frame_size))
        with open(filename, "w") as f:
            f.write("# gpcr_tpu camera frames\n")
            base = 0
            for m in meshes:
                for v, c in zip(m["vertices"], m["colors"]):
                    f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                            f"{c[0]:.3f} {c[1]:.3f} {c[2]:.3f}\n")
                for t in m["triangles"]:
                    f.write(f"f {t[0] + 1 + base} {t[1] + 1 + base} "
                            f"{t[2] + 1 + base}\n")
                base += len(m["vertices"])

    def save(self, filename: str) -> None:
        """Save as .json, else as .npz (numpy appends the suffix when the
        name lacks it)."""
        d = self.state_dict()
        if filename.endswith(".json"):
            with open(filename, "w") as f:
                json.dump({**d, "H_c2w": d["H_c2w"].tolist(),
                           "intrinsic": d["intrinsic"].tolist()}, f)
        else:
            np.savez(filename, **d)

    @staticmethod
    def load(filename: str, device=None) -> "Camera":
        """Load from .npz / .json, or a reference-style torch .pt / .pth
        state dict (tensors and ints, read with ``weights_only=True``)."""
        if filename.endswith(".json"):
            with open(filename) as f:
                return Camera.from_state_dict(json.load(f), device)
        if filename.endswith((".pt", ".pth")):
            d = torch.load(filename, map_location="cpu", weights_only=True)
            return Camera.from_state_dict(
                {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                 for k, v in d.items()}, device)
        with np.load(filename) as z:
            return Camera.from_state_dict({k: z[k] for k in z.files}, device)


def _box_mesh(lo, hi, color):
    """Axis-aligned box as (8 verts, 12 tris, per-vertex color)."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    corners = np.array(
        [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
         for z in (lo[2], hi[2])]
    )  # index bits: x<<2 | y<<1 | z
    tris = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    colors = np.tile(np.asarray(color, np.float64), (8, 1))
    return corners, tris, colors


def coordinate_frame_mesh(H: np.ndarray, frame_size: float = 1.0) -> dict:
    """Triangle-mesh coordinate frame (o3d's ``create_coordinate_frame``
    analogue): +X red, +Y green, +Z blue shafts of length ``frame_size``
    plus a gray origin block, moved into world by the (4, 4) pose ``H``."""
    s = float(frame_size)
    w = s / 20.0
    parts = [
        _box_mesh([-1.5 * w] * 3, [1.5 * w] * 3, [0.5, 0.5, 0.5]),
        _box_mesh([0, -w, -w], [s, w, w], [1.0, 0.0, 0.0]),
        _box_mesh([-w, 0, -w], [w, s, w], [0.0, 1.0, 0.0]),
        _box_mesh([-w, -w, 0], [w, w, s], [0.0, 0.0, 1.0]),
    ]
    verts, tris, colors = [], [], []
    base = 0
    for v, t, c in parts:
        verts.append(v)
        tris.append(t + base)
        colors.append(c)
        base += len(v)
    v = np.concatenate(verts)
    H = np.asarray(H, np.float64)
    v = v @ H[:3, :3].T + H[:3, 3]
    return {
        "vertices": v.astype(np.float32),
        "triangles": np.concatenate(tris),
        "colors": np.concatenate(colors).astype(np.float32),
    }
