"""RGBD image batches, depth unprojection and dataset exporters (port of
``gpcr_tpu/structures/rgbd_image.py``).

(b, q, h, w, ·) rgb / depth / normal / hit tensors with their Camera.
``get_pcd`` unprojects every pixel center (u + 0.5, v + 0.5) through
inv(K) and H_c2w into a PointCloud on the camera's device, masking
pixels whose depth is inf, nan, not positive or beyond ``max_depth``.
The exporters write on the host: the PNG tree of ``save_as_dataset``, the
npbg++-, RTMV- and LLFF-style trees, and ``save``'s gif / mp4 (which need
``imageio``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing as T

import numpy as np
import torch

from .camera import Camera
from .pointcloud import PointCloud


def _host(x):
    return None if x is None else x.detach().cpu().numpy()


@dataclasses.dataclass(frozen=True)
class RGBDImage:
    rgb: torch.Tensor  # (b, q, h, w, 3)
    depth: torch.Tensor  # (b, q, h, w) z-depth in camera coords; inf = miss
    camera: Camera
    normal_w: T.Optional[torch.Tensor] = None  # (b, q, h, w, 3)
    hit_map: T.Optional[torch.Tensor] = None  # (b, q, h, w)
    feature: T.Optional[torch.Tensor] = None  # (b, q, h, w, f)

    @property
    def batch_shape(self):
        return tuple(self.rgb.shape[:2])

    # ---- unprojection -------------------------------------------------------

    def get_pcd(self, subsample: int = 1, max_depth: float = 1e11) -> PointCloud:
        """Unproject every pixel into a world-space point cloud on the
        camera's device.

        Points per batch item are flattened over (q, h', w'); invalid pixels
        (inf / nan depth, depth <= 0 or >= max_depth) are masked through
        ``valid_mask`` and their xyz set to 0 (after the product: an inf
        depth makes nan there). Also carries each point's capture z axis,
        its unit view direction and its pixel index ``img_idxs``."""
        cam = self.camera
        dev = cam.device
        b, q, h, w = self.depth.shape
        f32 = dict(dtype=torch.float32, device=dev)
        u = torch.arange(0, w, subsample, **f32)
        v = torch.arange(0, h, subsample, **f32)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        z = self.depth[..., ::subsample, ::subsample].to(dev)
        hh, ww = z.shape[-2:]

        uvw = torch.stack([(uu + 0.5) * z, (vv + 0.5) * z, z], dim=-1)[..., None]
        inv_K = torch.linalg.inv(cam.intrinsic)[:, :, None, None]
        xyz_c = (inv_K @ uvw)[..., 0]
        xyz1 = torch.cat([xyz_c, torch.ones_like(xyz_c[..., :1])], dim=-1)
        H = cam.H_c2w[:, :, None, None]
        xyz_w = (H @ xyz1[..., None])[..., :3, 0]  # (b, q, h', w', 3)

        valid = torch.isfinite(z) & (z > 0) & (z < max_depth)
        zdir = cam.H_c2w[..., :3, 2][:, :, None, None].expand(xyz_w.shape)
        cam_o = cam.H_c2w[..., :3, 3][:, :, None, None].expand(xyz_w.shape)
        view_dir = xyz_w - cam_o
        view_dir = view_dir / torch.clamp(
            torch.linalg.norm(view_dir, dim=-1, keepdim=True), min=1e-12)

        def flat(x, d):
            return x.reshape(b, q * hh * ww, d)

        def sub(x):
            return x[..., ::subsample, ::subsample, :].to(dev)

        img_idxs = torch.arange(q * hh * ww, device=dev).reshape(
            1, q, hh, ww, 1).expand(b, q, hh, ww, 1)
        return PointCloud(
            xyz_w=flat(torch.where(valid[..., None], xyz_w, 0.0), 3),
            rgb=flat(sub(self.rgb), 3),
            normal_w=(None if self.normal_w is None
                      else flat(sub(self.normal_w), 3)),
            valid_mask=flat(valid[..., None], 1),
            captured_z_direction_w=flat(zdir, 3),
            captured_view_direction_w=flat(view_dir, 3),
            img_idxs=flat(img_idxs, 1),
        )

    # ---- patches ------------------------------------------------------------

    def sample_random_patches(self, patch_h: int, patch_w: int, num: int,
                              generator: T.Optional[torch.Generator] = None
                              ) -> dict:
        """``num`` random patch_h x patch_w windows at the same place in
        every image: dict of rgb / depth / normal_w / hit_map, each
        (b, q, num, patch_h, patch_w, ·) or None. Corners are drawn from
        ``generator`` (on the CPU) in [0, max(h - patch_h, 1)) and
        [0, max(w - patch_w, 1))."""
        h, w = self.depth.shape[2:4]
        ys = torch.randint(0, max(h - patch_h, 1), (num,), generator=generator)
        xs = torch.randint(0, max(w - patch_w, 1), (num,), generator=generator)

        def gather(img):
            if img is None:
                return None
            return torch.stack(
                [img[:, :, y:y + patch_h, x:x + patch_w]
                 for y, x in zip(ys.tolist(), xs.tolist())], dim=2)

        return {k: gather(getattr(self, k))
                for k in ("rgb", "depth", "normal_w", "hit_map")}

    # ---- persistence --------------------------------------------------------

    def state_dict(self) -> dict:
        out = {"rgb": _host(self.rgb), "depth": _host(self.depth),
               "camera": self.camera.state_dict()}
        if self.normal_w is not None:
            out["normal_w"] = _host(self.normal_w)
        if self.hit_map is not None:
            out["hit_map"] = _host(self.hit_map)
        return out

    def save(self, out_dir: str, overwrite: bool = True, gif_fps: float = 10.0,
             video: bool = False):
        """``save_as_dataset`` plus, for more than one view, a gif of batch
        item 0's rgb sequence and with ``video`` an mp4 (both need
        ``imageio``)."""
        self.save_as_dataset(out_dir, overwrite=overwrite)
        from ..utils.media import create_gif, create_video

        rgb = _host(self.rgb)
        frames = [rgb[0, iq] for iq in range(rgb.shape[1])]
        if len(frames) > 1:
            create_gif(frames, os.path.join(out_dir, "rgb.gif"), fps=gif_fps)
            if video:
                create_video(frames, os.path.join(out_dir, "rgb.mp4"))

    def save_as_npbgpp(self, out_dir: str):
        """npbg++-style tree: images/ and the cameras as cameras.npz."""
        from ..io.image import save_pic

        os.makedirs(out_dir, exist_ok=True)
        save_pic(_host(self.rgb), os.path.join(out_dir, "images"), "rgb")
        np.savez(
            os.path.join(out_dir, "cameras.npz"),
            H_c2w=_host(self.camera.H_c2w),
            intrinsic=_host(self.camera.intrinsic),
            width_px=self.camera.width_px,
            height_px=self.camera.height_px,
        )

    def save_as_rtmv(self, out_dir: str):
        """RTMV-style tree: rgb PNGs, depth.npy and one camera json per
        view of batch item 0."""
        from ..io.image import save_pic

        os.makedirs(out_dir, exist_ok=True)
        save_pic(_host(self.rgb), out_dir, "rgb")
        np.save(os.path.join(out_dir, "depth.npy"), _host(self.depth))
        q = self.rgb.shape[1]
        K = _host(self.camera.intrinsic)
        H = _host(self.camera.H_c2w)
        for iq in range(q):
            cam = {
                "camera_data": {
                    "width": self.camera.width_px,
                    "height": self.camera.height_px,
                    "intrinsics": {
                        "fx": float(K[0, iq, 0, 0]),
                        "fy": float(K[0, iq, 1, 1]),
                        "cx": float(K[0, iq, 0, 2]),
                        "cy": float(K[0, iq, 1, 2]),
                    },
                    "cam2world": H[0, iq].tolist(),
                }
            }
            with open(os.path.join(out_dir, f"{iq:05d}.json"), "w") as f:
                json.dump(cam, f)

    def save_as_llff(self, out_dir: str):
        """LLFF-style tree: images/ and poses_bounds.npy (q, 17): a 3x5
        pose (R | t | hwf) in LLFF's axes (down, right, backwards) and the
        near / far of the view's finite depths (x0.9 / x1.1)."""
        from ..io.image import save_pic

        os.makedirs(out_dir, exist_ok=True)
        save_pic(_host(self.rgb), os.path.join(out_dir, "images"), "rgb")
        q = self.rgb.shape[1]
        H = _host(self.camera.H_c2w)
        K = _host(self.camera.intrinsic)
        depth = _host(self.depth)
        rows = []
        for iq in range(q):
            R = H[0, iq, :3, :3]
            t = H[0, iq, :3, 3]
            R_llff = np.stack([R[:, 1], R[:, 0], -R[:, 2]], axis=1)
            hwf = np.array(
                [self.camera.height_px, self.camera.width_px, K[0, iq, 0, 0]])
            pose = np.concatenate([R_llff, t[:, None], hwf[:, None]], axis=1)
            d = depth[0, iq]
            finite = d[np.isfinite(d) & (d > 0)]
            near = float(finite.min()) * 0.9 if finite.size else 0.1
            far = float(finite.max()) * 1.1 if finite.size else 10.0
            rows.append(np.concatenate([pose.reshape(-1), [near, far]]))
        np.save(os.path.join(out_dir, "poses_bounds.npy"),
                np.stack(rows).astype(np.float64))

    def save_as_dataset(self, out_dir: str, overwrite: bool = True):
        """Dataset tree: rgb/ PNGs, abs_depth.npy, normal/ PNGs (white
        where nothing was hit), hitmap/ PNGs and camera.json."""
        from ..io.image import save_pic, to_uint8, write_png

        if not overwrite and os.path.exists(out_dir):
            raise FileExistsError(out_dir)
        os.makedirs(out_dir, exist_ok=True)
        save_pic(_host(self.rgb), os.path.join(out_dir, "rgb"), "rgb")
        np.save(os.path.join(out_dir, "abs_depth.npy"), _host(self.depth))
        hm = _host(self.hit_map)
        if self.normal_w is not None:
            save_pic(_host(self.normal_w), os.path.join(out_dir, "normal"),
                     "normal_w", hit_map=None if hm is None else hm[..., None])
        if hm is not None:
            os.makedirs(os.path.join(out_dir, "hitmap"), exist_ok=True)
            b, q = hm.shape[:2]
            for ib in range(b):
                for iq in range(q):
                    write_png(os.path.join(out_dir, "hitmap", f"hit_{iq}.png"),
                              to_uint8(hm[ib, iq]))
        self.camera.save(os.path.join(out_dir, "camera.json"))
