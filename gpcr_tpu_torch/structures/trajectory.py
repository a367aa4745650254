"""Camera trajectories (port of ``gpcr_tpu/structures/trajectory.py``):
circle orbits, the fixed six ``udlrfb`` views, manual eye / up / look-at
lists, ``assign``ed pose arrays, camera files, and the spiral
perturbation of an existing path."""

from __future__ import annotations

import math
import typing as T

import numpy as np
import torch

from ..utils import rigid_motion
from .camera import Camera, derive_camera_intrinsics


def generate_camera_circle_path(
    num_poses: int,
    d_to_origin: float,
    r_circle: float,
    center_angles,
    invert_yz: bool = True,
    alt_yaxis: bool = False,
    device=None,
) -> torch.Tensor:
    """Look-at-origin camera circle: cameras on a circle of radius
    ``r_circle`` in the plane z = ``d_to_origin`` (pre-rotation), the plane
    normal turned to ``center_angles`` = (theta_deg, phi_deg). Returns
    (num_poses, 4, 4) float32 H_c2w with the image yz inversion applied."""
    f32 = dict(dtype=torch.float32, device=device)
    center_angles = torch.as_tensor(np.asarray(center_angles, np.float32),
                                    **f32)
    if invert_yz:
        center_angles = -1.0 * center_angles

    thetas = torch.linspace(0.0, 2.0 * math.pi, num_poses, **f32) + math.pi
    cam_positions_c = torch.stack(
        [
            torch.cos(thetas) * float(r_circle),
            torch.sin(thetas) * float(r_circle),
            torch.ones((num_poses,), **f32) * float(d_to_origin),
        ],
        dim=1,
    )

    v1 = torch.tensor([0.0, 0.0, 1.0], **f32)
    a0 = center_angles[0] * math.pi / 180.0
    a1 = center_angles[1] * math.pi / 180.0
    v2 = torch.stack([torch.cos(a1) * torch.cos(a0),
                      torch.cos(a1) * torch.sin(a0), torch.sin(a1)])
    R = rigid_motion.get_min_R(v1, v2)
    cam_positions_w = (R[None] @ cam_positions_c[..., None])[..., 0]

    ys = torch.zeros_like(cam_positions_w)
    if not alt_yaxis:
        ys[..., 1] = 1.0
    else:
        ys[..., 2] = 1.0
        ys = (R[None] @ ys[..., None])[..., 0]

    Rs_c2w = rigid_motion.construct_coord_frame(z=-1.0 * cam_positions_w, y=ys)
    H = torch.zeros((num_poses, 4, 4), **f32)
    H[:, :3, :3] = Rs_c2w
    H[:, :3, 3] = cam_positions_w
    H[:, 3, 3] = 1.0
    if invert_yz:
        flip = torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], **f32))
        H = flip[None] @ H
    return H


class CameraTrajectory:
    """Pattern of camera poses on ``device``. Modes: ``assign``
    (``params["H_c2w"]``, (q, 4, 4) or (b, q, 4, 4)), ``circle``,
    ``udlrfb`` (the fixed six views), ``manual`` (eye / up / look-at
    strings and a global frame) or a camera file (.npz / .json / .pt /
    .pth) whose path is passed as ``mode``. The reference's removed modes
    ('random', 'spiral', 'rect', ...) raise NotImplementedError, as in the
    JAX package."""

    def __init__(
        self,
        mode: str,
        n_imgs: T.Optional[int],
        total: T.Optional[int],
        rng_seed: T.Union[int, np.random.RandomState] = 0,
        params: T.Optional[dict] = None,
        device=None,
    ):
        self.mode = mode
        self.n_imgs = n_imgs
        self.total = total
        self.device = device
        self.rng = (
            rng_seed
            if isinstance(rng_seed, np.random.RandomState)
            else np.random.RandomState(seed=rng_seed or 0)
        )
        self.params = params or {}
        if mode == "assign":
            H = torch.tensor(np.asarray(self.params["H_c2w"], np.float32),
                             device=device)
            if H.dim() == 3:
                self.n_imgs, self.cam_poses = H.shape[0], H[None]
            elif H.dim() == 4:
                self.total, self.n_imgs = H.shape[0], H.shape[1]
                self.cam_poses = H
            else:
                raise ValueError(
                    f"assign needs H_c2w of (q, 4, 4) or (b, q, 4, 4), got "
                    f"{tuple(H.shape)}")
        elif mode == "circle":
            self.cam_poses = self._set_circle()
        elif mode == "udlrfb":
            self.cam_poses = self._set_udlrfb()
        elif mode == "manual":
            self.cam_poses = self._set_manual()
        elif mode in ("random", "spiral", "sketchfab_poisson", "rex_in",
                      "rect", "basic", "grid", "polar_grid"):
            raise NotImplementedError(
                f"'{mode}' camera removed for simplicity (matches reference).")
        elif mode.lower().endswith((".pt", ".pth", ".npz", ".json")):
            camera = Camera.load(mode, device=device)
            if self.n_imgs is not None:
                camera = camera.uniformly_sample(num_samples=self.n_imgs)
            self.n_imgs = camera.H_c2w.shape[1]
            self.cam_poses = camera.H_c2w
        else:
            raise NotImplementedError(mode)
        if self.total is None:
            self.total = self.cam_poses.shape[0]
        if self.n_imgs is None:
            raise ValueError(f"a '{mode}' trajectory needs n_imgs")

    def _set_circle(self) -> torch.Tensor:
        out = []
        for _ in range(self.total or 1):
            center_angles = self.params.get("center_angles")
            if center_angles is None:
                center_angles = self.rng.rand(2) * 360.0
            d = self.params.get("d")
            if d is None:
                max_r, min_r = self.params["max_r"], self.params["min_r"]
                d = self.rng.rand(1) * (max_r - min_r) + min_r
            r = self.params.get("r")
            if r is None:
                max_angle = self.params["max_angle"]
                r = self.rng.rand(1) * np.tan(max_angle * np.pi / 180.0) * d
            out.append(
                generate_camera_circle_path(
                    num_poses=self.n_imgs,
                    d_to_origin=float(np.asarray(d).reshape(-1)[0]),
                    r_circle=float(np.asarray(r).reshape(-1)[0]),
                    center_angles=np.asarray(center_angles, np.float32),
                    alt_yaxis=False,
                    device=self.device,
                )
            )
        return torch.stack(out, dim=0)

    def _set_udlrfb(self) -> torch.Tensor:
        """Fixed 6 views: up, left, front, right, back, down."""
        assert self.n_imgs == 6
        max_r, min_r = self.params["max_r"], self.params["min_r"]
        out = []
        for _ in range(self.total or 1):
            r = float(self.rng.rand(1)[0] * (max_r - min_r) + min_r)
            ud = generate_camera_circle_path(3, 0.0, r, [0, 0], alt_yaxis=True,
                                             device=self.device)
            lrfb = generate_camera_circle_path(5, 0.0, r, [0, 90],
                                               alt_yaxis=True,
                                               device=self.device)
            out.append(torch.stack([ud[0], *lrfb[:4], ud[1]], dim=0))
        return torch.stack(out, dim=0)

    def _set_manual(self) -> torch.Tensor:
        """Poses from ``params``: 'eye' (one "x y z" string per view),
        optional 'up' and 'look_at' lists (one string, or one per view;
        default +y and the origin), and the global frame 't_c2w', 'y_c2w',
        'z_c2w' ("x y z" strings) applied on the left."""
        p = self.params
        eyes = np.array([[float(i) for i in e.split(" ")] for e in p["eye"]],
                        np.float32).reshape(-1, 3)
        if self.n_imgs != eyes.shape[0]:
            raise ValueError(f"manual: n_imgs {self.n_imgs} but "
                             f"{eyes.shape[0]} eyes")

        def _vec_list(key, default):
            v = p.get(key)
            if v is None:
                return np.broadcast_to(np.array(default, np.float32),
                                       eyes.shape)
            v = np.array([[float(i) for i in x.split(" ")] for x in v],
                         np.float32)
            return np.broadcast_to(v, eyes.shape) if v.shape[0] == 1 else v

        def _vec(key, default):
            v = p.get(key)
            if v is None:
                return np.array(default, np.float32)
            return np.array([float(i) for i in v.split(" ")], np.float32)

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=self.device)

        R_g = rigid_motion.construct_coord_frame(
            z=dev(_vec("z_c2w", [0, 0, 1])), y=dev(_vec("y_c2w", [0, 1, 0])))
        H_g = torch.zeros((4, 4), dtype=torch.float32, device=self.device)
        H_g[:3, :3] = R_g
        H_g[:3, 3] = dev(_vec("t_c2w", [0, 0, 0]))
        H_g[3, 3] = 1.0
        H = rigid_motion.get_H_c2w_lookat(
            dev(eyes), dev(_vec_list("look_at", [0, 0.0, 0])),
            dev(_vec_list("up", [0, 1.0, 0])), invert_y=True)
        H = H_g[None] @ H
        return H[None].repeat(self.total or 1, 1, 1, 1)

    @staticmethod
    def get_spiral_trajectory(H_c2w: torch.Tensor, period: int,
                              radius: float) -> "CameraTrajectory":
        """An ``assign`` trajectory whose camera centers spiral around an
        existing (b, q, 4, 4) path (q >= 2): each center moves by
        radius * (cos, sin) of an angle stepping through ``period`` values
        over [0, 2 pi], along the x / y axes of a frame whose z is the
        path's direction of travel; orientations are kept."""
        b, q = H_c2w.shape[:2]
        if q < 2:
            raise ValueError("a spiral needs a path of at least 2 poses")
        cs, cs_next = H_c2w[:, :-1, :3, 3], H_c2w[:, 1:, :3, 3]
        dz = torch.cat([cs_next - cs, (cs_next - cs)[:, -1:]], dim=1)
        dz = dz / torch.clamp(torch.linalg.norm(dz, dim=-1, keepdim=True),
                              min=1e-9)
        dy = torch.zeros_like(dz)
        dy[..., 1] = 1.0
        frames = rigid_motion.construct_coord_frame(z=dz, y=dy)
        dxs, dys = frames[..., 0], frames[..., 1]
        thetas = torch.linspace(0.0, 2 * math.pi, period,
                                device=H_c2w.device)
        reps = (q + period - 1) // period
        xs = (torch.cos(thetas) * radius).repeat(reps)[:q]
        ys = (torch.sin(thetas) * radius).repeat(reps)[:q]
        newH = H_c2w.clone()
        newH[:, :, :3, 3] += dxs * xs.reshape(1, q, 1) + dys * ys.reshape(1, q, 1)
        return CameraTrajectory(mode="assign", n_imgs=None, total=None,
                                params=dict(H_c2w=newH.cpu().numpy()),
                                device=H_c2w.device)

    def get_camera(self, fov: float, width_px: int, height_px: int) -> Camera:
        K = derive_camera_intrinsics(width_px, height_px, fov,
                                     device=self.cam_poses.device)
        H = self.cam_poses
        if H.dim() == 3:
            H = H[None]
        b, q = H.shape[:2]
        return Camera(
            H_c2w=H,
            intrinsic=K.expand(b, q, 3, 3).clone(),
            width_px=width_px,
            height_px=height_px,
        )
