"""Camera trajectories (port of the ``circle`` and ``udlrfb`` modes and
the camera-file mode of ``gpcr_tpu/structures/trajectory.py``)."""

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
    """Pattern of camera poses. Modes: ``circle``, ``udlrfb`` (the fixed
    six views) or a camera file (.npz / .json / .pt / .pth) whose path is
    passed as ``mode``; the other modes of the JAX package (``assign``,
    ``manual``, the spiral) raise NotImplementedError."""

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
        if mode == "circle":
            self.cam_poses = self._set_circle()
        elif mode == "udlrfb":
            self.cam_poses = self._set_udlrfb()
        elif mode.lower().endswith((".pt", ".pth", ".npz", ".json")):
            camera = Camera.load(mode, device=device)
            if self.n_imgs is not None:
                camera = camera.uniformly_sample(num_samples=self.n_imgs)
            self.n_imgs = camera.H_c2w.shape[1]
            self.cam_poses = camera.H_c2w
        else:
            raise NotImplementedError(
                f"camera trajectory mode '{mode}' is not ported yet "
                f"('circle', 'udlrfb' or a camera file)")
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

    def get_camera(self, fov: float, width_px: int, height_px: int) -> Camera:
        K = derive_camera_intrinsics(width_px, height_px, fov,
                                     device=self.cam_poses.device)
        H = self.cam_poses
        b, q = H.shape[:2]
        return Camera(
            H_c2w=H,
            intrinsic=K.expand(b, q, 3, 3).clone(),
            width_px=width_px,
            height_px=height_px,
        )
