"""Training data pipeline: meshes -> (point cloud, views, GT images)
batches (port of ``gpcr_tpu/train/data.py``).

The reference's dataset config (options.yaml dataset_info: THuman meshes,
ray_cast render_method, random camera mode, 512² targets, 100K-2M point
clouds) rebuilt on the port's own tooling: mesh sampling
(structures.Mesh.sample_point_cloud), ray-cast ground truth
(Mesh.get_ray_intersection), and PCGC-grid quantization — emitting exactly
the batch dict consumed by ``train.trainer.Trainer``. Examples are made on
the host with numpy (``RandomState`` seeds as in the JAX package, so both
loaders give the same batch from the same seed); ``next_batch`` moves the
stacked batch to the loader's device.

For environments without mesh assets, ``synthetic_scene`` builds random
textured primitive meshes so the full train loop is runnable end-to-end.
"""

from __future__ import annotations

import typing as T

import numpy as np
import torch

from ..render.renderer import get_rasterize_param_from_camera
from ..structures.camera import Camera
from ..structures.mesh import Mesh
from ..structures.ray import Ray
from ..structures.trajectory import CameraTrajectory


def synthetic_scene(seed: int = 0, n_quads: int = 24) -> Mesh:
    """Random textured quad-soup mesh around the origin (unit scale)."""
    rng = np.random.RandomState(seed)
    verts, tris, uvs = [], [], []
    for i in range(n_quads):
        c = rng.uniform(-0.7, 0.7, 3)
        u = rng.randn(3); u /= np.linalg.norm(u)
        v = rng.randn(3); v -= u * (u @ v); v /= np.linalg.norm(v)
        s = rng.uniform(0.15, 0.45)
        base = len(verts)
        verts += [c - u * s - v * s, c + u * s - v * s,
                  c + u * s + v * s, c - u * s + v * s]
        tris += [[base, base + 1, base + 2], [base, base + 2, base + 3]]
        uvs += [[[0, 0], [1, 0], [1, 1]], [[0, 0], [1, 1], [0, 1]]]
    tex = rng.rand(16, 16, 3).astype(np.float32)
    return Mesh(
        {
            "vertices": np.asarray(verts, np.float32),
            "triangles": np.asarray(tris, np.int32),
            "triangle_uvs": np.asarray(uvs, np.float32),
            "textures": [tex],
            "material_ids": np.zeros(len(tris), np.int32),
        },
        scale=1.0,
    )


def random_view_camera(rng, n_views: int, hw: int, fov: float = 60.0,
                       min_r: float = 1.7, max_r: float = 3.0) -> Camera:
    """Random orbit views (output_cam_mode 'random' analogue,
    options.yaml dataset_info)."""
    traj = CameraTrajectory(
        mode="circle", n_imgs=n_views, total=1,
        rng_seed=int(rng.randint(0, 2**31)),
        params={"min_r": min_r, "max_r": max_r, "max_angle": 30.0},
    )
    return traj.get_camera(fov=fov, width_px=hw, height_px=hw)


def _with_views(coords, rgbs, valid, mesh: Mesh, rng, n_views: int, hw: int,
                fov: float) -> dict:
    """Complete an example: random views of the mesh and their ray-cast
    ground truth beside the padded cloud."""
    cam = random_view_camera(rng, n_views, hw, fov=fov)
    o, d = cam.generate_camera_rays(subsample=1, offsets="center")
    gt = mesh.get_ray_intersection(Ray(origins_w=o, directions_w=d))
    rp = get_rasterize_param_from_camera(cam, fov, super_sample_rate=1)
    return {
        "coords": coords,
        "rgb": rgbs,
        "valid": valid,
        "view_t": rp["view_t"].numpy(),
        "full_t": rp["full_t"].numpy(),
        "campos": rp["campos"].numpy(),
        "gt_rgb": np.asarray(gt["ray_rgbs"][0], np.float32),
        "gt_normal": np.asarray(gt["surface_normals_w"][0], np.float32),
        "gt_hit": np.asarray(gt["hit_map"][0], np.float32)[..., None],
        "tanfov": np.float32(rp["tanfov"]),
    }


def scene_to_example(
    mesh: Mesh, rng, n_points: int, n_views: int, hw: int,
    scale_factor: int = 96, offset: float = 512.0, fov: float = 60.0,
    sample_method: str = "uniform_quantized",
) -> dict:
    """One training example: quantized cloud + views + ray-cast GT."""
    pcd = mesh.sample_point_cloud(
        n_points, method=sample_method, seed=int(rng.randint(0, 2**31)),
        quantize_scale=scale_factor, quantize_offset=offset,
    )
    n_valid = int(pcd.get_num_valid_points(0))
    coords = np.zeros((n_points, 3), np.float32)
    rgbs = np.zeros((n_points, 3), np.float32)
    take = min(n_valid, n_points)
    coords[:take] = pcd.xyz_w[0].numpy()[:take]
    rgbs[:take] = pcd.rgb[0].numpy()[:take]
    valid = np.arange(n_points) < take

    return _with_views(coords, rgbs, valid, mesh, rng, n_views, hw, fov)


def cloud_to_example(
    coords_grid: np.ndarray, rgb: np.ndarray, mesh: Mesh, rng,
    n_points: int, n_views: int, hw: int, fov: float = 60.0,
) -> dict:
    """One example from a FIXED pre-quantized cloud (dataset `pcd_0.ply`
    layout) + its mesh GT: random views, ray-cast targets."""
    n = len(coords_grid)
    if n > n_points:
        keep = rng.choice(n, n_points, replace=False)
        coords_grid, rgb = coords_grid[keep], rgb[keep]
        n = n_points
    coords = np.zeros((n_points, 3), np.float32)
    rgbs = np.zeros((n_points, 3), np.float32)
    coords[:n], rgbs[:n] = coords_grid, rgb
    valid = np.arange(n_points) < n

    return _with_views(coords, rgbs, valid, mesh, rng, n_views, hw, fov)


class DataLoader:
    """Batches of training examples from meshes (or synthetic scenes).

    Scene sources (checked in order):
    - ``dataset_root``: THuman-style trees ``<root>/<id>/<id>.obj`` (mesh
      GT; required) + optional ``<root>/<id>/pcd_0.ply`` (fixed
      pre-quantized cloud, used instead of re-sampling when present) —
      the layout the reference benchmark consumes
      (simple_benchmark.py:174-186) and its options.yaml dataset_info
      points at.
    - ``mesh_paths``: explicit .obj list (clouds re-sampled per example).
    - neither: a pool of synthetic quad-soup scenes.
    """

    def __init__(
        self,
        mesh_paths: T.Optional[T.Sequence[str]] = None,
        batch_size: int = 2,
        n_points: int = 4096,
        n_views: int = 2,
        hw: int = 64,
        scale_factor: int = 96,
        seed: int = 0,
        synthetic_pool: int = 8,
        dataset_root: T.Optional[str] = None,
        ids: T.Optional[T.Sequence[str]] = None,
        offset: float = 512.0,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.rng = np.random.RandomState(seed)
        self.batch_size = batch_size
        self.n_points = n_points
        self.n_views = n_views
        self.hw = hw
        self.scale_factor = scale_factor
        self.offset = offset
        # each scene: {"mesh": Mesh, "coords": grid coords or None, "rgb"}
        self.scenes: T.List[dict] = []
        if dataset_root:
            import os

            from ..io.ply import read_ply

            for id in (ids or sorted(os.listdir(dataset_root))):
                obj = os.path.join(dataset_root, id, f"{id}.obj")
                if not os.path.isfile(obj):
                    continue
                scene = {"mesh": Mesh(obj, scale=1.0), "coords": None,
                         "rgb": None, "id": id}
                ply = os.path.join(dataset_root, id, "pcd_0.ply")
                if os.path.isfile(ply):
                    d = read_ply(ply)
                    scene["coords"] = np.asarray(d["xyz"], np.float32)
                    scene["rgb"] = np.asarray(d["rgb"], np.float32)
                self.scenes.append(scene)
            if not self.scenes:
                raise FileNotFoundError(
                    f"no <id>/<id>.obj scenes under {dataset_root}"
                )
        elif mesh_paths:
            self.scenes = [
                {"mesh": Mesh(p, scale=1.0), "coords": None, "rgb": None}
                for p in mesh_paths
            ]
        else:
            self.scenes = [
                {"mesh": synthetic_scene(seed=s), "coords": None, "rgb": None}
                for s in range(synthetic_pool)
            ]

    def _example(self, scene) -> dict:
        if scene["coords"] is not None:
            return cloud_to_example(
                scene["coords"], scene["rgb"], scene["mesh"], self.rng,
                self.n_points, self.n_views, self.hw,
            )
        return scene_to_example(
            scene["mesh"], self.rng, self.n_points, self.n_views, self.hw,
            scale_factor=self.scale_factor, offset=self.offset,
        )

    def next_batch(self) -> dict:
        examples = [
            self._example(self.scenes[self.rng.randint(len(self.scenes))])
            for _ in range(self.batch_size)
        ]
        batch = {
            k: torch.from_numpy(np.stack([e[k] for e in examples])).to(
                self.device)
            for k in examples[0]
            if k != "tanfov"
        }
        batch["tanfov"] = float(examples[0]["tanfov"])
        return batch
