"""Cameras, trajectories, the z-buffer rasterizer, RGBD images and mesh
sampling of the port against ``gpcr_tpu`` on the same numpy inputs.

Tolerances: poses (look-at, manual, assign, spiral) at 1e-6; the
rasterizer's ``prim`` and hit mask equal, its barycentrics and depth at
1e-5 (both are the same numpy code); ray-cast RGBD and unprojected points
at 1e-5 (rays made by torch and by jnp differ in the last bits) with equal
hit masks; exported files byte-equal; ``sample_elimination`` and the
seeded sampling methods equal (the same RandomState and the same native
source). ``generate_random_camera_poses`` draws from a torch.Generator,
so only its ranges are held.
"""

import json
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu import native_bindings as JNB
from gpcr_tpu.structures.camera import Camera as JCamera
from gpcr_tpu.structures.mesh import Mesh as JMesh
from gpcr_tpu.structures.trajectory import CameraTrajectory as JTraj
from gpcr_tpu.train import data as JD
from gpcr_tpu.utils import rigid_motion as JRM
from gpcr_tpu_torch import native_bindings as TNB
from gpcr_tpu_torch.structures.camera import Camera, derive_camera_intrinsics
from gpcr_tpu_torch.structures.mesh import Mesh
from gpcr_tpu_torch.structures.rgbd_image import RGBDImage
from gpcr_tpu_torch.structures.trajectory import CameraTrajectory
from gpcr_tpu_torch.train import data as TD
from gpcr_tpu_torch.utils import rigid_motion as TRM

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

EYES = np.array([[0.3, -0.2, -2.2], [2.0, 0.5, 0.3], [-0.4, 1.9, 1.1]],
                np.float32)


def _cams(eyes=EYES, w=48, h=40, fov=55.0):
    """The same look-at cameras for both packages (from the port's poses,
    which equal JAX's)."""
    H = TRM.get_H_c2w_lookat(torch.as_tensor(eyes),
                             torch.zeros(len(eyes), 3),
                             torch.tensor([[0.0, 1.0, 0.0]]).expand(len(eyes), 3))
    K = derive_camera_intrinsics(w, h, fov).expand(1, len(eyes), 3, 3)
    tcam = Camera(H_c2w=H[None], intrinsic=K, width_px=w, height_px=h)
    jcam = JCamera(H_c2w=jnp.asarray(H[None].numpy()),
                   intrinsic=jnp.asarray(K.numpy()), width_px=w, height_px=h)
    return jcam, tcam


def _quads():
    """A small quad in front of a large one (the occlusion scene)."""
    s1, s2, z1, z2 = 0.4, 1.0, -0.5, 0.5
    v = np.array([[-s1, -s1, z1], [s1, -s1, z1], [s1, s1, z1], [-s1, s1, z1],
                  [-s2, -s2, z2], [s2, -s2, z2], [s2, s2, z2], [-s2, s2, z2]],
                 np.float32)
    t = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    d = {"vertices": v, "triangles": t, "textures": [],
         "material_ids": np.zeros(4, np.int32)}
    return (JMesh(dict(d), scale=None, center_w=None),
            Mesh(dict(d), scale=None, center_w=None))


def _meshes(kind):
    return _quads() if kind == "quads" else (JD.synthetic_scene(2),
                                             TD.synthetic_scene(2))


def test_lookat_and_trajectories_match_jax():
    up = np.array([[0, 1, 0], [0, 0, 1], [0.2, 1, 0]], np.float32)
    look = np.array([[0, 0, 0], [0.1, 0.2, 0], [0, 0, 0.3]], np.float32)
    for invert_y in (True, False):
        want = JRM.get_H_c2w_lookat(jnp.asarray(EYES), jnp.asarray(look),
                                    jnp.asarray(up), invert_y=invert_y)
        got = TRM.get_H_c2w_lookat(torch.as_tensor(EYES), look, up,
                                   invert_y=invert_y)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # one eye, broadcast up / look-at
    np.testing.assert_allclose(
        TRM.get_H_c2w_lookat(EYES[0], np.zeros(3), up[0]).numpy(),
        np.asarray(JRM.get_H_c2w_lookat(jnp.asarray(EYES[0]), jnp.zeros(3),
                                        jnp.asarray(up[0]))), atol=1e-6)

    manual = {"eye": ["0 0 3", "2.5 0.4 0", "-1 2 1.5"],
              "up": ["0 1 0", "0 0 1", "0.1 1 0"]}
    want = JTraj("manual", n_imgs=3, total=None, params=manual)
    got = CameraTrajectory("manual", n_imgs=3, total=None, params=manual)
    np.testing.assert_allclose(got.cam_poses.numpy(),
                               np.asarray(want.cam_poses), atol=1e-6)
    with pytest.raises(ValueError):
        CameraTrajectory("manual", n_imgs=4, total=None, params=manual)
    with pytest.raises(NotImplementedError):
        CameraTrajectory("spiral", n_imgs=4, total=None)

    H = np.asarray(want.cam_poses)
    for arr in (H[0], H):  # (q, 4, 4) and (b, q, 4, 4)
        j = JTraj("assign", n_imgs=None, total=None, params={"H_c2w": arr})
        t = CameraTrajectory("assign", n_imgs=None, total=None,
                             params={"H_c2w": arr})
        assert (t.n_imgs, t.total) == (j.n_imgs, j.total)
        np.testing.assert_array_equal(t.cam_poses.numpy(),
                                      np.asarray(j.cam_poses))
        jc, tc = j.get_camera(50.0, 24, 20), t.get_camera(50.0, 24, 20)
        np.testing.assert_allclose(tc.intrinsic.numpy(),
                                   np.asarray(jc.intrinsic), atol=1e-6)

    for period, radius in ((2, 0.1), (3, 0.25), (5, 0.5)):
        j = JTraj.get_spiral_trajectory(want.cam_poses, period, radius)
        t = CameraTrajectory.get_spiral_trajectory(got.cam_poses, period,
                                                   radius)
        assert t.mode == "assign" and (t.n_imgs, t.total) == (3, 1)
        np.testing.assert_allclose(t.cam_poses.numpy(),
                                   np.asarray(j.cam_poses), atol=1e-6)


def test_random_camera_poses_ranges():
    n, min_r, max_r, max_angle, local, ratio = 4000, 2.0, 3.5, 60.0, 3.0, 2.0
    g = torch.Generator().manual_seed(0)
    H = TRM.generate_random_camera_poses(n, min_r, max_r, max_angle, local,
                                         ratio, generator=g)
    assert H.shape == (n, 4, 4) and bool(torch.isfinite(H).all())
    eye = H[:, :3, 3].double()
    r = torch.linalg.norm(eye, dim=-1)
    assert float(r.min()) >= min_r - 1e-5 and float(r.max()) <= max_r + 1e-5
    assert float(r.min()) < min_r + 0.05 and float(r.max()) > max_r - 0.05
    elev = torch.rad2deg(torch.asin(eye[:, 2] / r))
    assert float(elev.abs().max()) <= max_angle / 2 + 1e-3
    assert float(elev.abs().max()) > max_angle / 2 - 1.0
    # the optical axis points at a look-at point within the jitter cube
    jitter = math.sqrt(3) * math.radians(local) * ratio
    cosang = (H[:, :3, 2].double() * -eye).sum(-1) / r
    assert float(torch.rad2deg(torch.acos(cosang.clamp(max=1.0))).max()) <= (
        math.degrees(math.asin(jitter / min_r)) + 1e-3)
    R = H[:, :3, :3].double()
    eye3 = torch.eye(3, dtype=torch.float64).expand(n, 3, 3)
    np.testing.assert_allclose((R.transpose(1, 2) @ R).numpy(), eye3.numpy(),
                               atol=1e-5)
    again = TRM.generate_random_camera_poses(
        n, min_r, max_r, max_angle, local, ratio,
        generator=torch.Generator().manual_seed(0))
    assert torch.equal(H, again)


@pytest.mark.parametrize("kind", ["quads", "textured"])
def test_zbuffer_rasterizer_matches_jax(kind):
    jmesh, tmesh = _meshes(kind)
    jcam, tcam = _cams()
    for iq in range(3):
        H_w2c = np.linalg.inv(tcam.H_c2w[0, iq].numpy())
        K = tcam.intrinsic[0, iq].numpy()
        want = jmesh._rasterize_view(H_w2c, K, 48, 40)
        got = tmesh._rasterize_view(H_w2c, K, 48, 40)
        for name, g, w in zip(("prim", "bary", "zbuf", "hit"), got, want):
            if name in ("prim", "hit"):
                np.testing.assert_array_equal(g, w)
            else:
                fin = np.isfinite(w)
                np.testing.assert_array_equal(np.isfinite(g), fin)
                np.testing.assert_allclose(g[fin], w[fin], atol=1e-5)
        assert 0 < got[3].sum() < got[3].size
    for method in ("rasterization", "ray_cast"):
        want = jmesh.get_rgbd_image(jcam, render_method=method)
        got = tmesh.get_rgbd_image(tcam, render_method=method)
        assert isinstance(got, RGBDImage) and got.batch_shape == (1, 3)
        hit = np.asarray(want.hit_map)
        np.testing.assert_array_equal(got.hit_map.numpy(), hit)
        for k in ("rgb", "normal_w"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       atol=1e-5)
        d, dw = got.depth.numpy(), np.asarray(want.depth)
        np.testing.assert_array_equal(np.isfinite(d), hit > 0)
        np.testing.assert_allclose(d[hit > 0], dw[hit > 0], atol=1e-5)
    # the two methods against each other, to tests/test_mesh.py's bars
    rc = tmesh.get_rgbd_image(tcam, render_method="ray_cast")
    rs = tmesh.get_rgbd_image(tcam, render_method="rasterization")
    h1, h2 = rc.hit_map.numpy() > 0.5, rs.hit_map.numpy() > 0.5
    assert (h1 ^ h2).mean() < 0.02
    both = h1 & h2
    np.testing.assert_allclose(rc.depth.numpy()[both], rs.depth.numpy()[both],
                               atol=1e-3)
    with pytest.raises(NotImplementedError):
        tmesh.get_rgbd_image(tcam, render_method="splat")


@pytest.mark.parametrize("subsample,max_depth", [(1, 1e11), (2, 2.6)])
def test_get_pcd_matches_jax(subsample, max_depth):
    jmesh, tmesh = _meshes("textured")
    jcam, tcam = _cams()
    want = jmesh.get_rgbd_image(jcam).get_pcd(subsample, max_depth)
    got = tmesh.get_rgbd_image(tcam).get_pcd(subsample, max_depth)
    mask = np.asarray(want.valid_mask)
    np.testing.assert_array_equal(got.valid_mask.numpy(), mask)
    assert 0 < mask.sum() < mask.size
    for k in ("xyz_w", "rgb", "normal_w", "captured_z_direction_w",
              "captured_view_direction_w"):
        np.testing.assert_allclose(
            np.where(mask, getattr(got, k).numpy(), 0),
            np.where(mask, np.asarray(getattr(want, k)), 0), atol=1e-5,
            err_msg=k)
    # invalid pixels: xyz set to 0 after the product (inf depth gives nan)
    assert not got.xyz_w.numpy()[~mask[..., 0]].any()
    np.testing.assert_array_equal(got.img_idxs.numpy(),
                                  np.asarray(want.img_idxs))


def test_rgbd_exports_match_jax(tmp_path):
    jmesh, tmesh = _meshes("textured")
    jcam, tcam = _cams(w=24, h=20)
    jr, tr = jmesh.get_rgbd_image(jcam), tmesh.get_rgbd_image(tcam)
    # the same image on both sides, so that the files can be byte-equal
    jr = jr.replace(rgb=tr.rgb.numpy(), depth=tr.depth.numpy(),
                    normal_w=tr.normal_w.numpy(), hit_map=tr.hit_map.numpy())
    for fn in ("save_as_dataset", "save_as_npbgpp", "save_as_rtmv",
               "save_as_llff", "save"):
        getattr(tr, fn)(str(tmp_path / "t" / fn))
        getattr(jr, fn)(str(tmp_path / "j" / fn))
    tfiles = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "t")
                    for r, _, fs in os.walk(tmp_path / "t") for f in fs)
    jfiles = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "j")
                    for r, _, fs in os.walk(tmp_path / "j") for f in fs)
    assert tfiles == jfiles and "save/rgb.gif" in tfiles
    for rel in tfiles:
        a, b = tmp_path / "t" / rel, tmp_path / "j" / rel
        if rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                np.testing.assert_array_equal(za[k], zb[k])
        elif rel.endswith(".json"):
            assert json.loads(a.read_text()) == json.loads(b.read_text()), rel
        else:
            assert a.read_bytes() == b.read_bytes(), rel
    sd, jsd = tr.state_dict(), jr.state_dict()
    assert sorted(sd) == sorted(jsd)
    for k in ("rgb", "depth", "normal_w", "hit_map"):
        np.testing.assert_array_equal(sd[k], jsd[k])

    g = torch.Generator().manual_seed(3)
    patches = tr.sample_random_patches(8, 6, 5, generator=g)
    assert patches["rgb"].shape == (1, 3, 5, 8, 6, 3)
    assert patches["depth"].shape == (1, 3, 5, 8, 6)
    g = torch.Generator().manual_seed(3)
    ys = torch.randint(0, 20 - 8, (5,), generator=g)
    xs = torch.randint(0, 24 - 6, (5,), generator=g)
    for i in range(5):
        y, x = int(ys[i]), int(xs[i])
        assert torch.equal(patches["normal_w"][:, :, i],
                           tr.normal_w[:, :, y:y + 8, x:x + 6])


def test_sample_elimination_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.rand(400, 3).astype(np.float32)
    pts[:, 2] = 0.0
    want = JNB.sample_elimination(pts, 100, 0.05)
    got = TNB.sample_elimination(pts, 100, 0.05)
    np.testing.assert_array_equal(got, want)
    py = TNB._sample_elimination_numpy(pts, 100, 0.05, 8.0)
    assert set(map(int, py)) == set(map(int, want))
    np.testing.assert_array_equal(TNB.sample_elimination(pts, 500, 0.05),
                                  np.arange(400))
    with pytest.raises(ValueError):
        TNB.sample_elimination(pts[:, :2], 10, 0.05)


def _tiny_obj(d):
    """A textured tetrahedron-ish OBJ with an MTL and a PNG texture."""
    from gpcr_tpu_torch.io import write_png

    os.makedirs(d, exist_ok=True)
    tex = (np.random.RandomState(2).rand(8, 8, 3) * 255).astype(np.uint8)
    write_png(os.path.join(d, "tex.png"), tex)
    with open(os.path.join(d, "mat.mtl"), "w") as f:
        f.write("newmtl m0\nKd 1 1 1\nmap_Kd tex.png\n")
    with open(os.path.join(d, "t.obj"), "w") as f:
        f.write("mtllib mat.mtl\n"
                "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nv 1 1 0.5\n"
                "vt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\nusemtl m0\n"
                "f 1/1 3/3 2/2\nf 1/1 2/2 4/4\nf 1/1 4/4 3/3\n"
                "f 2/2 3/3 4/4\nf 2/2 5/4 3/3\n")
    return os.path.join(d, "t.obj")


@pytest.mark.parametrize("method", ["uniform", "uniform_quantized",
                                    "poisson_disk", "uniform_camera"])
def test_sample_point_cloud_from_obj_matches_jax(tmp_path, method):
    obj = _tiny_obj(str(tmp_path))
    want = JMesh(obj, scale=1.0).sample_point_cloud(150, method=method,
                                                     seed=1)
    got = Mesh(obj, scale=1.0).sample_point_cloud(150, method=method, seed=1,
                                                  device="cpu")
    assert got.xyz_w.shape == want.xyz_w.shape
    if method == "uniform_camera":
        mask = np.asarray(want.valid_mask)
        np.testing.assert_array_equal(got.valid_mask.numpy(), mask)
        assert mask.sum() > 20
        for k in ("xyz_w", "rgb", "normal_w"):
            np.testing.assert_allclose(
                np.where(mask, getattr(got, k).numpy(), 0),
                np.where(mask, np.asarray(getattr(want, k)), 0), atol=1e-5)
        return
    for k in ("xyz_w", "rgb", "normal_w"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
