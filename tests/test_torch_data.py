"""Port parity of the training data pipeline (host-side numpy in both
packages): camera rays, the random view trajectory, the mesh ray-cast and
point sampling, and whole ``DataLoader`` batches from the same seed.

Tolerances: rays and poses 1e-6 (float32 trigonometry on two backends);
ray-cast hits with the numpy caster on both sides exact in what was hit and
1e-6 in the interpolated values; sampled clouds exact; batches 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpcr_tpu import native_bindings as JNB
from gpcr_tpu.structures.camera import Camera as JCamera
from gpcr_tpu.structures.ray import Ray as JRay
from gpcr_tpu.train import data as JD
from gpcr_tpu_torch import native_bindings as TNB
from gpcr_tpu_torch.structures.camera import Camera
from gpcr_tpu_torch.structures.ray import Ray
from gpcr_tpu_torch.train import data as TD

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)


def _both_cameras(seed, n_views=3, hw=12):
    jcam = JD.random_view_camera(np.random.RandomState(seed), n_views, hw)
    tcam = TD.random_view_camera(np.random.RandomState(seed), n_views, hw)
    return jcam, tcam


@pytest.mark.parametrize("seed", [0, 5])
def test_random_view_camera_and_rays_match_jax(seed):
    jcam, tcam = _both_cameras(seed)
    assert tcam.H_c2w.shape == (1, 3, 4, 4)
    np.testing.assert_allclose(tcam.H_c2w.numpy(), np.asarray(jcam.H_c2w),
                               atol=1e-6)
    np.testing.assert_allclose(tcam.intrinsic.numpy(),
                               np.asarray(jcam.intrinsic), atol=1e-5)
    # rays from the SAME poses, so only the ray code is compared
    same = Camera(H_c2w=torch.from_numpy(np.array(jcam.H_c2w)),
                  intrinsic=torch.from_numpy(np.array(jcam.intrinsic)),
                  width_px=12, height_px=12)
    for kw in (dict(), dict(subsample=2), dict(offsets=[0.25, -0.25])):
        jo, jd = jcam.generate_camera_rays(**kw)
        to, td = same.generate_camera_rays(**kw)
        assert to.shape == jo.shape and td.shape == jd.shape
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)
    with pytest.raises(NotImplementedError):
        same.generate_camera_rays(offsets="corner")


def test_ray_perturbation_stays_in_cone():
    d = torch.nn.functional.normalize(
        torch.randn(2, 50, 3, generator=torch.Generator().manual_seed(0)),
        dim=-1)
    ray = Ray(origins_w=torch.zeros_like(d), directions_w=d)
    out = ray.random_perturb_direction(torch.Generator().manual_seed(1), 5.0)
    cos = torch.sum(out.directions_w * d, dim=-1)
    assert out.shape == (2, 50)
    assert float(cos.min()) >= np.cos(np.radians(5.0)) - 1e-5
    assert float(cos.max()) < 1.0
    np.testing.assert_allclose(
        torch.linalg.norm(out.directions_w, dim=-1).numpy(), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 3])
def test_mesh_ray_intersection_matches_jax(seed):
    """The numpy caster on both sides."""
    jmesh, tmesh = JD.synthetic_scene(seed), TD.synthetic_scene(seed)
    jmesh._scene = "numpy"
    tmesh._caster = lambda o, d: TNB.numpy_cast(
        tmesh.vertices, tmesh.triangles, o, d)
    jcam, _ = _both_cameras(seed, n_views=2, hw=16)
    o, d = jcam.generate_camera_rays()
    want = jmesh.get_ray_intersection(JRay(origins_w=o, directions_w=d))
    got = tmesh.get_ray_intersection(
        Ray(origins_w=torch.from_numpy(np.array(o)),
            directions_w=torch.from_numpy(np.array(d))))
    assert 0.1 < want["hit_map"].mean() < 1.0
    np.testing.assert_array_equal(got["hit_map"], want["hit_map"])
    for k in ("ray_rgbs", "surface_normals_w", "ray_ts"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-6)


def test_native_caster_agrees_with_numpy_caster():
    mesh = TD.synthetic_scene(1)
    if TNB.get_raytracer() is None:
        pytest.skip("no g++ here: the native ray caster cannot be built")
    _, tcam = _both_cameras(1, n_views=1, hw=16)
    o, d = [x.reshape(-1, 3).numpy() for x in tcam.generate_camera_rays()]
    t, prim, u, v = TNB.NativeRaycaster(mesh.vertices, mesh.triangles).cast(o, d)
    t2, prim2, u2, v2 = TNB.numpy_cast(mesh.vertices, mesh.triangles, o, d)
    np.testing.assert_array_equal(np.isfinite(t), np.isfinite(t2))
    hit = np.isfinite(t)
    assert hit.any()
    np.testing.assert_allclose(t[hit], t2[hit], rtol=1e-4)
    # and with the JAX package's binding of the same source
    jt, jprim, _, _ = JNB.NativeRaycaster(mesh.vertices, mesh.triangles).cast(o, d)
    np.testing.assert_array_equal(prim, jprim)
    np.testing.assert_array_equal(t, jt)


def test_failed_caster_build_raises_and_a_missing_toolchain_falls_back(
        tmp_path, monkeypatch):
    """Only a missing g++ or source selects the numpy caster; a build that
    was attempted and failed raises with the compiler's output."""
    import shutil

    mesh = TD.synthetic_scene(1)
    monkeypatch.setattr(TNB, "_CACHE", {"announced": True})
    monkeypatch.setattr(TNB, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(TNB, "_SRC", str(tmp_path / "missing.cpp"))
    assert TNB.get_raytracer() is None
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.array([[0, 0, 1.0]], np.float32), (4, 1))
    t = TNB.make_caster(mesh.vertices, mesh.triangles)(o, d)[0]
    np.testing.assert_array_equal(
        t, TNB.numpy_cast(mesh.vertices, mesh.triangles, o, d)[0])

    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(TNB, "_CACHE", {"announced": True})
    monkeypatch.setattr(TNB, "_SRC", str(broken))
    if shutil.which("g++") is None:
        assert TNB.get_raytracer() is None
    else:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            TNB.make_caster(mesh.vertices, mesh.triangles)


@pytest.mark.parametrize("method", ["uniform", "uniform_quantized"])
def test_sample_point_cloud_matches_jax(method):
    jmesh, tmesh = JD.synthetic_scene(2), TD.synthetic_scene(2)
    want = jmesh.sample_point_cloud(300, method=method, seed=4,
                                    quantize_scale=96, quantize_offset=512.0)
    got = tmesh.sample_point_cloud(300, method=method, seed=4,
                                   quantize_scale=96, quantize_offset=512.0)
    assert int(got.get_num_valid_points(0)) == int(want.get_num_valid_points(0))
    for k in ("xyz_w", "rgb", "normal_w"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    # the two methods ported later: poisson_disk bit for bit (the same
    # candidates through the same native elimination), uniform_camera's
    # hits equal and their points within 1e-5 (rays made by torch and by
    # jnp differ in the last bits)
    want = jmesh.sample_point_cloud(40, method="poisson_disk", seed=4)
    got = tmesh.sample_point_cloud(40, method="poisson_disk", seed=4)
    for k in ("xyz_w", "rgb", "normal_w"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)))
    want = jmesh.sample_point_cloud(200, method="uniform_camera", seed=4)
    got = tmesh.sample_point_cloud(200, method="uniform_camera", seed=4)
    mask = np.asarray(want.valid_mask)
    np.testing.assert_array_equal(got.valid_mask.numpy(), mask)
    assert mask.sum() > 20
    for k in ("xyz_w", "rgb", "normal_w"):
        np.testing.assert_allclose(
            np.where(mask, getattr(got, k).numpy(), 0),
            np.where(mask, np.asarray(getattr(want, k)), 0), atol=1e-5)


def test_dataloader_batches_match_jax_key_by_key():
    kw = dict(batch_size=2, n_points=300, n_views=2, hw=16, seed=11,
              synthetic_pool=3)
    jdl, tdl = JD.DataLoader(**kw), TD.DataLoader(device="cpu", **kw)
    for _ in range(2):  # the generators stay in step from batch to batch
        want, got = jdl.next_batch(), tdl.next_batch()
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "tanfov":
                assert got[k] == pytest.approx(float(want[k]), rel=1e-6)
                continue
            assert got[k].device.type == "cpu"
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            np.testing.assert_allclose(
                got[k].numpy().astype(np.float32),
                np.asarray(want[k]).astype(np.float32), atol=1e-5, err_msg=k)
    assert got["valid"].dtype == torch.bool


def test_dataloader_reads_a_dataset_tree(tmp_path):
    """<root>/<id>/<id>.obj (+ pcd_0.ply) scenes through the port's own
    OBJ and PLY readers."""
    from gpcr_tpu_torch.io import write_ply

    d = tmp_path / "a"
    d.mkdir()
    (d / "a.obj").write_text(
        "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
        "vt 0 1\nf 1/1 2/2 3/3 4/4\n")
    rng = np.random.RandomState(0)
    xyz = np.round(rng.rand(40, 3) * 20 + 502).astype(np.float32)
    write_ply(str(d / "pcd_0.ply"), xyz, rng.rand(40, 3))
    batch = TD.DataLoader(dataset_root=str(tmp_path), batch_size=1,
                          n_points=64, n_views=1, hw=8, device="cpu").next_batch()
    assert int(batch["valid"].sum()) == 40
    np.testing.assert_array_equal(batch["coords"][0, :40].numpy(), xyz)
    assert batch["gt_rgb"].shape == (1, 1, 8, 8, 3)
    with pytest.raises(FileNotFoundError):
        TD.DataLoader(dataset_root=str(tmp_path / "a"), device="cpu")
