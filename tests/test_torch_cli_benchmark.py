"""The scored benchmark CLI of the port (``gpcr_tpu_torch.cli.benchmark``)
on the textured-cube dataset of tests/test_cli.py: mesh ground truth,
PSNR / MS-SSIM / LPIPS scoring, ``--metric_only`` and the ``cam`` task,
against ``gpcr_tpu`` where both compute the same thing.

The CLI's cameras are fixed at 12 views of 512² (x2 supersampled); the
render tests swap in a 2-view 32 px camera so that the CPU's plain blend
stays cheap (``_camera_for`` itself is tested on its own). Tolerances: the
scores of one pair of directories at 1e-5 between the packages (the same
PNG bytes); ground-truth images of the two packages within one uint8 step
(rays made by torch and by jnp differ in the last bits); camera poses at
1e-5.
"""

import os

import numpy as np
import pytest
import torch

from gpcr_tpu.cli import benchmark as JB
from gpcr_tpu.cli import pic_metrics as JPM
from gpcr_tpu.io.image import save_pic as j_save_pic
from gpcr_tpu.structures.camera import Camera as JCamera
from gpcr_tpu.structures.pointcloud import PointCloud as JPointCloud
from gpcr_tpu.structures.trajectory import CameraTrajectory as JTraj
from gpcr_tpu_torch.cli import benchmark as TB
from gpcr_tpu_torch.io import read_png, write_ply, write_png
from gpcr_tpu_torch.render import renderer as TRD
from gpcr_tpu_torch.structures.camera import Camera
from gpcr_tpu_torch.structures.mesh import Mesh
from gpcr_tpu_torch.structures.pointcloud import PointCloud
from gpcr_tpu_torch.structures.trajectory import CameraTrajectory

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)

FOV, SF = 60, 96
CAM_INFO = {"fov": FOV, "width_px": 32, "height_px": 32, "mode": "circle",
            "n_imgs": 2, "d": 0, "r": 3, "center_angles": [90, 0]}


def make_dataset(root, asset_id="0001"):
    """Textured cube OBJ in the reference layout <root>/<id>/<id>.obj
    (tests/test_cli.py's) plus its sampled cloud, without normals."""
    d = os.path.join(root, asset_id)
    os.makedirs(d, exist_ok=True)
    tex = np.zeros((8, 8, 3), np.uint8)
    tex[:4, :, 0] = 255
    tex[4:, :, 1] = 255
    write_png(os.path.join(d, "tex.png"), tex)
    with open(os.path.join(d, "mat.mtl"), "w") as f:
        f.write("newmtl m0\nKd 1 1 1\nmap_Kd tex.png\n")
    v = [(-1, -1, -1), (1, -1, -1), (1, 1, -1), (-1, 1, -1),
         (-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]
    quads = [(1, 2, 3, 4), (5, 8, 7, 6), (1, 5, 6, 2),
             (2, 6, 7, 3), (3, 7, 8, 4), (5, 1, 4, 8)]
    obj = os.path.join(d, f"{asset_id}.obj")
    with open(obj, "w") as f:
        f.write("mtllib mat.mtl\n")
        for x, y, z in v:
            f.write(f"v {x} {y} {z}\n")
        f.write("vt 0.1 0.1\nvt 0.9 0.1\nvt 0.9 0.9\nvt 0.1 0.9\n")
        f.write("usemtl m0\n")
        for a, b, c, e in quads:
            f.write(f"f {a}/1 {b}/2 {c}/3 {e}/4\n")
    pcd = Mesh(obj, scale=1.0).sample_point_cloud(
        4000, method="uniform_quantized", quantize_scale=float(SF))
    write_ply(os.path.join(d, "pcd_0.ply"), pcd.xyz_w[0].numpy(),
              pcd.rgb[0].numpy())
    return obj


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """One scored ``simple`` run of the port on the cube, with the small
    camera: (root, rpth, returned dict, captured stdout)."""
    import contextlib
    import io

    root = str(tmp_path_factory.mktemp("bench"))
    make_dataset(root)
    rpth = os.path.join(root, "out") + "/"
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        _small_camera(mp)
        res = TB.main(_argv("simple", root, rpth))
    return root, rpth, res, buf.getvalue()


def _argv(task, root, rpth, *more):
    return [task, "--id_list", "0001", "--dataset_root", root, "--rpth", rpth,
            "--voxelized", "--scale_factor", str(SF), "--fov", str(FOV),
            "--background_color", "1", "--dup_cap", "64", "--device", "cpu",
            *more]


def _small_camera(monkeypatch):
    """Swap the CLI's 12 views of 512² for 2 views of 32 px."""
    monkeypatch.setattr(
        TB, "_camera_for", lambda args, task, device: (
            TRD.generate_cam(CAM_INFO, device=device), CAM_INFO))


def test_simple_task_scores_against_its_mesh(scored):
    root, rpth, res, out = scored
    images, timing = res["0001"]
    assert images["rgb"].shape == (1, 2, 32, 32, 3)
    assert "[Info] avg_dist:" in out  # the cloud had no normals
    assert "LPIPS SKIPPED" in out
    render_dir, gt_dir = rpth + "0001_simple_sigma_1.0", rpth + "0001_mesh_gt"
    for d, names in ((gt_dir, ["rgb_0.png", "rgb_1.png", "normal_w_0.png"]),
                     (render_dir, ["rgb_0.png", "rgb_1.png", "xyz_w_1.png"]),
                     (rpth + "difmap2/diff", ["rgb_0.png", "rgb_1.png"])):
        for name in names:
            assert os.path.exists(os.path.join(d, name)), (d, name)
    s = timing["scores"]
    assert np.isfinite(s["psnr"]) and s["psnr"] > 8.0, s
    assert 0.0 <= s["msssim"] <= 1.0 and s["lpips"] is None
    assert timing["gt_time"] > 0 and timing["score_time"] > 0
    # the lines the scorer printed, letter for letter
    assert (f"psnr between {render_dir} and {gt_dir}: "
            + "{:06}".format(s["psnr"])) in out
    assert (f"MS-SSIM between {render_dir} and {gt_dir}: "
            + "{:06}".format(s["msssim"])) in out
    # the JAX package scores the same directories the same
    assert abs(JPM.psnr_dirs(render_dir, gt_dir) - s["psnr"]) <= 1e-5
    assert abs(JPM.msssim_dirs(render_dir, gt_dir) - s["msssim"]) <= 1e-5


def test_mesh_ground_truth_matches_jax(scored, tmp_path):
    root, rpth, _, _ = scored
    traj = JTraj(mode="circle", n_imgs=2, total=1, params=CAM_INFO)
    jcam = traj.get_camera(fov=FOV, width_px=32, height_px=32)
    obj = os.path.join(root, "0001", "0001.obj")
    ref = JB.get_gt(obj, jcam)
    got = TB.get_gt(obj, TRD.generate_cam(CAM_INFO))
    assert got["hit_map"].shape == (1, 2, 32, 32)
    assert 0.1 < got["hit_map"].mean() < 0.9
    assert np.mean(got["hit_map"] != np.asarray(ref["hit_map"])) <= 0.01
    rgb = np.asarray(ref["ray_rgbs"]) + (
        1 - np.asarray(ref["hit_map"])[..., None]) * 1.0
    j_save_pic(rgb, str(tmp_path / "jgt"), "rgb")
    for i in range(2):
        a = read_png(rpth + f"0001_mesh_gt/rgb_{i}.png").astype(int)
        b = read_png(str(tmp_path / "jgt" / f"rgb_{i}.png")).astype(int)
        # a ray on a silhouette or texture edge may fall on the other side
        assert np.mean(np.abs(a - b) > 1) <= 0.01


def test_metric_only_scores_the_same_directories(scored, monkeypatch, capsys):
    root, rpth, res, _ = scored
    _small_camera(monkeypatch)
    before = os.path.getmtime(rpth + "0001_simple_sigma_1.0/rgb_0.png")
    again = TB.main(_argv("simple", root, rpth, "--metric_only"))
    images, timing = again["0001"]
    assert images is None and "rgb_time" not in timing
    assert timing["scores"] == res["0001"][1]["scores"]
    assert os.path.getmtime(rpth + "0001_simple_sigma_1.0/rgb_0.png") == before
    assert "psnr between" in capsys.readouterr().out


def test_pcrender_task_scores_against_its_mesh(scored, monkeypatch):
    import json

    from gpcr_tpu_torch.models.encoder import PCEncoder
    from gpcr_tpu_torch.render.checkpoint import save_params

    root, rpth, _, _ = scored
    _small_camera(monkeypatch)
    info = {"clr_encoder_channels": "9 8 8 8 8 8", "scale_factor": SF}
    run = os.path.join(root, "run")
    os.makedirs(os.path.join(run, "option"))
    os.makedirs(os.path.join(run, "checkpoint"))
    with open(os.path.join(run, "option", "options.json"), "w") as f:
        json.dump({"pcml_info": info}, f)
    ckpt = os.path.join(run, "checkpoint", "m.npz")
    save_params(ckpt, PCEncoder(info, generator=torch.Generator().manual_seed(0)))
    res = TB.main(_argv("pcrender", root, rpth, "--ckpt", ckpt))
    images, timing = res["0001"]
    assert images["normal"].shape == (1, 2, 32, 32, 3)
    s = timing["scores"]
    assert np.isfinite(s["psnr"]) and 0.0 <= s["msssim"] <= 1.0
    assert s["lpips"] is None
    assert os.path.exists(rpth + "0001_pcrender/normal_w_1.png")
    again = TB.main(_argv("pcrender", root, rpth, "--ckpt", ckpt,
                          "--metric_only"))
    assert again["0001"][1]["scores"] == s


def _cam_args(mode, *more):
    return TB.build_parser().parse_args(["cam", "--cam_mode", mode, *more])


@pytest.mark.parametrize("mode,shape", [
    ("circle", (1, 12, 4, 4)), ("udlrfb", (1, 6, 4, 4)),
    ("plot1", (1, 300, 4, 4))])
def test_cam_task_files_are_read_by_both_packages(tmp_path, mode, shape):
    t_path, j_path = str(tmp_path / "t" / "cam.npz"), str(tmp_path / "j.npz")
    t_idx = str(tmp_path / "t_idx.npy")
    saved = TB.main(["cam", "--cam_mode", mode, "--cam_save_path", t_path,
                     "--num_frames", "8", "--use_t_indices", "--t_idx_pth",
                     t_idx, "--device", "cpu"])
    JB.main(["cam", "--cam_mode", mode, "--cam_save_path", j_path])
    np.testing.assert_array_equal(np.load(t_idx), [0, 0, 1, 2, 2, 2])
    wh = 1024 if mode == "plot1" else 512
    # each package reads the file the other saved
    for path in (t_path, j_path):
        jcam, tcam = JCamera.load(path), Camera.load(path)
        assert saved.H_c2w.shape == tcam.H_c2w.shape == shape
        assert (tcam.width_px, tcam.height_px) == (wh, wh)
        assert (jcam.width_px, jcam.height_px) == (wh, wh)
        np.testing.assert_array_equal(tcam.H_c2w.numpy(),
                                      np.asarray(jcam.H_c2w))
    a, b = Camera.load(t_path), Camera.load(j_path)
    np.testing.assert_allclose(a.H_c2w.numpy(), b.H_c2w.numpy(), atol=1e-5)
    np.testing.assert_allclose(a.intrinsic.numpy(), b.intrinsic.numpy(),
                               rtol=1e-6)


@pytest.mark.parametrize("suffix", [".npz", ".json", ".pt"])
def test_camera_file_mode_matches_jax(tmp_path, suffix):
    """``--cam_json <file>``: a saved 5-view path resampled to 12 views,
    as ``_camera_for`` asks for it; the JAX package reads the same file."""
    cam = TRD.generate_cam({**CAM_INFO, "n_imgs": 5})
    path = str(tmp_path / ("cam" + suffix))
    if suffix == ".pt":
        torch.save({"H_c2w": cam.H_c2w, "intrinsic": cam.intrinsic,
                    "width_px": 32, "height_px": 32}, path)
    else:
        cam.save(path)
    back = Camera.load(path)
    np.testing.assert_array_equal(back.H_c2w.numpy(), cam.H_c2w.numpy())
    assert Camera.from_state_dict(cam.state_dict()).width_px == 32
    ref = JTraj(mode=path, n_imgs=12, total=None).get_camera(45, 512, 512)
    got = CameraTrajectory(mode=path, n_imgs=12, total=None).get_camera(
        45, 512, 512)
    assert got.H_c2w.shape == (1, 12, 4, 4)
    np.testing.assert_allclose(got.H_c2w.numpy(), np.asarray(ref.H_c2w),
                               atol=1e-5)
    for task, wh in (("simple", 512), ("pcrender", 1024)):
        c, info = TB._camera_for(_cam_args("file", "--cam_json", path), task,
                                 torch.device("cpu"))
        assert (c.width_px, info["n_imgs"], c.H_c2w.shape[1]) == (wh, 12, 12)
        np.testing.assert_array_equal(c.H_c2w.numpy(), got.H_c2w.numpy())
    assert Camera.cat([cam, cam], dim=1).H_c2w.shape == (1, 10, 4, 4)
    one = Camera.load(path)[0]
    one = Camera(one.H_c2w[:, :1], one.intrinsic[:, :1], 32, 32)
    assert one.uniformly_sample(4).H_c2w.shape == (1, 4, 4, 4)


def test_estimate_normals_matches_jax():
    rng = np.random.RandomState(0)
    v = rng.randn(500, 3)
    xyz = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    ref = JPointCloud.from_numpy(xyz).estimate_normals(k=12)
    got = PointCloud.from_numpy(xyz).estimate_normals(k=12)
    assert got.normal_w.shape == (1, 500, 3)
    np.testing.assert_allclose(got.normal_w.numpy(), np.asarray(ref.normal_w),
                               atol=1e-6)
    # on a sphere the outward normal is the position
    assert float((got.normal_w[0] * torch.from_numpy(xyz)).sum(-1).min()) > 0.9
