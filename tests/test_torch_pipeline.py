"""The port's data-preparation and evaluation tools against ``gpcr_tpu``:
``utils/preprocess_obj.py``, ``utils/media.py``, ``cli/rescale_ply.py``,
``cli/pipeline.py`` and ``cli/sample_pcd.py``, on the same files.

Output files are compared byte for byte where both packages write the
same bytes (PNGs, PLYs, OBJ / MTL text); scores at 1e-5 (the same PNGs,
float32 sums in another order; ``uniform_camera`` is held in
tests/test_torch_mesh_rgbd.py). ``save_difference_map`` is held at batch 1: at batch b > 1 both
write every batch element of a view to the same file (the reference's
behaviour, kept).
"""

import os
import sys

import numpy as np
import pytest
import torch

from gpcr_tpu.cli import pipeline as JPL
from gpcr_tpu.cli import rescale_ply as JRP
from gpcr_tpu.cli import sample_pcd as JSP
from gpcr_tpu.utils import media as JMD
from gpcr_tpu.utils import preprocess_obj as JPO
from gpcr_tpu_torch.cli import pipeline as TPL
from gpcr_tpu_torch.cli import rescale_ply as TRP
from gpcr_tpu_torch.cli import sample_pcd as TSP
from gpcr_tpu_torch.io import read_png, read_ply, write_ply, write_png
from gpcr_tpu_torch.utils import media as TMD
from gpcr_tpu_torch.utils import preprocess_obj as TPO

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(r, f), root)
                  for r, _, fs in os.walk(root) for f in fs)


def _same_files(a, b):
    assert _tree(a) == _tree(b)
    for rel in _tree(a):
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            assert fa.read() == fb.read(), rel


def _asset(d, name="0001"):
    """<d>/<name>/<name>.obj: a textured material, a plain-Kd one and a
    duplicated face (corners in another order)."""
    a = os.path.join(d, name)
    os.makedirs(a, exist_ok=True)
    tex = (np.random.RandomState(4).rand(8, 8, 3) * 255).astype(np.uint8)
    write_png(os.path.join(a, "tex.png"), tex)
    with open(os.path.join(a, "mat.mtl"), "w") as f:
        f.write("newmtl tex\nKd 1 1 1\nmap_Kd ./tex.png\n\n"
                "newmtl red\nKd 0.8 0.1 0.2\n")
    with open(os.path.join(a, f"{name}.obj"), "w") as f:
        f.write("# tiny asset\nmtllib mat.mtl\n"
                "v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nv 0 0 1\n"
                "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n\nusemtl tex\n"
                "f 1/1 2/2 3/3\nf 1/1 3/3 4/4\nf 2/2 3/3 1/1\n"
                "usemtl red\nf 1/1 2/2 5/3\nf 2/2 3/3 5/3\n"
                "f 3/3 4/4 5/3\nf 4/4 1/1 5/3\n")
    return os.path.join(a, f"{name}.obj")


def test_preprocess_obj_matches_jax(tmp_path):
    obj = _asset(str(tmp_path / "src"))
    t = TPO.preprocess_obj(obj, str(tmp_path / "t"))
    j = JPO.preprocess_obj(obj, str(tmp_path / "j"))
    assert os.path.basename(t) == os.path.basename(j) == "0001.obj"
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    text = (tmp_path / "t" / "0001.obj").read_text()
    assert text.count("\nf ") == 6  # the duplicate face is gone
    assert "map_Kd kd_red.png" in (tmp_path / "t" / "mat.mtl").read_text()
    np.testing.assert_array_equal(read_png(str(tmp_path / "t" / "kd_red.png")),
                                  np.tile([[[204, 25, 51]]], (2, 2, 1)))


def test_media_matches_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    imgs = [rng.rand(20, 30, 3).astype(np.float32) for _ in range(5)]
    imgs.append((rng.rand(20, 30) * 255).astype(np.uint8))
    for kw in ({}, {"n_cols": 4, "pad": 3, "pad_value": 9}):
        np.testing.assert_array_equal(TMD.tile_images(imgs, **kw),
                                      JMD.tile_images(imgs, **kw))
    for title in ("VIEW 0: PSNR 28.3 dB", "abc-xyz_/09?", ""):
        np.testing.assert_array_equal(
            TMD.add_title_to_image(imgs[0], title),
            JMD.add_title_to_image(imgs[0], title))
    np.testing.assert_array_equal(
        TMD.add_title_to_image(imgs[5], "X", 12, (1, 2, 3), (9, 9, 9)),
        JMD.add_title_to_image(imgs[5], "X", 12, (1, 2, 3), (9, 9, 9)))
    x = np.linspace(0, 1, 101, dtype=np.float32)
    np.testing.assert_array_equal(TMD.srgb_to_linear(x), JMD.srgb_to_linear(x))
    np.testing.assert_array_equal(TMD.linear_to_srgb(x), JMD.linear_to_srgb(x))

    # frames of few colours, which a gif's palette keeps exactly
    frames = [np.kron(rng.randint(0, 4, (4, 6, 3)) * 60, np.ones((5, 5, 1)))
              .astype(np.uint8) for _ in range(3)]
    t, j = str(tmp_path / "t" / "a.gif"), str(tmp_path / "j" / "a.gif")
    TMD.create_gif(frames, t, fps=5)
    JMD.create_gif(frames, j, fps=5)
    back = TMD.gif_to_nparray(t)
    np.testing.assert_array_equal(back, JMD.gif_to_nparray(j))
    assert back.shape[0] == 3 and back.shape[1:3] == (20, 30)
    np.testing.assert_array_equal(back[..., :3], np.stack(frames))
    TMD.create_video(frames, str(tmp_path / "t" / "a.mp4"), fps=5)
    assert os.path.getsize(tmp_path / "t" / "a.mp4") > 0

    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imageio"):
        TMD.create_gif(frames, str(tmp_path / "b.gif"))
    with pytest.raises(ImportError, match="imageio"):
        TMD.create_video(frames, str(tmp_path / "b.mp4"))


def _cloud(path, n=300, seed=0):
    rng = np.random.RandomState(seed)
    xyz = np.round(rng.rand(n, 3) * 400 + 300).astype(np.float32)
    rgb = rng.randint(0, 256, (n, 3)).astype(np.float32) / 255.0
    nrm = rng.randn(n, 3).astype(np.float32)
    write_ply(path, xyz, rgb, nrm)
    return xyz


def test_rescale_ply_and_pipeline_steps_match_jax(tmp_path):
    src = str(tmp_path / "vox.ply")
    xyz = _cloud(src)
    p = {k: str(tmp_path / f"{k}.ply") for k in
         ("t_w", "j_w", "t_v", "j_v", "t_r", "j_r", "t_s", "j_s")}
    TRP.main([src, p["t_w"], "--factor", "448", "--offset", "512"])
    JRP.main([src, p["j_w"], "--factor", "448", "--offset", "512"])
    TRP.main([p["t_w"], p["t_v"], "--factor", "448", "--offset", "512",
              "--inverse"])
    JRP.main([p["j_w"], p["j_v"], "--factor", "448", "--offset", "512",
              "--inverse"])
    TPL.rescale_run(src, p["t_r"], 448, input_offset=7.0, show=True)
    JPL.rescale_run(src, p["j_r"], 448, input_offset=7.0)
    TPL.scale_run(p["t_r"], p["t_s"], 448)
    JPL.scale_run(p["j_r"], p["j_s"], 448)
    for k in ("w", "v", "r", "s"):
        with open(p["t_" + k], "rb") as a, open(p["j_" + k], "rb") as b:
            assert a.read() == b.read(), k
    # input_offset is ignored (the reference's behaviour): the world cloud
    # is (xyz - 512) / 448, and scaling back lands within float32 rounding
    w = read_ply(p["t_r"])
    np.testing.assert_allclose(w["xyz"], (xyz - 512.0) / 448.0, rtol=1e-6)
    back = read_ply(p["t_s"])
    np.testing.assert_allclose(back["xyz"] + 512.0, xyz, atol=1e-3)
    np.testing.assert_array_equal(back["rgb"], read_ply(src)["rgb"])


def test_pipeline_scores_and_difference_maps_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    gt = rng.rand(1, 3, 40, 40, 3).astype(np.float32)
    rgb = np.clip(gt + rng.randn(*gt.shape).astype(np.float32) * 0.05, 0, 1)
    dirs = {}
    for name, img in (("render", rgb), ("gt", gt)):
        dirs[name] = str(tmp_path / name)
        os.makedirs(dirs[name])
        for iq in range(3):
            write_png(os.path.join(dirs[name], f"rgb_{iq}.png"),
                      (img[0, iq] * 255).astype(np.uint8))
    got = TPL.evaluate_pair(dirs["render"], dirs["gt"], device="cpu")
    want = JPL.evaluate_pair(dirs["render"], dirs["gt"])
    assert sorted(got) == sorted(want) == ["lpips", "ms_ssim", "psnr"]
    assert got["lpips"] is None and want["lpips"] is None  # no weights
    for k in ("psnr", "ms_ssim"):
        assert abs(got[k] - want[k]) <= 1e-5, k
    assert got["psnr"] == TPL.psnr_run(dirs["render"], dirs["gt"],
                                       device="cpu")
    assert got["ms_ssim"] == TPL.msssim_run(dirs["render"], dirs["gt"],
                                            device="cpu")
    assert TPL.lpips_run(dirs["render"], dirs["gt"], device="cpu") is None

    TPL.save_difference_map(gt, torch.from_numpy(rgb), str(tmp_path / "t"))
    JPL.save_difference_map(gt, rgb, str(tmp_path / "j"))
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"))
    assert _tree(str(tmp_path / "t")) == [f"diff/rgb_{i}.png" for i in range(3)]


@pytest.mark.parametrize("method,workers", [("uniform_quantized", 2),
                                            ("poisson_disk", 1)])
def test_sample_pcd_main_matches_jax(tmp_path, method, workers):
    roots = {}
    for side in ("t", "j"):
        roots[side] = str(tmp_path / side)
        _asset(roots[side], "0001")
        _asset(roots[side], "0002")
        os.makedirs(os.path.join(roots[side], "no_obj"))
    ids = [] if workers > 1 else ["--id_list", "0002"]
    common = ["--num_points", "120", "--method", method,
              "--workers", str(workers), *ids]
    out = TSP.main(["--dataset_root", roots["t"], "--device", "cpu", *common])
    JSP.main(["--dataset_root", roots["j"], *common])
    names = ["0001", "0002"] if workers > 1 else ["0002"]
    assert out == [os.path.join(roots["t"], n, "pcd_0.ply") for n in names]
    for n in names:
        a = os.path.join(roots["t"], n, "pcd_0.ply")
        b = os.path.join(roots["j"], n, "pcd_0.ply")
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), n
