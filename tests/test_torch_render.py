"""Port parity for the whole slice: ``PCMLRender`` and ``SimpleRender`` of
``gpcr_tpu_torch`` against ``gpcr_tpu`` (whose renderer takes its exact
XLA rasterizer path on the CPU), the golden frames, and the CLI.

Tolerances: PCMLRender outputs at atol 1e-4 (the U-Net's f32 matmul
sums run in another order); SimpleRender at atol 1e-5 (the
tests/test_stream.py bar); golden views >= 50 dB PSNR on uint8
(tests/test_golden.py's bar).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gpcr_tpu.io.image import read_png, to_uint8
from gpcr_tpu.io.ply import write_ply
from gpcr_tpu.render import renderer as JRD
from gpcr_tpu.structures.pointcloud import PointCloud as JPointCloud
from gpcr_tpu.structures.trajectory import CameraTrajectory as JTraj
from gpcr_tpu_torch.cli import benchmark as TB
from gpcr_tpu_torch.render import renderer as TRD
from gpcr_tpu_torch.structures.camera import Camera
from gpcr_tpu_torch.structures.pointcloud import PointCloud

TRD.pin_fp32()  # parity precision: full-float32 matmuls, no TF32 on a card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
OUTPUTS = ("rgb", "xyz_w", "hitmap", "normal")


def synthetic_cloud(n=600, seed=0, grid=128):
    """Random sphere surface on a PCGC grid (tests/test_renderer.py)."""
    rng = np.random.RandomState(seed)
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = np.round(v * 0.8 * (grid // 2) + 512).astype(np.float32)
    rgb = (v * 0.5 + 0.5).astype(np.float32)
    return xyz, rgb, grid // 2


def cameras(n_imgs, wh, fov=60.0):
    """The same circle poses for both packages (built once by JAX)."""
    traj = JTraj(mode="circle", n_imgs=n_imgs, total=1,
                 params={"d": 0, "r": 3, "center_angles": [90, 0]})
    jcam = traj.get_camera(fov=fov, width_px=wh, height_px=wh)
    tcam = Camera(H_c2w=torch.from_numpy(np.array(jcam.H_c2w)),
                  intrinsic=torch.from_numpy(np.array(jcam.intrinsic)),
                  width_px=wh, height_px=wh)
    return jcam, tcam


def test_pcml_render_matches_jax():
    xyz, rgb, sf = synthetic_cloud(n=400)
    info = {
        "clr_encoder_channels": "9 8 8 8 8 8",
        "sh_deg": 1, "sh_feat_deg": 0,
        "use_rotation": True, "use_scale": True, "use_offset": True,
        "use_dc_offset": False, "use_opacity": False, "est_normal": True,
        "normalize_normal": True, "enable_opacity": True,
        "scale_factor": sf, "model_type": "unet",
    }
    jcam, tcam = cameras(1, 48)
    jr = JRD.PCMLRender(info=info, voxelized=True, scale_factor=sf)
    ref = jr.render(JPointCloud.from_numpy(xyz, rgb), scale=None, cam=jcam,
                    fov=60.0, background_color=0.0)
    tr = TRD.PCMLRender(info=info, voxelized=True, scale_factor=sf,
                        params=jax.tree_util.tree_map(np.asarray, jr.params))
    timing = {}
    got = tr.render(PointCloud.from_numpy(xyz, rgb), scale=None, cam=tcam,
                    fov=60.0, background_color=0.0, timing=timing)
    for k in OUTPUTS:
        assert got[k].shape == (1, 1, 48, 48, 3), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)
    assert got["hitmap"].max() > 0.5
    assert timing["dup_overflow"] == 0 and timing["rgb_time"] > 0


def test_simple_render_matches_jax():
    xyz, rgb, sf = synthetic_cloud(n=600)
    jcam, tcam = cameras(2, 64)
    ref = JRD.SimpleRender(voxelized=True, scale_factor=sf).render(
        JPointCloud.from_numpy(xyz, rgb), scale=None, cam=jcam, fov=60.0,
        background_color=0.3, sigma=1.0)
    got = TRD.SimpleRender(voxelized=True, scale_factor=sf).render(
        PointCloud.from_numpy(xyz, rgb), scale=None, cam=tcam, fov=60.0,
        background_color=0.3, sigma=1.0)
    for k in ("rgb", "xyz_w", "hitmap"):
        assert got[k].shape == (1, 2, 64, 64, 3), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    assert got["normal"] is None and ref["normal"] is None


def test_simple_path_reproduces_golden_frames():
    """Views 0 and 6 of the golden trajectory through the CLI's raster
    config; chip_smoke.py checks all 12 through the CUDA kernel."""
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        m = json.load(f)
    args = TB.build_parser().parse_args(["simple", "--skip_mesh", "--voxelized"])
    cam, cam_info = TB._camera_for(args, "simple", torch.device("cpu"))
    views = [0, 6]
    cam = Camera(H_c2w=cam.H_c2w[:, views], intrinsic=cam.intrinsic[:, views],
                 width_px=cam.width_px, height_px=cam.height_px)
    pcd = PointCloud.from_ply(os.path.join(GOLDEN, "pcd_0.ply"))
    rdr = TRD.SimpleRender(voxelized=True, scale_factor=m["scale_factor"],
                           config=TB._raster_config(args))
    out = rdr.render(pcd, scale=None, cam=cam, fov=m["fov"],
                     background_color=m["bg"], sigma=m["sigma"])
    rgb = out["rgb"][0].numpy()
    for j, i in enumerate(views):
        got = to_uint8(rgb[j]).astype(np.float64)
        ref = read_png(os.path.join(GOLDEN, f"rgb_{i}.png")).astype(np.float64)
        mse = np.mean((got - ref) ** 2)
        psnr = 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        assert psnr >= 50.0, (i, psnr)


_CLI_SCRIPT = """
import sys
from gpcr_tpu_torch.cli import benchmark as B
root = sys.argv[1]
common = ["--id_list", "scene", "--dataset_root", root + "/ds",
          "--rpth", root + "/out/", "--skip_mesh", "--voxelized",
          "--scale_factor", "64", "--dup_cap", "256", "--device", "cpu"]
simple = B.main(["simple"] + common)
pcr = B.main(["pcrender", "--ckpt", root + "/run/checkpoint/m.pth"] + common)
for res in (simple, pcr):
    out, timing = res["scene"]
    assert out["rgb"].shape == (1, 12, 512, 512, 3), out["rgb"].shape
    assert timing["dup_overflow"] == 0
print("JAX_LOADED", "jax" in sys.modules)
"""


def test_cli_runs_without_jax(tmp_path):
    """Both CLI tasks on a tiny cloud in a fresh process, the learned one
    from a reference-style .pth: the port and the shared gpcr_tpu.io
    modules it uses (ply, image) never import jax."""
    xyz, rgb, _ = synthetic_cloud(n=300, grid=128)
    (tmp_path / "ds" / "scene").mkdir(parents=True)
    write_ply(str(tmp_path / "ds" / "scene" / "pcd_0.ply"), xyz, rgb)
    (tmp_path / "run" / "option").mkdir(parents=True)
    (tmp_path / "run" / "checkpoint").mkdir()
    info = {"clr_encoder_channels": "9 8 8 8 8 8", "scale_factor": 64}
    with open(tmp_path / "run" / "option" / "options.json", "w") as f:
        json.dump({"pcml_info": info}, f)
    from gpcr_tpu_torch.models.encoder import PCEncoder

    torch.save(PCEncoder(info, generator=torch.Generator().manual_seed(0))
               .state_dict(), str(tmp_path / "run" / "checkpoint" / "m.pth"))
    r = subprocess.run(
        [sys.executable, "-c", _CLI_SCRIPT, str(tmp_path)],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "JAX_LOADED False" in r.stdout, r.stdout[-2000:]
    assert "model time:" in r.stdout
    for tag, n in (("scene_simple_sigma_1.0", 12), ("scene_pcrender", 12)):
        files = os.listdir(tmp_path / "out" / tag)
        assert sum(f.startswith("rgb_") for f in files) == n, (tag, files)


def test_profile_script_follows_the_renderer():
    """The stage profile renders what PCMLRender renders (same weights,
    cloud, cameras and raster config), so its stage times are the
    renderer's path cut at stage boundaries."""
    from gpcr_tpu_torch.cli import profile_pcrender as P

    argv = ["--n_points", "1000", "--channels", "9 8 8 8 8 8", "--views",
            "1", "--res", "32", "--reps", "1", "--top", "3",
            "--device", "cpu"]
    stages, lines, images = P.main(argv)
    assert set(stages) == {
        "encode.quantize", "encode.build_plan", "encode.unet+head",
        "view.features+preprocess", "view.binning", "view.order",
        "view.blend_kernel", "view.epilogue"}
    assert [d["pass"] for d in lines] == ["encode", "rgb"]
    args = P.build_parser().parse_args(argv)
    info = dict(P.LEARNED_INFO, clr_encoder_channels=args.channels)
    rdr = TRD.PCMLRender(info=info, voxelized=True, scale_factor=448,
                         config=TB._raster_config(TB.build_parser().parse_args(
                             ["pcrender", "--dup_cap", "256"])))
    xyz, rgb = P.synthetic_cloud(1000)
    cam = TRD.generate_cam({"fov": 45, "width_px": 32, "height_px": 32,
                            "mode": "circle", "n_imgs": 1, "d": 0, "r": 3,
                            "center_angles": [90, 0]})
    ref = rdr.render(PointCloud.from_numpy(xyz, rgb), scale=None, cam=cam,
                     fov=45, background_color=1.0)
    assert float((ref["rgb"] - 1.0).abs().max()) > 1e-3  # the cloud is seen
    for j, k in enumerate(OUTPUTS):
        got = images[:, 3 * j:3 * j + 3].permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), ref[k][0].numpy(), atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["options.yaml", "options.json"])
def test_load_pcml_reads_run_options(tmp_path, name):
    """A reference run's options.yaml (as gpcr_tpu.load_pcml reads it) and
    a port-written options.json give the same info and params."""
    import yaml

    from gpcr_tpu_torch.models.encoder import PCEncoder
    from gpcr_tpu_torch.render.checkpoint import save_params

    info = {"clr_encoder_channels": "9 8 8 8 8 8", "scale_factor": 64}
    (tmp_path / "option").mkdir()
    (tmp_path / "checkpoint").mkdir()
    with open(tmp_path / "option" / name, "w") as f:
        if name.endswith(".yaml"):
            yaml.safe_dump({"pcml_info": info}, f)
        else:
            json.dump({"pcml_info": info}, f)
    model = PCEncoder(info, generator=torch.Generator().manual_seed(0))
    ckpt = str(tmp_path / "checkpoint" / "m.npz")
    save_params(ckpt, model)
    params, got = TRD.load_pcml(ckpt)
    assert got == info
    want = model.state_dict()
    np.testing.assert_array_equal(params["color_encoder"]["conv0"]["kernel"],
                                  want["color_encoder.conv0.kernel"].numpy())


def test_cli_refuses_what_is_not_ported(tmp_path):
    base = ["--rpth", str(tmp_path) + "/", "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="shard"):
        TB.main(["simple", "--shard", "views"] + base)
    with pytest.raises(NotImplementedError, match="shard"):
        TB.main(["cam", "--shard", "tiles"] + base)
    with pytest.raises(NotImplementedError, match="down_sample_ratio"):
        TB.main(["simple", "--down_sample_ratio", "0.5"] + base)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TB.main(["simple", "--skip_mesh", "--rpth", str(tmp_path) + "/"])


def test_render_views_fused_aligned_route_matches_jax(monkeypatch):
    """``render_views_fused(use_pallas=True)``: 2 views of 32 px, x2
    supersampled, analytic splats; the JAX side runs its Pallas kernel in
    interpret mode (atol 2e-4 / rtol 1e-3, the tests/test_pallas.py bar).
    The route renders at 64 px and halves the image afterwards, and it
    reports no dropped entries even where the stream route counts some."""
    import functools

    import jax.numpy as jnp

    import gpcr_tpu.render as JRender
    from gpcr_tpu.ops import rasterize as JR
    from gpcr_tpu.ops.rasterize_pallas import rasterize_gaussians_pallas
    from gpcr_tpu.utils import sh as jsh
    from gpcr_tpu_torch.ops import rasterize as TR
    from gpcr_tpu_torch.ops import rasterize_aligned as TRA
    from gpcr_tpu_torch.utils import sh as tsh

    monkeypatch.setattr(
        JRender, "_get_pallas_raster",
        lambda: functools.partial(rasterize_gaussians_pallas, interpret=True))
    xyz, rgb, sf = synthetic_cloud(n=300)
    n = len(xyz)
    jcam, tcam = cameras(2, 32)
    jrp = JRD.get_rasterize_param_from_camera(jcam, 60.0, sh_degree=1)
    trp = TRD.get_rasterize_param_from_camera(tcam, 60.0, sh_degree=1)
    means = ((xyz - 512) / sf).astype(np.float32)
    scales = np.full((n, 3), 4.0 / sf, np.float32)  # wide: multi-tile rects
    rots = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    opacity = np.ones(n, np.float32)
    cfg = dict(max_dup_per_gaussian=2, chunk_size=32)
    common = dict(height=64, width=64, out_h=32, out_w=32, sh_degree=1,
                  with_normal=False, use_pallas=True)

    jshs = jnp.concatenate([jsh.RGB2SH(jnp.asarray(rgb))[:, None, :],
                            jnp.zeros((n, 12, 3))], axis=1)
    ref = JRD.render_views_fused(
        jrp["view_t"], jrp["full_t"], jrp["campos"], jnp.asarray(means),
        jnp.asarray(scales), jnp.asarray(rots), jnp.asarray(opacity), jshs,
        jnp.zeros((n, 3)), jnp.ones(n, bool), jnp.zeros(3), jrp["tanfov"],
        config=JR.RasterizeConfig(**cfg), **common)

    t = torch.from_numpy
    tshs = torch.cat([tsh.RGB2SH(t(rgb))[:, None, :], torch.zeros(n, 12, 3)], 1)
    targs = (trp["view_t"], trp["full_t"], trp["campos"], t(means), t(scales),
             t(rots), t(opacity), tshs, torch.zeros(n, 3),
             torch.ones(n, dtype=torch.bool), torch.zeros(3), trp["tanfov"])
    before = TRA.LAUNCHES
    got = TRD.render_views_fused(*targs, config=TR.RasterizeConfig(**cfg),
                                 **common)
    assert TRA.LAUNCHES == before  # CPU tensors take the plain version
    for k in ("rgb", "xyz_w", "hitmap"):
        assert got[k].shape == (2, 32, 32, 3), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-4, rtol=1e-3, err_msg=k)
    assert got["normal"] is None and float(got["hitmap"].max()) > 0.5
    # overflow is dropped on this route (as in JAX) and counted on the other
    assert int(got["dup_overflow"].sum()) == int(ref["dup_overflow"].sum()) == 0
    stream = TRD.render_views_fused(
        *targs, config=TR.RasterizeConfig(**cfg),
        **dict(common, use_pallas=False))
    assert int(stream["dup_overflow"].sum()) > 0
    np.testing.assert_allclose(got["rgb"].numpy(), stream["rgb"].numpy(),
                               atol=1e-5)
