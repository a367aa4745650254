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

from torch_streams import preprocess_scene

# one intra-op thread: under xdist each worker would start torch's pool
# of a thread per CPU, and the oversubscribed pools slowed a 16 px train
# step from 0.15 s to 95 s (6 workers on 8 CPUs)
torch.set_num_threads(1)
TRD.pin_fp32()  # parity precision: full-float32 matmuls, no TF32 on a card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
OUTPUTS = ("rgb", "xyz_w", "hitmap", "normal")
CAM16 = {"fov": 60, "width_px": 16, "height_px": 16, "mode": "circle",
         "n_imgs": 1, "d": 0, "r": 3, "center_angles": [90, 0]}
# the CLI camera of tests/test_torch_cli_benchmark.py: 2 views of 32 px
# (the CLI's own 12 views of 512² x2 are held on the card by chip_smoke.py)
CAM32 = {"fov": 60, "width_px": 32, "height_px": 32, "mode": "circle",
         "n_imgs": 2, "d": 0, "r": 3, "center_angles": [90, 0]}


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
                        params=jax.tree_util.tree_map(np.asarray, jr.params),
                        device="cpu")
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


@pytest.mark.parametrize("kind", ["simple", "pcml"])
def test_batch_of_clouds_renders_each_cloud_alone(kind):
    """A batch of two clouds, each with its own ring of 2 views of 32 px,
    renders every output of each cloud bit for bit as that cloud renders
    alone, and a batch writes nothing into ``timing``."""
    clouds = [synthetic_cloud(n=300, seed=s) for s in (0, 1)]
    cams = [TRD.generate_cam(dict(CAM32, center_angles=[90, a]))
            for a in (0, 40)]
    if kind == "simple":
        rdr = TRD.SimpleRender(voxelized=True, scale_factor=clouds[0][2])
    else:
        rdr = TRD.PCMLRender(
            info={"clr_encoder_channels": "9 8 8 8 8 8",
                  "scale_factor": clouds[0][2]},
            voxelized=True, device="cpu")
    alone = [rdr.render(PointCloud.from_numpy(xyz, rgb), None, cam, 60.0,
                        background_color=1.0)
             for (xyz, rgb, _), cam in zip(clouds, cams)]
    timing = {}
    both = rdr.render(
        PointCloud.from_numpy(np.stack([c[0] for c in clouds]),
                              np.stack([c[1] for c in clouds])),
        None, Camera.cat(cams, 0), 60.0, background_color=1.0, timing=timing)
    assert timing == {}
    assert sorted(both) == sorted(alone[0])
    for k in OUTPUTS:
        if kind == "simple" and k == "normal":
            assert both[k] is None
            continue
        assert both[k].shape == (2, 2, 32, 32, 3), k
        assert float(both[k][:, :, :, :, 0].std()) > 0, k  # clouds are seen
        for ib in range(2):
            assert torch.equal(both[k][ib], alone[ib][k][0]), (k, ib)


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
import json, sys
import torch
from gpcr_tpu_torch.cli import benchmark as B
from gpcr_tpu_torch.render.renderer import generate_cam
root, cam_info = sys.argv[1], json.loads(sys.argv[2])
torch.set_num_threads(1)
# the CLI's 12 views of 512² x2 are held on the card by chip_smoke.py
B._camera_for = lambda args, task, device: (
    generate_cam(cam_info, device=device), cam_info)
common = ["--id_list", "scene", "--dataset_root", root + "/ds",
          "--rpth", root + "/out/", "--skip_mesh", "--voxelized",
          "--scale_factor", "64", "--dup_cap", "256", "--device", "cpu"]
simple = B.main(["simple"] + common)
pcr = B.main(["pcrender", "--ckpt", root + "/run/checkpoint/m.pth"] + common)
for res in (simple, pcr):
    out, timing = res["scene"]
    assert out["rgb"].shape == (1, 2, 32, 32, 3), out["rgb"].shape
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
        [sys.executable, "-c", _CLI_SCRIPT, str(tmp_path), json.dumps(CAM32)],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "JAX_LOADED False" in r.stdout, r.stdout[-2000:]
    assert "model time:" in r.stdout
    for tag, n in (("scene_simple_sigma_1.0", 2), ("scene_pcrender", 2)):
        files = os.listdir(tmp_path / "out" / tag)
        assert sum(f.startswith("rgb_") for f in files) == n, (tag, files)


def test_profile_script_follows_the_renderer():
    """The span profile renders what PCMLRender renders (same weights,
    cloud, cameras and raster config) by calling it, and reads its times
    from the renderer's own spans."""
    from gpcr_tpu_torch.cli import profile_pcrender as P

    argv = ["--n_points", "1000", "--channels", "9 8 8 8 8 8", "--views",
            "1", "--res", "32", "--reps", "1", "--top", "3",
            "--device", "cpu"]
    init, rec, table, out = P.main(argv)
    assert [s.name for s in init.spans] == ["gpcr.init"]
    assert set(table["spans"]) == {
        "gpcr.render", "gpcr.encode", "gpcr.encode.quantize",
        "gpcr.encode.plan", "gpcr.encode.unet", "gpcr.encode.head",
        "gpcr.splats", "gpcr.raster.view", "gpcr.raster.features",
        "gpcr.raster.preprocess",
        "gpcr.raster.bin", "gpcr.raster.order", "gpcr.raster.blend",
        "gpcr.raster.epilogue", "gpcr.raster.resize", "gpcr.finish"}
    assert rec.requests == 1 and rec.counters[0]["plan_hits"] == 2
    args = P.build_parser().parse_args(argv)
    info = dict(P.LEARNED_INFO, clr_encoder_channels=args.channels)
    rdr = TRD.PCMLRender(info=info, voxelized=True, scale_factor=448,
                         config=TB._raster_config(TB.build_parser().parse_args(
                             ["pcrender", "--dup_cap", "256"])),
                         device="cpu")
    xyz, rgb = P.synthetic_cloud(1000)
    cam = TRD.generate_cam({"fov": 45, "width_px": 32, "height_px": 32,
                            "mode": "circle", "n_imgs": 1, "d": 0, "r": 3,
                            "center_angles": [90, 0]})
    ref = rdr.render(PointCloud.from_numpy(xyz, rgb), scale=None, cam=cam,
                     fov=45, background_color=1.0)
    assert float((ref["rgb"] - 1.0).abs().max()) > 1e-3  # the cloud is seen
    for k in OUTPUTS:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=1e-6,
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


def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    base = ["--rpth", str(tmp_path) + "/", "--device", "cpu"]
    monkeypatch.setattr(TB, "_camera_for", lambda args, task, device: (
        TRD.generate_cam(CAM32, device=device), CAM32))
    # --shard is ported: in a one-rank gloo group, 'views' gives the
    # unsharded CLI run's images and PNGs byte for byte, and 'tiles'
    # (rendered at full size and halved afterwards, as gpcr_tpu does) the
    # same images within 1e-5 and PNGs within one uint8 level
    xyz, rgb, sf = synthetic_cloud(n=300, seed=4)
    os.makedirs(tmp_path / "sh" / "a")
    write_ply(str(tmp_path / "sh" / "a" / "pcd_0.ply"), xyz, rgb,
              np.zeros_like(xyz))

    def cli(shard):
        rpth = str(tmp_path / f"out_{shard}") + "/"
        out, _ = TB.main(["simple", "--skip_mesh", "--id_list", "a",
                          "--dataset_root", str(tmp_path / "sh"),
                          "--voxelized", "--scale_factor", str(sf),
                          "--rpth", rpth, "--device", "cpu",
                          "--shard", shard])["a"]
        png = os.path.join(rpth, "a_simple_sigma_1.0")
        return out["rgb"], [read_png(os.path.join(png, f"rgb_{i}.png"))
                            for i in range(CAM32["n_imgs"])]

    ref, ref_png = cli("none")
    assert float((ref - 1.0).abs().max()) > 1e-2  # the cloud is seen
    # without a launcher or a group a sharded run refuses to start, and
    # does not quietly render on one rank
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    for shard in ("views", "tiles"):
        with pytest.raises(ValueError, match="torchrun"):
            cli(shard)
    import torch.distributed as dist

    from gpcr_tpu_torch.parallel import distributed

    assert distributed.initialize(
        init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
        rank=0, backend="gloo")
    try:
        views, views_png = cli("views")
        tiles, tiles_png = cli("tiles")
    finally:
        dist.destroy_process_group()
    assert torch.equal(views, ref)
    assert all(np.array_equal(a, b) for a, b in zip(views_png, ref_png))
    np.testing.assert_allclose(tiles.numpy(), ref.numpy(), atol=1e-5)
    assert all(np.abs(a.astype(int) - b).max() <= 1
               for a, b in zip(tiles_png, ref_png))
    # --down_sample_ratio is ported: any ratio other than 1.0 renders the
    # cloud voxel-downsampled with cells of width 2, as the JAX CLI does
    # (whose voxel_downsampling needs 64-bit keys: jax_enable_x64)
    xyz, rgb, sf = synthetic_cloud(n=500, seed=3)
    nrm = (xyz - 512.0) / np.linalg.norm(xyz - 512.0, axis=1, keepdims=True)
    os.makedirs(tmp_path / "ds" / "a")
    ply = str(tmp_path / "ds" / "a" / "pcd_0.ply")
    write_ply(ply, xyz, rgb, nrm)
    seen = []
    real = TB.SimpleRender.render
    monkeypatch.setattr(TB.SimpleRender, "render", lambda self, pcd, *a, **k:
                        seen.append(pcd) or real(self, pcd, *a, **k))
    monkeypatch.setattr(TB, "_camera_for", lambda args, task, device: (
        TRD.generate_cam(CAM16, device=device), CAM16))
    TB.main(["simple", "--down_sample_ratio", "0.5", "--skip_mesh",
             "--id_list", "a", "--dataset_root", str(tmp_path / "ds"),
             "--voxelized", "--scale_factor", str(sf)] + base)
    with jax.enable_x64(True):
        want = JPointCloud.from_ply(ply).voxel_downsampling(cell_width=2.0)
    got = seen[0]
    np.testing.assert_array_equal(got.valid_mask.numpy(),
                                  np.asarray(want.valid_mask))
    assert 0 < int(got.get_num_valid_points(0)) < len(xyz)
    for k, tol in (("xyz_w", 1e-6), ("rgb", 1e-5), ("normal_w", 1e-5)):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), atol=tol)
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


@pytest.mark.parametrize("requires_grad", [False, True])
@pytest.mark.parametrize("layout", ["learned", "analytic"])
def test_preprocess_view_on_the_cpu_takes_the_plain_ops(monkeypatch, layout,
                                                       requires_grad):
    """``ops/preprocess.py::preprocess_view``'s dispatch for CPU tensors,
    with and without an input that requires a gradient: no kernel call,
    and every field as ``fuse_view_features`` then ``preprocess`` give it
    (gradients recorded when asked)."""
    from gpcr_tpu_torch.ops import preprocess as TP
    from gpcr_tpu_torch.ops import rasterize as TR

    (settings, means, scales, rots, op, shs, normal, valid, config,
     with_normal) = preprocess_scene(layout, 1, "cpu", n=600)
    means.requires_grad_(requires_grad)

    def refused(*a, **kw):
        raise AssertionError("the kernel path was taken on the CPU")

    monkeypatch.setattr(TP, "_preprocess_view_cuda", refused)
    before = TP.LAUNCHES_PREP
    got = TP.preprocess_view(settings, means, scales, rots, op, shs, normal,
                             valid, config, with_normal)
    assert TP.LAUNCHES_PREP == before
    feats = TP.fuse_view_features(settings.campos, means, shs, normal, 1,
                                  with_normal)
    ref = TR.preprocess(means, op, settings, config, scales=scales,
                        rotations=rots, colors_precomp=feats,
                        valid_mask=valid)
    assert got.features.shape == (600, 12 if with_normal else 9)
    for name, g, r in zip(got._fields, got, ref):
        assert torch.equal(g, r), name
    assert got.features.requires_grad == requires_grad
    assert got.mean2d.requires_grad == requires_grad
