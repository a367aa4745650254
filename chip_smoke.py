#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``gpcr_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing what it found:

1. device: torch / CUDA versions, the card's name and power limit;
2. build: compiles ``gpcr_tpu_torch/csrc/stream_blend.cu`` with nvcc for
   sm_90a into ``gpcr_tpu_torch/build/`` and prints ptxas' registers,
   shared memory and spills;
3. kernel vs plain: the CUDA blend kernel against its plain PyTorch
   version on seeded ~20K-gaussian scenes (512² and 1024², downscale 1
   and 2, 9 and 12 channels, all tiles and a covering tile budget);
   limits max |diff| <= 1e-4 and mean |diff| <= 1e-6;
4. golden: the ``simple`` CLI task on tests/golden/pcd_0.ply renders the
   12 golden views through the kernel; each must reach 50 dB PSNR;
5. learned slice: the ``pcrender`` CLI task, PCEncoder at the deployed
   width ``9 32 64 128 256 128`` with seeded random weights (saved as a
   JAX-layout .npz and loaded back), on a synthetic 800K-point cloud at
   scale factor 448, 12 circle views at 512² with x2 supersampling; the
   launch counter is reset just before it and must grow. Then a small
   learned render on the card is held against the CPU path, and the
   kernel is timed against its plain version at this path's view-0 shape;
6. one JSON line describing the kernel, then the result line.

It imports the port only (``gpcr_tpu_torch``; its PLY and PNG readers and
writers come through ``gpcr_tpu_torch.io``) and fails if ``jax`` was
imported. It exits non-zero, printing no result, when there is no CUDA
device or any phase fails.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "gpcr_tpu_torch", "build", "smoke")
TPU_KERNEL = "gpcr_tpu/ops/rasterize_stream.py:695"
MAX_ERR, MEAN_ERR = 1e-4, 1e-6
DUP_CAP = 256


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_device(torch):
    log(f"[device] python {sys.version.split()[0]}  torch {torch.__version__}"
        f"  cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    return card


def phase_build():
    from gpcr_tpu_torch.ops import cuda_build

    t0 = time.time()
    cuda_build.load("stream_blend")
    log(f"[build] stream_blend built/loaded in {time.time() - t0:.1f} s "
        f"into {os.path.relpath(cuda_build.BUILD_DIR, HERE)}")
    # ptxas reports four lines per channel-count instantiation (entry,
    # properties, stack and spills, registers and shared memory); show the
    # two the main path launches (C = 9 analytic, 12 learned)
    lines = cuda_build.BUILD_LOGS.get("stream_blend", "").splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("ILi9E" in line or "ILi12E" in line):
            for shown in lines[i:i + 4]:
                log("[build] " + shown.strip())


def _scene(torch, n, res, channels, seed, dev):
    """Seeded scene of n gaussians filling a res x res view."""
    from gpcr_tpu_torch.ops import rasterize as R

    g = torch.Generator().manual_seed(seed)
    means = torch.randn(n, 3, generator=g) * 0.3 + torch.tensor([0, 0, 2.5])
    scales = torch.rand(n, 3, generator=g) * 0.05 + 0.01
    rots = torch.randn(n, 4, generator=g)
    op = torch.rand(n, generator=g)
    feats = torch.rand(n, channels, generator=g)
    P = torch.zeros(4, 4)
    P[0, 0] = P[1, 1] = 1.0
    P[3, 2] = 1.0
    P[2, 2] = 100.0 / (100.0 - 0.01)
    P[2, 3] = -(100.0 * 0.01) / (100.0 - 0.01)
    settings = R.GaussianRasterizationSettings(
        image_height=res, image_width=res, tanfovx=1.0, tanfovy=1.0,
        bg=torch.full((channels,), 0.7, device=dev), scale_modifier=1.0,
        viewmatrix=torch.eye(4, device=dev), projmatrix=P.T.contiguous().to(dev),
        sh_degree=0, campos=torch.zeros(3, device=dev))
    return [t.to(dev) for t in (means, scales, rots, op, feats)], settings


def _bin(torch, prep, res, config):
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    grid_x = -(-res // 16)
    num_tiles = grid_x * grid_x
    stream, starts, _ = RS.bin_sorted_stream(prep, num_tiles, grid_x, config)
    counts = starts[1:] - starts[:-1]
    order = torch.argsort(-counts, stable=True).to(torch.int32)
    return stream, starts, order, num_tiles, grid_x


def _compare(torch, stream, starts, order, num_tiles, grid_x, channels,
             config):
    """Kernel vs plain on the same inputs; returns (max, mean) abs diff."""
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    acc, t = RS.blend_tiles(stream, starts, order, num_tiles, grid_x,
                            channels, config)
    torch.cuda.synchronize()
    acc_p, t_p = RS.blend_tiles_plain(stream, starts, order, num_tiles,
                                      grid_x, channels, config)
    torch.cuda.synchronize()
    errs = [(a - b).abs() for a, b in ((acc, acc_p), (t, t_p))]
    return (max(float(e.max()) for e in errs),
            max(float(e.mean()) for e in errs))


def phase_kernel_vs_plain(torch, dev):
    from gpcr_tpu_torch.ops import rasterize as R

    worst = 0.0
    for res in (512, 1024):
        for channels in (9, 12):
            arrays, settings = _scene(torch, 20_000, res, channels,
                                      seed=res + channels, dev=dev)
            means, scales, rots, op, feats = arrays
            base = R.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=256,
                                     opacity_radius=True)
            prep = R.preprocess(means, op, settings, base, scales=scales,
                                rotations=rots, colors_precomp=feats)
            stream, starts, order, nt, gx = _bin(torch, prep, res, base)
            active = int((starts[1:] > starts[:-1]).sum())
            for ds in (1, 2):
                for mat in (None, active):
                    cfg = base._replace(downscale=ds, max_active_tiles=mat)
                    n_grid = min(mat or nt, nt)
                    mx, mean = _compare(torch, stream, starts,
                                        order[:n_grid].contiguous(), nt, gx,
                                        channels, cfg)
                    worst = max(worst, mx)
                    log(f"[kernel] {res}² C={channels} ds={ds} "
                        f"max_active_tiles={mat} entries={stream.shape[0]} "
                        f"max|d|={mx:.3e} mean|d|={mean:.3e}")
                    check(mx <= MAX_ERR and mean <= MEAN_ERR,
                          f"kernel disagrees with plain: {mx} / {mean}")
    return worst


def phase_golden(torch, B):
    import numpy as np

    from gpcr_tpu_torch.io import read_png

    golden = os.path.join(HERE, "tests", "golden")
    with open(os.path.join(golden, "manifest.json")) as f:
        m = json.load(f)
    ds = os.path.join(WORK, "golden_ds", "scene")
    os.makedirs(ds, exist_ok=True)
    shutil.copy(os.path.join(golden, "pcd_0.ply"), ds)
    rpth = os.path.join(WORK, "golden_out") + "/"
    B.main([
        "simple", "--id_list", "scene",
        "--dataset_root", os.path.dirname(ds), "--rpth", rpth,
        "--skip_mesh", "--voxelized",
        "--scale_factor", str(m["scale_factor"]), "--fov", str(int(m["fov"])),
        "--sigma", str(m["sigma"]), "--background_color", "1",
        "--device", "cuda",
    ])
    out_dir = rpth + f"scene_simple_sigma_{m['sigma']}"
    psnrs = []
    for i in range(m["n_views"]):
        got = read_png(os.path.join(out_dir, f"rgb_{i}.png")).astype(np.float64)
        ref = read_png(os.path.join(golden, f"rgb_{i}.png")).astype(np.float64)
        mse = np.mean((got - ref) ** 2)
        psnrs.append(99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
    log("[golden] PSNR dB per view: " + " ".join(f"{p:.2f}" for p in psnrs))
    check(len(psnrs) == 12 and min(psnrs) >= 50.0,
          f"golden PSNR below 50 dB: {min(psnrs)}")
    return psnrs


def _learned_inputs(torch):
    """The synthetic 800K THuman-like cloud of scripts/bench_pcrender.py
    (seed 0, scale factor 448) and a seeded full-width checkpoint."""
    from gpcr_tpu_torch.cli.profile_pcrender import (LEARNED_INFO,
                                                      synthetic_cloud)
    from gpcr_tpu_torch.io import write_ply
    from gpcr_tpu_torch.models.encoder import PCEncoder
    from gpcr_tpu_torch.render.checkpoint import save_params

    coords, rgb = synthetic_cloud(800_000, 448, seed=0)
    ds = os.path.join(WORK, "learned_ds", "0519")
    os.makedirs(ds, exist_ok=True)
    write_ply(os.path.join(ds, "pcd_0.ply"), coords, rgb)

    run = os.path.join(WORK, "learned_run")
    os.makedirs(os.path.join(run, "option"), exist_ok=True)
    os.makedirs(os.path.join(run, "checkpoint"), exist_ok=True)
    with open(os.path.join(run, "option", "options.json"), "w") as f:
        json.dump({"pcml_info": LEARNED_INFO}, f)
    ckpt = os.path.join(run, "checkpoint", "model_epoch1.npz")
    save_params(ckpt, PCEncoder(LEARNED_INFO,
                                generator=torch.Generator().manual_seed(0)))
    return os.path.dirname(ds), ckpt


def phase_learned(torch, B, RS):
    root, ckpt = _learned_inputs(torch)
    torch.cuda.reset_peak_memory_stats()
    RS.LAUNCHES = 0
    res = B.main([
        "pcrender", "--ckpt", ckpt, "--id_list", "0519",
        "--dataset_root", root, "--rpth", os.path.join(WORK, "learned_out") + "/",
        "--skip_mesh", "--voxelized", "--scale_factor", "448", "--fov", "45",
        "--background_color", "1", "--device", "cuda",
        # seeded random weights give some splats rects wider than the
        # CLI's default cap of 16 tiles; a cap they all fit under lets the
        # check below require that no entry was dropped
        "--dup_cap", str(DUP_CAP),
    ])
    launches = RS.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    out, timing = res["0519"]
    for k in ("rgb", "xyz_w", "hitmap", "normal"):
        check(out[k] is not None and tuple(out[k].shape) == (1, 12, 512, 512, 3),
              f"{k} has shape {None if out[k] is None else tuple(out[k].shape)}")
        check(bool(torch.isfinite(out[k]).all()), f"{k} is not finite")
    # bg is 1 in every channel, so a covered pixel is one whose rgb moved
    coverage = float(((out["rgb"] - 1.0).abs() > 1e-3).any(-1).float().mean())
    log(f"[learned] model time {timing['model_time']:.4f} s, rgb time "
        f"{timing['rgb_time']:.4f} s, {timing['rgb_time'] / 12 * 1e3:.2f} "
        f"ms/view, peak memory {peak / 2**30:.3f} GiB, coverage "
        f"{coverage:.4f}, dup_overflow {timing['dup_overflow']}, kernel "
        f"launches {launches}")
    check(coverage > 0, "learned render covers no pixel")
    check(timing["dup_overflow"] == 0, "learned render dropped entries")
    check(launches > 0, "the learned path never launched the blend kernel")
    return launches, timing, peak, ckpt


def phase_learned_small(torch):
    """A small learned render on the card against the CPU path (the CPU
    path is held against gpcr_tpu by tests/test_torch_render.py)."""
    import numpy as np

    from gpcr_tpu_torch.cli.profile_pcrender import LEARNED_INFO
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    rng = np.random.RandomState(0)
    v = rng.randn(400, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    xyz = np.round(v * 0.8 * 64 + 512).astype(np.float32)
    rgb = (v * 0.5 + 0.5).astype(np.float32)
    info = dict(LEARNED_INFO, clr_encoder_channels="9 8 8 8 8 8",
                scale_factor=64)
    cam = RD.generate_cam({"fov": 60, "width_px": 48, "height_px": 48,
                           "mode": "circle", "n_imgs": 2, "d": 0, "r": 3,
                           "center_angles": [90, 0]})
    outs = {}
    for dev in ("cpu", "cuda"):
        rdr = RD.PCMLRender(info=info, voxelized=True, scale_factor=64,
                            device=dev)
        outs[dev] = rdr.render(PointCloud.from_numpy(xyz, rgb, device=dev),
                               None, cam.to(dev), 60.0, background_color=0.0)
    worst = max(float((outs["cuda"][k].cpu() - outs["cpu"][k]).abs().max())
                for k in ("rgb", "xyz_w", "hitmap", "normal"))
    log(f"[learned-small] 48² x2 views, cuda vs cpu max|d|={worst:.3e}")
    check(worst <= 1e-4, f"learned render on the card disagrees: {worst}")
    return worst


def _view0_stream(torch, ckpt):
    """The learned path's view-0 blend inputs, built as the renderer
    builds them (same splats, same settings, same config)."""
    from gpcr_tpu_torch.cli import benchmark as B
    from gpcr_tpu_torch.ops import rasterize as R
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    args = B.build_parser().parse_args(["pcrender", "--skip_mesh",
                                        "--voxelized", "--dup_cap",
                                        str(DUP_CAP)])
    config = B._raster_config(args)._replace(k_budget=None, downscale=2)
    rdr = RD.PCMLRender(ckpt, voxelized=True, scale_factor=448, device="cuda")
    pcd = PointCloud.from_ply(os.path.join(WORK, "learned_ds", "0519",
                                           "pcd_0.ply"), device="cuda")
    with torch.no_grad():
        sp, _, _ = rdr.encode(pcd)
        cam, _ = B._camera_for(args, "pcrender", torch.device("cuda"))
        bg3 = torch.ones(3, device="cuda")
        rp = RD.get_rasterize_param_from_camera(cam, 45, bg=bg3, sh_degree=1)
        means = RD.pcgc_rescale(sp.primitives, 512, 448)
        scales = sp.scale * float(3 ** 0.5 / 448 * 6)
        feats, bg = RD.fuse_view_features(rp["campos"][0], means, sp.sh,
                                          sp.normal, bg3, 1, True)
        settings = R.GaussianRasterizationSettings(
            rp["height"], rp["width"], rp["tanfov"], rp["tanfov"], bg, 1.0,
            rp["view_t"][0], rp["full_t"][0], 1, rp["campos"][0])
        prep = R.preprocess(means, sp.opacity[:, 0], settings, config,
                            scales=scales, rotations=sp.rotation,
                            colors_precomp=feats)
        stream, starts, order, nt, gx = _bin(torch, prep, rp["height"], config)
    return stream, starts, order, nt, gx, feats.shape[1], config


def _event_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(torch, ckpt):
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    stream, starts, order, nt, gx, channels, config = _view0_stream(torch, ckpt)
    mx, mean = _compare(torch, stream, starts, order, nt, gx, channels, config)
    check(mx <= MAX_ERR and mean <= MEAN_ERR,
          f"kernel disagrees with plain at the main-path shape: {mx} / {mean}")
    args = (stream, starts, order, nt, gx, channels, config)
    # plain, kernel, kernel, plain: the pairs bracket any drift
    p1 = _event_ms(torch, lambda: RS.blend_tiles_plain(*args), 3)
    k1 = _event_ms(torch, lambda: RS.blend_tiles(*args), 20)
    k2 = _event_ms(torch, lambda: RS.blend_tiles(*args), 20)
    p2 = _event_ms(torch, lambda: RS.blend_tiles_plain(*args), 3)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    log(f"[timing] view-0 blend at 1024² internal, ds=2, C={channels}, "
        f"entries={stream.shape[0]}, active tiles="
        f"{int((starts[1:] > starts[:-1]).sum())}: kernel {k1:.4f} / "
        f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms (CUDA events); "
        f"max|d|={mx:.3e} mean|d|={mean:.3e}")
    return ms, plain_ms, mx


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "gpcr_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(gpcr_tpu_torch/ is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from gpcr_tpu_torch.cli import benchmark as B
    from gpcr_tpu_torch.ops import rasterize_stream as RS
    from gpcr_tpu_torch.render.renderer import pin_fp32

    pin_fp32()
    dev = torch.device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        t0 = time.time()
        phase_device(torch)
        phase_build()
        worst = phase_kernel_vs_plain(torch, dev)
        phase_golden(torch, B)
        launches, timing, peak, ckpt = phase_learned(torch, B, RS)
        phase_learned_small(torch)
        ms, plain_ms, mx = phase_timing(torch, ckpt)
        # the port shares only gpcr_tpu.io's numpy readers and writers
        check("jax" not in sys.modules, "something imported jax")
        log(f"[done] all phases passed in {time.time() - t0:.1f} s")
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(json.dumps({"kernels": [{
        "name": "stream_blend",
        "route": "cuda",
        "source": "gpcr_tpu_torch/csrc/stream_blend.cu",
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max(worst, mx),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
