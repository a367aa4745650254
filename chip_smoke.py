#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``gpcr_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing what it found:

1. device: torch / CUDA versions, the card's name and power limit;
2. build: compiles ``gpcr_tpu_torch/csrc/stream_blend.cu``,
   ``stream_blend_bwd.cu`` and ``aligned_blend.cu`` with nvcc for sm_90a
   (all compilers started together) into ``gpcr_tpu_torch/build/`` and
   prints ptxas' registers, shared memory and spills for C = 3, 9 and 12;
3. kernel vs plain: on seeded ~20K-gaussian scenes (512² and 1024², 9 and
   12 channels) the CUDA blend kernel against its plain PyTorch version
   (downscale 1 and 2, all tiles and a covering tile budget; limits
   max |diff| <= 1e-4 and mean |diff| <= 1e-6), the contributor-count
   forward (same limits, counts equal) and the replay backward (per column
   max |diff| <= 1e-4 * max |plain| + 1e-6 and ||diff||_2 <= 1e-5 *
   ||plain||_2 + 1e-6, seeded non-uniform dL/dout and non-zero upstream
   of T); then the aligned all-tiles kernel against its plain version
   (acc and T, same limits) at C = 3, 9, 12 and chunk 64, 128, 256, on a
   500² image (sides no multiple of 16), each also on an over-drawn scene
   that takes the block's early exit;
4. golden: the ``simple`` CLI task on tests/golden/pcd_0.ply renders the
   12 golden views through the kernel; each must reach 50 dB PSNR;
5. learned slice (serving): the ``pcrender`` CLI task, PCEncoder at the
   deployed width ``9 32 64 128 256 128`` with seeded random weights (saved
   as a JAX-layout .npz and loaded back), on a synthetic 800K-point cloud
   at scale factor 448, 12 circle views at 512² with x2 supersampling; the
   launch counter is reset just before it and must grow. Then a small
   learned render on the card is held against the CPU path, and the
   kernel is timed against its plain version at this path's view-0 shape;
6. aligned route: ``render_views_fused(use_pallas=True)`` renders the 12
   golden views (50 dB against the golden PNGs, and against the stream
   route's float images of the same run) and view 0 of the learned cell's
   splats (finite, against the stream route); its launch counter is reset
   just before and must grow. The aligned kernel is then timed against
   its plain version at the learned view-0 shape;
7. scored run: a textured stretched-sphere mesh made from a seed is
   written as OBJ and sampled to a ~800K-point cloud at scale factor 448;
   the ``simple`` and ``pcrender`` CLI tasks (the latter at the deployed
   width, seeded random weights) run WITHOUT ``--skip_mesh``: ray-traced
   ground truth, 12 views 512² x2, PSNR / MS-SSIM scored (LPIPS reported
   as skipped: its weights are not in the repository); ``--metric_only``
   must give the same numbers, and the ``cam`` task a trajectory that
   ``Camera.load`` reads back;
8. gradients: one small scene through the differentiable rasterizer on the
   card against the CPU path;
9. training slice: the ``train`` CLI at the deployed width on synthetic
   scenes (batch 1, 200K points, 2 views at 512², scale factor 448) takes
   4 steps, then resumes for a 5th; both training launch counters are
   reset just before and must grow; losses finite, parameters moved, no
   dropped entries. The two training kernels are then compared and timed
   against their plain versions at this path's view-0 shape, and the
   rasterizer's forward + backward is timed at 800K analytic gaussians,
   1024², C = 3;
10. one JSON line describing the four kernels, then the result line.

It imports the port only (``gpcr_tpu_torch``) and fails if ``jax`` or any
module of the JAX package got imported. It exits non-zero, printing no
result, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "gpcr_tpu_torch", "build", "smoke")
TPU_KERNEL = "gpcr_tpu/ops/rasterize_stream.py:695"
TPU_KERNEL_CONTRIB = "gpcr_tpu/ops/rasterize_stream_vjp.py:352"
TPU_KERNEL_BWD = "gpcr_tpu/ops/rasterize_stream_vjp.py:442"
TPU_KERNEL_ALIGNED = "gpcr_tpu/ops/rasterize_pallas.py:116"
# the aligned route against the stream route, float images of one run: both
# blend the same entries in the same order with the same float32 products;
# the channel sums and the place of the 2x2 mean differ
ROUTE_ERR = 1e-5
# the scored ``simple`` run against its own mesh, dB (a dense cloud of
# sigma-1 splats over a smooth texture)
SIMPLE_PSNR_FLOOR = 18.0
MAX_ERR, MEAN_ERR = 1e-4, 1e-6
# replay backward vs plain, per gradient column: 1 / (1 - a) with a up to
# 0.99 amplifies rounding along a range, and the two sum in another order
BWD_REL, BWD_ABS = 1e-4, 1e-6
# and per column over all rows, so that an error on the typical row cannot
# hide behind the largest one: ||d||_2 <= BWD_L2_REL * ||plain||_2 + BWD_ABS
BWD_L2_REL = 1e-5
GRAD_REL = 1e-3  # card vs CPU gradients, max |d| over max |g| per input
DUP_CAP = 256
TRAIN_ARGS = ["--batch_size", "1", "--n_points", "200000", "--n_views", "2",
              "--hw", "512", "--scale_factor", "448", "--warmup", "1",
              "--channels", "9 32 64 128 256 128", "--log_every", "1",
              "--seed", "0", "--device", "cuda"]
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# HBM3 bandwidth
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12


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

    names = ("stream_blend", "stream_blend_bwd", "aligned_blend")
    t0 = time.time()
    # one nvcc per source, started together (a thread each: the compiler
    # runs in a child process); a failed build raises out of result()
    with ThreadPoolExecutor(len(names)) as pool:
        for job in [pool.submit(cuda_build.load, name) for name in names]:
            job.result()
    log(f"[build] {', '.join(names)} built/loaded in {time.time() - t0:.1f} s "
        f"into {os.path.relpath(cuda_build.BUILD_DIR, HERE)}")
    # ptxas reports four lines per instantiation (entry, properties, stack
    # and spills, registers and shared memory); show C = 3 (the
    # rasterizer-only timing), 9 (analytic) and 12 (learned, training).
    # The forward's entries end in Lb0E (serving) or Lb1E (with the count)
    for name in names:
        lines = cuda_build.BUILD_LOGS.get(name, "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(
                    f"ILi{c}E" in line for c in (3, 9, 12)):
                for shown in lines[i:i + 4]:
                    log(f"[build] {name}: " + shown.strip())


def _scene(torch, n, res, channels, seed, dev, overdraw=False):
    """Seeded scene of n gaussians filling a res x res view; with
    ``overdraw`` wide and nearly opaque ones, so that pixels end early."""
    from gpcr_tpu_torch.ops import rasterize as R

    g = torch.Generator().manual_seed(seed)
    means = torch.randn(n, 3, generator=g) * 0.3 + torch.tensor([0, 0, 2.5])
    scales = torch.rand(n, 3, generator=g) * 0.05 + 0.01
    rots = torch.randn(n, 4, generator=g)
    op = torch.rand(n, generator=g)
    if overdraw:
        scales, op = scales * 4.0, op * 0.1 + 0.9
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


def _upstream(torch, num_tiles, channels, seed, dev):
    """Seeded non-uniform upstream gradients of acc and of the final T."""
    g = torch.Generator().manual_seed(seed)
    dl_dout = torch.randn(num_tiles, 256, channels, generator=g).to(dev)
    dt_tot = torch.randn(num_tiles, 256, generator=g).to(dev)
    return dl_dout, dt_tot


def _compare_training(torch, stream, starts, order, num_tiles, grid_x,
                      channels, config, seed):
    """The contributor-count forward and the replay backward against their
    plain versions on the same inputs. Returns (forward max |d|, backward
    max |d|, backward worst per-column ratio to its max limit and to its
    L2 limit, (walked, live) pair counts)."""
    from gpcr_tpu_torch.ops import rasterize_stream as RS
    from gpcr_tpu_torch.ops import rasterize_stream_vjp as RV

    args = (stream, starts, order, num_tiles, grid_x, channels, config)
    acc, t, cnt = RS.blend_tiles(*args, with_contrib=True)
    torch.cuda.synchronize()
    acc_p, t_p, cnt_p, live_p = RS.blend_tiles_plain(*args, with_contrib=True,
                                                     with_live=True)
    errs = [(a - b).abs() for a, b in ((acc, acc_p), (t, t_p))]
    mx = max(float(e.max()) for e in errs)
    mean = max(float(e.mean()) for e in errs)
    check(mx <= MAX_ERR and mean <= MEAN_ERR,
          f"count forward disagrees with plain: {mx} / {mean}")
    check(bool(torch.equal(cnt, cnt_p)),
          f"n_contrib differs at {int((cnt != cnt_p).sum())} pixels")

    dl_dout, dt_tot = _upstream(torch, num_tiles, channels, seed, stream.device)
    bargs = (stream, starts, order, dl_dout, cnt, dt_tot, t, grid_x, channels,
             config)
    rows = RV.blend_tiles_bwd(*bargs)
    torch.cuda.synchronize()
    rows_p = RV.blend_tiles_bwd_plain(*bargs)
    torch.cuda.synchronize()
    col_err = (rows - rows_p).abs().amax(dim=0)
    col_lim = BWD_REL * rows_p.abs().amax(dim=0) + BWD_ABS
    ratio = float((col_err / col_lim).max())
    check(ratio <= 1.0, "replay backward disagrees with plain: per-column "
          f"max|d| {col_err.tolist()} against limits {col_lim.tolist()}")
    l2_err = torch.linalg.vector_norm((rows - rows_p).double(), dim=0)
    l2_lim = (BWD_L2_REL * torch.linalg.vector_norm(rows_p.double(), dim=0)
              + BWD_ABS)
    l2_ratio = float((l2_err / l2_lim).max())
    check(l2_ratio <= 1.0, "replay backward disagrees with plain: per-column "
          f"||d||_2 {l2_err.tolist()} against limits {l2_lim.tolist()}")
    check(float(rows_p.abs().max()) > 0, "the plain backward wrote no row")
    return (mx, float(col_err.max()), ratio, l2_ratio,
            (int(cnt.sum()), int(live_p.sum())))


def phase_kernel_vs_plain(torch, dev):
    """Returns the worst max |d| of (blend, count forward, replay
    backward) against their plain versions."""
    from gpcr_tpu_torch.ops import rasterize as R

    worst = 0.0
    worst_a = worst_b = 0.0
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
            a_err, b_err, ratio, l2_ratio, pairs = _compare_training(
                torch, stream, starts, order, nt, gx, channels, base,
                seed=res + channels)
            worst_a, worst_b = max(worst_a, a_err), max(worst_b, b_err)
            log(f"[kernel-train] {res}² C={channels} ds=1 "
                f"entries={stream.shape[0]} pairs walked / live="
                f"{pairs[0]} / {pairs[1]}: count forward "
                f"max|d|={a_err:.3e}, n_contrib equal; replay backward "
                f"max|d|={b_err:.3e}, worst column at {ratio:.3f} of its "
                f"limit ({BWD_REL:g} * max|plain| + {BWD_ABS:g}) and at "
                f"{l2_ratio:.3f} of its L2 limit ({BWD_L2_REL:g} * "
                f"||plain||_2 + {BWD_ABS:g})")
    return worst, worst_a, worst_b


def _compare_aligned(torch, prep, num_tiles, grid_x, channels, config):
    """The aligned kernel against its plain version on one view's layout.
    Returns (max, mean) abs diff over acc and T, the layout, and the share
    of pixels that ended before their tile's last chunk."""
    from gpcr_tpu_torch.ops import rasterize_aligned as RA

    scal, feat, cstarts, _ = RA.tile_bin_aligned(prep, num_tiles, grid_x,
                                                 config)
    args = (cstarts, scal, feat, num_tiles, grid_x, channels, config)
    acc, t = RA.blend_aligned_tiles(*args)
    torch.cuda.synchronize()
    acc_p, t_p = RA.blend_aligned_plain(*args)
    torch.cuda.synchronize()
    errs = [(a - b).abs() for a, b in ((acc, acc_p), (t, t_p))]
    ended = float((t_p < 1e-3).float().mean())
    return (max(float(e.max()) for e in errs),
            max(float(e.mean()) for e in errs), args, ended)


def phase_aligned_vs_plain(torch, dev):
    """Returns the worst max |d| of the aligned kernel against plain."""
    from gpcr_tpu_torch.ops import rasterize as R

    res = 500  # not a multiple of 16: the last tile row and column overhang
    grid_x = -(-res // 16)
    worst = 0.0
    for channels in (3, 9, 12):
        for chunk in (64, 128, 256):
            for overdraw in (False, True):
                arrays, settings = _scene(
                    torch, 20_000, res, channels, seed=channels + chunk,
                    dev=dev, overdraw=overdraw)
                means, scales, rots, op, feats = arrays
                cfg = R.RasterizeConfig(
                    max_dup_per_gaussian=64 if overdraw else 16,
                    chunk_size=chunk, opacity_radius=True)
                prep = R.preprocess(means, op, settings, cfg, scales=scales,
                                    rotations=rots, colors_precomp=feats)
                mx, mean, args, ended = _compare_aligned(
                    torch, prep, grid_x * grid_x, grid_x, channels, cfg)
                worst = max(worst, mx)
                log(f"[kernel-aligned] {res}² C={channels} chunk={chunk} "
                    f"overdraw={overdraw} chunks={args[1].shape[0]} pixels "
                    f"ended early={ended:.3f} max|d|={mx:.3e} "
                    f"mean|d|={mean:.3e}")
                check(mx <= MAX_ERR and mean <= MEAN_ERR,
                      f"aligned kernel disagrees with plain: {mx} / {mean}")
                check(not overdraw or ended > 0.2,
                      f"the over-drawn scene ended only {ended} of its pixels")
    return worst


def phase_golden(torch, B):
    import numpy as np

    from gpcr_tpu_torch.io import read_png

    golden = os.path.join(HERE, "tests", "golden")
    with open(os.path.join(golden, "manifest.json")) as f:
        m = json.load(f)
    ds = os.path.join(WORK, "golden_ds", "scene")
    os.makedirs(ds, exist_ok=True)
    # the golden cloud has no normals, and for such a cloud the simple task
    # first estimates them on the host (a brute-force kNN, minutes for 100K
    # points) although it renders none: hand it the cloud with placeholders
    from gpcr_tpu_torch.io import read_ply, write_ply

    cloud = read_ply(os.path.join(golden, "pcd_0.ply"))
    write_ply(os.path.join(ds, "pcd_0.ply"), cloud["xyz"], cloud["rgb"],
              np.zeros_like(cloud["xyz"]))
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


def _learned_splats(torch, ckpt):
    """The learned cell's splats and raster parameters, built as the
    renderer builds them (same weights, cloud, cameras and config): a dict
    of ``render_views_fused``'s arguments plus ``config``."""
    from gpcr_tpu_torch.cli import benchmark as B
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    args = B.build_parser().parse_args(["pcrender", "--skip_mesh",
                                        "--voxelized", "--dup_cap",
                                        str(DUP_CAP)])
    config = B._raster_config(args)._replace(k_budget=None)
    rdr = RD.PCMLRender(ckpt, voxelized=True, scale_factor=448, device="cuda")
    pcd = PointCloud.from_ply(os.path.join(WORK, "learned_ds", "0519",
                                           "pcd_0.ply"), device="cuda")
    with torch.no_grad():
        sp, _, _ = rdr.encode(pcd)
        cam, _ = B._camera_for(args, "pcrender", torch.device("cuda"))
        bg3 = torch.ones(3, device="cuda")
        rp = RD.get_rasterize_param_from_camera(cam, 45, bg=bg3, sh_degree=1)
    return dict(
        rp=rp, config=config, bg3=bg3,
        means=RD.pcgc_rescale(sp.primitives, 512, 448),
        scales=sp.scale * float(3 ** 0.5 / 448 * 6), rotation=sp.rotation,
        opacity=sp.opacity[:, 0], sh=sp.sh, normal=sp.normal, valid=sp.valid)


def _render_fused(torch, sp, views, use_pallas, with_normal=True):
    """``render_views_fused`` on the first ``views`` cameras of ``sp``
    (a dict as ``_learned_splats`` returns), at 512² x2."""
    from gpcr_tpu_torch.render import renderer as RD

    rp = sp["rp"]
    with torch.no_grad():
        return RD.render_views_fused(
            rp["view_t"][:views], rp["full_t"][:views], rp["campos"][:views],
            sp["means"], sp["scales"], sp["rotation"], sp["opacity"],
            sp["sh"], sp["normal"], sp["valid"], sp["bg3"], rp["tanfov"],
            height=rp["height"], width=rp["width"], out_h=rp["height"] // 2,
            out_w=rp["width"] // 2, sh_degree=rp["sh_degree"],
            config=sp["config"], with_normal=with_normal,
            use_pallas=use_pallas)


def _view0_prep(torch, sp):
    """The learned path's view-0 preprocessed splats (what both binnings
    take): (prep, channels, raster size)."""
    from gpcr_tpu_torch.ops import rasterize as R
    from gpcr_tpu_torch.render import renderer as RD

    rp = sp["rp"]
    with torch.no_grad():
        feats, bg = RD.fuse_view_features(
            rp["campos"][0], sp["means"], sp["sh"], sp["normal"], sp["bg3"], 1,
            True)
        settings = R.GaussianRasterizationSettings(
            rp["height"], rp["width"], rp["tanfov"], rp["tanfov"], bg, 1.0,
            rp["view_t"][0], rp["full_t"][0], 1, rp["campos"][0])
        prep = R.preprocess(sp["means"], sp["opacity"], settings, sp["config"],
                            scales=sp["scales"], rotations=sp["rotation"],
                            colors_precomp=feats)
    return prep, feats.shape[1], rp["height"]


def _view0_stream(torch, sp):
    """The learned path's view-0 stream blend inputs (downscale 2, as the
    renderer sets it)."""
    config = sp["config"]._replace(downscale=2)
    prep, channels, res = _view0_prep(torch, sp)
    with torch.no_grad():
        stream, starts, order, nt, gx = _bin(torch, prep, res, config)
    return stream, starts, order, nt, gx, channels, config


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


def _fwd_bound(pairs, entries, ncols, channels, n_pix_out, with_count):
    """(bound_ms, bound_by) of the blend forward on this data. ``pairs`` is
    (walked, live): every walked (entry, pixel) pair needs its alpha and
    the two skip tests, 16 float32 operations (dx, dy: 2; power: 9; the
    power > 0 test; expf counted as one; opacity * exp; min 0.99; the
    1 / 255 test). Only a live pair (not skipped) goes on: 1 - a, T * (1 -
    a), the termination test, the weight a * T and C multiply-adds, 4 + 2C
    more. Bytes: the stream rows read once, acc / T (/ count) written
    once."""
    walked, live = pairs
    ops = walked * 16 + live * (4 + 2 * channels)
    nbytes = entries * ncols * 4 + n_pix_out * (channels + 1 + with_count) * 4
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _bwd_bound(pairs, entries, ncols, channels, n_pix):
    """The same for the replay backward: 16 operations per walked pair (the
    alpha and its tests again); per live pair 33 + 4C more (1 - a, its
    reciprocal, T_excl: 3; G over C: 2C; the weight: 1; dL/da: 3; dL/dpower:
    1; the five geometry terms and dL/dopacity: 17; C feature terms; the
    update of B: 2; the 6 + C adds of the sum over pixels). A live pair at
    the 0.99 clamp needs no geometry terms and is charged them all the
    same. Bytes: stream rows read once, gradient rows written once, the
    per-pixel upstream (C + 3 values) read once."""
    walked, live = pairs
    ops = walked * 16 + live * (33 + 4 * channels)
    nbytes = 2 * entries * ncols * 4 + n_pix * (channels + 3) * 4
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _pairs(torch, stream, starts, order, nt, gx, channels, config):
    """(walked, live) (entry, pixel) pairs of the blend on this stream: the
    sums of the contributor counts and of the composited positions (the
    walk is the same at downscale 1 and 2). The walked count is the CUDA
    kernel's own, held equal to the plain version's."""
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    cfg = config._replace(downscale=1)
    _, _, cnt = RS.blend_tiles(stream, starts, order, nt, gx, channels, cfg,
                               with_contrib=True)
    _, _, cnt_p, live = RS.blend_tiles_plain(
        stream, starts, order, nt, gx, channels, cfg, with_contrib=True,
        with_live=True)
    check(bool(torch.equal(cnt, cnt_p)), "n_contrib differs from plain")
    return int(cnt.sum()), int(live.sum())


def phase_timing(torch, sp):
    """Kernel 1 at the learned view-0 shape; also returns the (walked,
    live) pair counts of that stream and its number of entries."""
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    stream, starts, order, nt, gx, channels, config = _view0_stream(torch, sp)
    pairs = _pairs(torch, stream, starts, order, nt, gx, channels, config)
    bound_ms, bound_by = _fwd_bound(
        pairs, stream.shape[0], stream.shape[1], channels,
        order.numel() * 256 // config.downscale ** 2, 0)
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
        f"max|d|={mx:.3e} mean|d|={mean:.3e}; {pairs[0]} (entry, pixel) "
        f"pairs walked, {pairs[1]} of them live, bound {bound_ms:.4f} ms by {bound_by}")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=mx, bound_ms=bound_ms,
                bound_by=bound_by), pairs, stream.shape[0]


# --------------------------------------------------------------------------
# the aligned route (kernel 4)
# --------------------------------------------------------------------------


def _psnr_u8(img01, ref_u8):
    """PSNR in dB of a float image (a tensor), cast to uint8 as
    ``save_pic`` casts it, against a uint8 reference (an array)."""
    import numpy as np

    from gpcr_tpu_torch.io import to_uint8

    got = to_uint8(img01.cpu().numpy()).astype(np.float64)
    mse = np.mean((got - ref_u8.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def phase_aligned_route(torch, B, RA, sp):
    """``render_views_fused(use_pallas=True)`` on the golden cloud (12
    views) and on the learned cell's splats (view 0), each against the
    stream route of the same run. Returns the aligned kernel's launches."""
    from gpcr_tpu_torch.io import read_png
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.structures.pointcloud import PointCloud
    from gpcr_tpu_torch.utils import sh as sh_utils

    golden = os.path.join(HERE, "tests", "golden")
    with open(os.path.join(golden, "manifest.json")) as f:
        m = json.load(f)
    dev = torch.device("cuda")
    args = B.build_parser().parse_args(["simple", "--skip_mesh", "--voxelized"])
    cam, _ = B._camera_for(args, "simple", dev)
    pcd = PointCloud.from_ply(os.path.join(golden, "pcd_0.ply"), device=dev)
    n = pcd.get_num_points()
    # the analytic splats of SimpleRender: identity rotations, isotropic
    # sigma / scale_factor scales, opacity 1, SH DC from the colours
    bg3 = torch.full((3,), float(m["bg"]), device=dev)
    simple = dict(
        rp=RD.get_rasterize_param_from_camera(cam, m["fov"], bg=bg3,
                                              sh_degree=1),
        config=B._raster_config(args)._replace(k_budget=None), bg3=bg3,
        means=RD.pcgc_rescale(pcd.xyz_w[0], 512, m["scale_factor"]),
        scales=torch.full((n, 3), m["sigma"] / m["scale_factor"], device=dev),
        rotation=torch.tensor([1.0, 0, 0, 0], device=dev).expand(n, 4),
        opacity=torch.ones(n, device=dev),
        sh=torch.cat([sh_utils.RGB2SH(pcd.rgb[0])[:, None, :],
                      torch.zeros((n, 12, 3), device=dev)], dim=1),
        normal=torch.zeros((n, 3), device=dev),
        valid=torch.ones(n, dtype=torch.bool, device=dev))

    RA.LAUNCHES = 0
    t0 = time.time()
    got = _render_fused(torch, simple, 12, True, with_normal=False)
    torch.cuda.synchronize()
    t_aligned = time.time() - t0
    learned = _render_fused(torch, sp, 1, True)
    torch.cuda.synchronize()
    launches = RA.LAUNCHES

    t0 = time.time()
    ref = _render_fused(torch, simple, 12, False, with_normal=False)
    torch.cuda.synchronize()
    t_stream = time.time() - t0
    psnrs = []
    for i in range(m["n_views"]):
        png = read_png(os.path.join(golden, f"rgb_{i}.png"))
        psnrs.append(_psnr_u8(got["rgb"][i], png))
    d_golden = max(float((got[k] - ref[k]).abs().max())
                   for k in ("rgb", "xyz_w", "hitmap"))
    log("[aligned-route] golden PSNR dB per view: "
        + " ".join(f"{p:.2f}" for p in psnrs))
    log(f"[aligned-route] golden, 12 views 512² x2, C=9: aligned vs stream "
        f"route max|d|={d_golden:.3e} (limit {ROUTE_ERR:g}); first pass on "
        f"the host clock {t_aligned:.3f} s aligned, {t_stream:.3f} s stream")
    check(len(psnrs) == 12 and min(psnrs) >= 50.0,
          f"aligned route below 50 dB on the golden views: {min(psnrs)}")
    check(d_golden <= ROUTE_ERR, f"aligned route is {d_golden} off the stream "
          "route on the golden cloud")
    check(int(got["dup_overflow"].sum()) == 0, "the aligned route reports "
          "overflow (it drops the count)")

    ref = _render_fused(torch, sp, 1, False)
    torch.cuda.synchronize()
    keys = ("rgb", "xyz_w", "hitmap", "normal")
    for k in keys:
        check(tuple(learned[k].shape) == (1, 512, 512, 3),
              f"aligned {k} has shape {tuple(learned[k].shape)}")
        check(bool(torch.isfinite(learned[k]).all()),
              f"aligned {k} is not finite")
    d_learned = max(float((learned[k] - ref[k]).abs().max()) for k in keys)
    coverage = float(((learned["rgb"] - 1.0).abs() > 1e-3).any(-1).float().mean())
    log(f"[aligned-route] learned view 0, 512² x2, C=12: aligned vs stream "
        f"route max|d|={d_learned:.3e} (limit {ROUTE_ERR:g}), coverage "
        f"{coverage:.4f}; kernel launches {launches}")
    check(d_learned <= ROUTE_ERR and coverage > 0,
          f"aligned route is {d_learned} off the stream route on the learned "
          f"splats (coverage {coverage})")
    check(launches == 13, f"the aligned route launched its kernel {launches} "
          "times, expected 13 (12 golden views + 1 learned)")
    return launches


def phase_timing_aligned(torch, sp, pairs, entries):
    """Kernel 4 at the learned view-0 shape (the same entries as kernel 1's
    timing, full-size output), in turns plain / kernel / kernel / plain.
    ``pairs`` are kernel 1's (walked, live) counts on these ``entries``:
    the walk is the same, and padding slots are no work the data needs."""
    from gpcr_tpu_torch.ops import rasterize_aligned as RA

    prep, channels, res = _view0_prep(torch, sp)
    config = sp["config"]
    gx = -(-res // 16)
    nt = gx * gx
    mx, mean, args, _ = _compare_aligned(torch, prep, nt, gx, channels, config)
    check(mx <= MAX_ERR and mean <= MEAN_ERR, "aligned kernel disagrees with "
          f"plain at the learned view-0 shape: {mx} / {mean}")
    cstarts, scal, feat = args[:3]
    slots = scal.shape[0] * scal.shape[2]
    # bytes as the layout holds them: every slot's 6 + C floats and the
    # chunk starts read once, acc and T of every tile written once
    nbytes = (scal.numel() + feat.numel() + cstarts.numel()
              + nt * 256 * (channels + 1)) * 4
    ops = pairs[0] * 16 + pairs[1] * (4 + 2 * channels)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    p1 = _event_ms(torch, lambda: RA.blend_aligned_plain(*args), 3)
    k1 = _event_ms(torch, lambda: RA.blend_aligned_tiles(*args), 20)
    k2 = _event_ms(torch, lambda: RA.blend_aligned_tiles(*args), 20)
    p2 = _event_ms(torch, lambda: RA.blend_aligned_plain(*args), 3)
    bin_ms = _event_ms(
        torch, lambda: RA.tile_bin_aligned(prep, nt, gx, config), 3)
    log(f"[timing-aligned] view-0 aligned blend at {res}², C={channels}, "
        f"chunk {config.chunk_size}: {slots} slots in {scal.shape[0]} chunks "
        f"({slots - entries} of them padding), "
        f"{int((cstarts[1:] > cstarts[:-1]).sum())} of {nt} tiles non-empty: "
        f"kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms (CUDA "
        f"events); max|d|={mx:.3e} mean|d|={mean:.3e}; bound {bound_ms:.4f} ms "
        f"by {bound_by} ({nbytes} bytes, {ops} operations); the layout's "
        f"binning (tile_bin_aligned) {bin_ms:.2f} ms")
    return dict(ms=min(k1, k2), plain_ms=min(p1, p2), max_abs_err=mx,
                bound_ms=bound_ms, bound_by=bound_by)


# --------------------------------------------------------------------------
# the scored benchmark run
# --------------------------------------------------------------------------


def _write_sphere_dataset(root, asset_id, n_samples, seed):
    """A textured stretched sphere (the learned cell's shape) as
    ``<root>/<id>/<id>.obj`` with material and texture, and its cloud
    ``pcd_0.ply`` sampled on the scale-factor-448 grid, normals included.
    Returns the number of points."""
    import numpy as np

    from gpcr_tpu_torch.io import write_ply, write_png
    from gpcr_tpu_torch.structures.mesh import Mesh

    d = os.path.join(root, asset_id)
    os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    # a smooth texture: a few random low-frequency waves per channel
    yy, xx = np.mgrid[0:256, 0:256] / 256.0
    tex = np.zeros((256, 256, 3))
    for c in range(3):
        for _ in range(4):
            fx, fy = rng.randint(1, 5, 2)
            tex[..., c] += np.sin(2 * np.pi * (fx * xx + fy * yy) + rng.rand() * 6)
    tex = (tex - tex.min()) / (tex.max() - tex.min())
    write_png(os.path.join(d, "tex.png"), (tex * 255).astype(np.uint8))
    with open(os.path.join(d, "mat.mtl"), "w") as f:
        f.write("newmtl m0\nKd 1 1 1\nmap_Kd tex.png\n")
    nu, nv = 256, 128  # longitude x latitude quads; the poles stay open
    u = np.linspace(0, 2 * np.pi, nu + 1)
    v = np.linspace(0.02 * np.pi, 0.98 * np.pi, nv + 1)
    uu, vv = np.meshgrid(u, v)  # (nv + 1, nu + 1)
    xyz = np.stack([np.sin(vv) * np.cos(uu), 1.6 * np.cos(vv),
                    np.sin(vv) * np.sin(uu)], -1).reshape(-1, 3)
    uv = np.stack([uu / (2 * np.pi), vv / np.pi], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(nv), np.arange(nu), indexing="ij")
    a = (i * (nu + 1) + j + 1).reshape(-1)  # OBJ indices start at 1
    quads = np.stack([a, a + 1, a + nu + 2, a + nu + 1], -1)
    with open(os.path.join(d, f"{asset_id}.obj"), "w") as f:
        f.write("mtllib mat.mtl\n")
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in xyz)
        f.writelines(f"vt {s:.6f} {t:.6f}\n" for s, t in uv)
        f.write("usemtl m0\n")
        f.writelines(f"f {p}/{p} {q}/{q} {r}/{r} {w}/{w}\n"
                     for p, q, r, w in quads)
    pcd = Mesh(os.path.join(d, f"{asset_id}.obj"), scale=1.0).sample_point_cloud(
        n_samples, method="uniform_quantized", seed=seed, quantize_scale=448.0)
    write_ply(os.path.join(d, "pcd_0.ply"), pcd.xyz_w[0].numpy(),
              pcd.rgb[0].numpy(), pcd.normal_w[0].numpy())
    return pcd.get_num_points()


def phase_scored(torch, B, RS, ckpt):
    """The scored benchmark entry point: ``simple`` and ``pcrender`` without
    ``--skip_mesh``, then ``--metric_only``, then the ``cam`` task."""
    from gpcr_tpu_torch.structures.camera import Camera

    root = os.path.join(WORK, "scored_ds")
    t0 = time.time()
    n_points = _write_sphere_dataset(root, "0001", 1_300_000, seed=0)
    log(f"[scored] dataset: stretched-sphere OBJ (65,536 triangles, 256² "
        f"texture) and a {n_points}-point cloud at scale factor 448, made in "
        f"{time.time() - t0:.1f} s")
    check(600_000 <= n_points <= 1_100_000,
          f"the sampled cloud has {n_points} points, meant ~800K")
    rpth = os.path.join(WORK, "scored_out") + "/"
    common = ["--id_list", "0001", "--dataset_root", root, "--rpth", rpth,
              "--voxelized", "--scale_factor", "448", "--fov", "45",
              "--background_color", "1", "--device", "cuda"]
    tasks = {"simple": ["simple", *common],
             "pcrender": ["pcrender", "--ckpt", ckpt, "--dup_cap",
                          str(DUP_CAP), *common]}
    gt_dir = rpth + "0001_mesh_gt"
    scores = {}
    for task, argv in tasks.items():
        RS.LAUNCHES = 0
        t0 = time.time()
        out, timing = B.main(argv)["0001"]
        total = time.time() - t0
        launches = RS.LAUNCHES
        s = scores[task] = timing["scores"]
        render_s = total - timing["gt_time"] - timing["score_time"]
        log(f"[scored] {task}: PSNR {s['psnr']:.4f} dB, MS-SSIM "
            f"{s['msssim']:.6f}, LPIPS {s['lpips']} (skipped: no weights in "
            f"the repository); ground truth {timing['gt_time']:.2f} s, render "
            f"{render_s:.2f} s (cloud read, model {timing['model_time']:.4f} "
            f"s, rgb {timing['rgb_time']:.4f} s, PNGs written), scoring "
            f"{timing['score_time']:.2f} s; dup_overflow "
            f"{timing['dup_overflow']}; blend kernel launches {launches}")
        check(tuple(out["rgb"].shape) == (1, 12, 512, 512, 3),
              f"{task} rgb has shape {tuple(out['rgb'].shape)}")
        check(all(os.path.exists(os.path.join(gt_dir, f"{kind}_{i}.png"))
                  for kind in ("rgb", "normal_w") for i in range(12)),
              f"{task} wrote no ground-truth PNGs")
        check(math.isfinite(s["psnr"]) and math.isfinite(s["msssim"])
              and 0.0 <= s["msssim"] <= 1.0, f"{task} scores: {s}")
        check(s["lpips"] is None, "LPIPS scored without weights")
        check(launches == 24 and timing["dup_overflow"] == 0,
              f"{task}: {launches} blend launches (expected 24: 12 views, "
              f"warm + timed), dup_overflow {timing['dup_overflow']}")
    check(scores["simple"]["psnr"] >= SIMPLE_PSNR_FLOOR,
          f"simple scores {scores['simple']['psnr']} dB against its own mesh, "
          f"below {SIMPLE_PSNR_FLOOR}")
    for task, argv in tasks.items():
        t0 = time.time()
        out, timing = B.main([*argv, "--metric_only"])["0001"]
        check(out is None and timing["scores"] == scores[task],
              f"{task} --metric_only gives {timing['scores']}, the run gave "
              f"{scores[task]}")
        log(f"[scored] {task} --metric_only: the same numbers, "
            f"{time.time() - t0:.2f} s")
    cam_path = os.path.join(WORK, "scored_out", "cam", "cam.npz")
    saved = B.main(["cam", "--cam_mode", "udlrfb", "--cam_save_path", cam_path,
                    "--device", "cuda"])
    back = Camera.load(cam_path)
    check(tuple(back.H_c2w.shape) == (1, 6, 4, 4) and back.width_px == 512
          and bool(torch.equal(back.H_c2w, saved.H_c2w.cpu())),
          "the cam task's file does not read back")
    log(f"[scored] cam task: udlrfb trajectory {tuple(back.H_c2w.shape)} saved "
        "and read back")
    return scores


# --------------------------------------------------------------------------
# training phases
# --------------------------------------------------------------------------


def phase_grad_small(torch):
    """Gradients of one small scene through
    ``rasterize_gaussians(differentiable=True)`` on the card against the
    CPU path (which tests/test_torch_stream_vjp.py holds against gpcr_tpu)."""
    from gpcr_tpu_torch.ops import rasterize as R

    config = R.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=64,
                               differentiable=True)
    grads = {}
    for dev in ("cpu", "cuda"):
        arrays, settings = _scene(torch, 2000, 128, 12, seed=3, dev=dev)
        leaves = [a.clone().requires_grad_(True) for a in arrays]
        means, scales, rots, op, feats = leaves
        color, _, extra = R.rasterize_gaussians(
            means, op, settings, scales=scales, rotations=rots,
            colors_precomp=feats, config=config, return_extra=True)
        w = 0.5 + (torch.arange(color.numel(), device=dev).reshape(color.shape)
                   % 7).to(torch.float32) / 7.0
        (torch.sum(color * w) + 0.3 * torch.sum(extra["final_T"])).backward()
        grads[dev] = [x.grad.cpu() for x in leaves]
    worst = 0.0
    for name, c, g in zip(("means", "scales", "rots", "op", "feats"),
                          grads["cpu"], grads["cuda"]):
        check(bool(torch.isfinite(g).all()), f"grad of {name} is not finite")
        check(float(c.abs().max()) > 0, f"grad of {name} is zero on the CPU")
        rel = float((g - c).abs().max() / c.abs().max())
        worst = max(worst, rel)
        check(rel <= GRAD_REL, f"grad of {name} on the card is {rel} off")
    log(f"[grad-small] 2000 gaussians 128² C=12, cuda vs cpu gradients: worst "
        f"max|d|/max|g| = {worst:.3e} (limit {GRAD_REL:g})")
    return worst


def phase_train(torch, RS, RV):
    """The train CLI at the deployed width: 4 steps, then resume for a 5th."""
    from gpcr_tpu_torch.cli import train as T
    from gpcr_tpu_torch.models.encoder import PCEncoder

    out_dir = os.path.join(WORK, "train_run")
    torch.cuda.reset_peak_memory_stats()
    RS.LAUNCHES_CONTRIB = 0
    RV.LAUNCHES_BWD = 0
    first = T.main(["--steps", "4", "--out_dir", out_dir, *TRAIN_ARGS])
    second = T.main(["--steps", "5", "--resume", "--out_dir", out_dir,
                     *TRAIN_ARGS])
    torch.cuda.synchronize()
    launches = (RS.LAUNCHES_CONTRIB, RV.LAUNCHES_BWD)
    peak = torch.cuda.max_memory_allocated()

    history = first["history"] + second["history"]
    check([h["step"] for h in history] == [1, 2, 3, 4, 5],
          f"steps logged: {[h['step'] for h in history]}")
    check(second["start_step"] == 4 and second["trainer"].step_count == 5
          and second["trainer"].optimizer.count == 5,
          "the resumed run did not continue from step 4")
    for h in history:
        check(all(v == v and abs(v) != float("inf") for v in h.values()),
              f"non-finite metric at step {h['step']}: {h}")
        check(h["dup_overflow"] == 0,
              f"step {h['step']} dropped {h['dup_overflow']} entries")
    # 5 steps x 1 cloud x 2 views, one launch of each kernel per view
    check(launches[0] == 10 and launches[1] == 10,
          f"training launched the kernels {launches} times, expected 10 each")
    # step 1 has learning rate 0 (the schedule is read before the count
    # grows), so the parameters first move at step 2
    init = PCEncoder(first["trainer"].info,
                     generator=torch.Generator().manual_seed(0)).state_dict()
    moved = sum(not torch.equal(v.cpu(), init[k])
                for k, v in first["trainer"].model.state_dict().items())
    check(moved == len(init), f"only {moved} of {len(init)} parameter "
          "tensors moved in 4 steps")
    log("[train] loss per step: "
        + " ".join(f"{h['loss']:.5f}" for h in history))
    log("[train] s/step (host clock, data loading included, ends in a "
        "synchronise): first " + f"{history[0]['s_per_step']:.3f}, then "
        + " ".join(f"{h['s_per_step']:.3f}" for h in history[1:4])
        + f"; resumed step {history[4]['s_per_step']:.3f}; peak memory "
        f"{peak / 2**30:.3f} GiB; kernel launches {launches}")
    return dict(launches=launches, peak=peak, history=history,
                trainer=second["trainer"])


def phase_train_stages(torch, trainer):
    """Where a training step's time goes: two more steps of the same
    configuration, host clock with a synchronise after each stage, then one
    ``torch.profiler`` trace of a forward + backward."""
    from gpcr_tpu_torch.train.data import DataLoader

    loader = DataLoader(batch_size=1, n_points=200_000, n_views=2, hw=512,
                        scale_factor=448, seed=1, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    for rep in range(2):
        batch, t_data = timed(loader.next_batch)
        trainer.optimizer.zero_grad()
        (total, _), t_fwd = timed(lambda: trainer.loss_fn(batch))
        _, t_bwd = timed(total.backward)
        _, t_opt = timed(trainer.optimizer.step)
        check(bool(torch.isfinite(total)), "stage-timing loss is not finite")
        log(f"[train-stages] rep {rep}: example on the host + upload "
            f"{t_data:.3f} s, forward {t_fwd:.3f} s, backward {t_bwd:.3f} s, "
            f"clip + Adam {t_opt:.3f} s")

    def forward_backward():
        trainer.optimizer.zero_grad()
        trainer.loss_fn(batch)[0].backward()

    # device time by op and the card's idle share of one forward + backward
    from gpcr_tpu_torch.cli.profile_pcrender import _traced

    _traced("train forward + backward", forward_backward,
            torch.device("cuda"), 14)


def _train_view0_stream(torch, trainer):
    """The training path's view-0 blend inputs, built as the trainer builds
    them: one batch of the CLI's loader, the trained network, the
    trainer's raster config."""
    from gpcr_tpu_torch.ops import rasterize as R
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.train.data import DataLoader

    batch = DataLoader(batch_size=1, n_points=200_000, n_views=2, hw=512,
                       scale_factor=448, seed=0, device="cuda").next_batch()
    # tile_batch only sizes the plain versions' steps
    config = trainer.config._replace(downscale=1, tile_batch=256)
    with torch.no_grad():
        (means, scales, rotation, opacity, sh, normal, valid,
         with_normal) = trainer._encode_splats(
             batch["coords"][0], batch["rgb"][0], batch["valid"][0])
        campos = batch["campos"][0, 0]
        feats, bg = RD.fuse_view_features(
            campos, means, sh, normal, torch.zeros(3, device="cuda"),
            trainer.info.sh_deg, with_normal)
        settings = R.GaussianRasterizationSettings(
            512, 512, batch["tanfov"], batch["tanfov"], bg, 1.0,
            batch["view_t"][0, 0], batch["full_t"][0, 0], trainer.info.sh_deg,
            campos)
        prep = R.preprocess(means, opacity, settings, config, scales=scales,
                            rotations=rotation, colors_precomp=feats,
                            valid_mask=valid)
        stream, starts, order, nt, gx = _bin(torch, prep, 512, config)
    return (stream, starts, order, nt, gx, feats.shape[1], config,
            int(means.shape[0]))


def _time_training_kernels(torch, tag, stream, starts, order, nt, gx,
                           channels, config, seed, plain_reps=2):
    """Compare and time the count forward and the replay backward against
    their plain versions on one stream, in turns plain / kernel / kernel /
    plain. Returns one dict per kernel for the kernels line."""
    from gpcr_tpu_torch.ops import rasterize_stream as RS
    from gpcr_tpu_torch.ops import rasterize_stream_vjp as RV

    a_err, b_err, ratio, l2_ratio, pairs = _compare_training(
        torch, stream, starts, order, nt, gx, channels, config, seed)
    args = (stream, starts, order, nt, gx, channels, config)
    _, t, cnt = RS.blend_tiles(*args, with_contrib=True)
    dl_dout, dt_tot = _upstream(torch, nt, channels, seed, stream.device)
    bargs = (stream, starts, order, dl_dout, cnt, dt_tot, t, gx, channels,
             config)
    ap1 = _event_ms(torch, lambda: RS.blend_tiles_plain(
        *args, with_contrib=True), plain_reps)
    ak1 = _event_ms(torch, lambda: RS.blend_tiles(*args, with_contrib=True), 20)
    ak2 = _event_ms(torch, lambda: RS.blend_tiles(*args, with_contrib=True), 20)
    ap2 = _event_ms(torch, lambda: RS.blend_tiles_plain(
        *args, with_contrib=True), plain_reps)
    bp1 = _event_ms(torch, lambda: RV.blend_tiles_bwd_plain(*bargs), plain_reps)
    bk1 = _event_ms(torch, lambda: RV.blend_tiles_bwd(*bargs), 20)
    bk2 = _event_ms(torch, lambda: RV.blend_tiles_bwd(*bargs), 20)
    bp2 = _event_ms(torch, lambda: RV.blend_tiles_bwd_plain(*bargs), plain_reps)
    entries, ncols = stream.shape
    a_bound, a_by = _fwd_bound(pairs, entries, ncols, channels,
                               order.numel() * 256, 1)
    b_bound, b_by = _bwd_bound(pairs, entries, ncols, channels,
                               order.numel() * 256)
    log(f"[timing-train] {tag}: C={channels}, chunk {config.chunk_size}, "
        f"entries={entries}, active tiles="
        f"{int((starts[1:] > starts[:-1]).sum())}, pairs walked / live="
        f"{pairs[0]} / {pairs[1]}")
    log(f"[timing-train] {tag}: count forward kernel {ak1:.4f} / {ak2:.4f} ms,"
        f" plain {ap1:.4f} / {ap2:.4f} ms, bound {a_bound:.4f} ms by {a_by}, "
        f"max|d|={a_err:.3e}")
    log(f"[timing-train] {tag}: replay backward kernel {bk1:.4f} / {bk2:.4f} "
        f"ms, plain {bp1:.4f} / {bp2:.4f} ms, bound {b_bound:.4f} ms by "
        f"{b_by}, max|d|={b_err:.3e} (worst column at {ratio:.3f} of its "
        f"max limit, {l2_ratio:.3f} of its L2 limit)")
    return (dict(ms=min(ak1, ak2), plain_ms=min(ap1, ap2), max_abs_err=a_err,
                 bound_ms=a_bound, bound_by=a_by),
            dict(ms=min(bk1, bk2), plain_ms=min(bp1, bp2), max_abs_err=b_err,
                 bound_ms=b_bound, bound_by=b_by))


def phase_timing_train(torch, trainer):
    """The two training kernels at the training path's view-0 shape."""
    (stream, starts, order, nt, gx, channels, config,
     n_splats) = _train_view0_stream(torch, trainer)
    log(f"[timing-train] training view 0: {n_splats} splats, "
        f"{stream.shape[0]} entries per view, 512², C={channels}")
    return _time_training_kernels(torch, "train view 0", stream, starts,
                                  order, nt, gx, channels, config, seed=11)


def phase_timing_raster(torch):
    """Rasterizer-only forward + backward at 800K analytic gaussians,
    1024², C = 3, dup cap 8, chunk 128, no k_budget: kernel A, kernel B and
    one whole forward + ``loss.backward()``, each in turns plain / kernel /
    kernel / plain. The plain turns of the whole step swap the two plain
    versions into the autograd Function (here only; the port never does)."""
    import numpy as np

    from gpcr_tpu_torch.ops import rasterize as R
    from gpcr_tpu_torch.ops import rasterize_stream as RS
    from gpcr_tpu_torch.ops import rasterize_stream_vjp as RV
    from gpcr_tpu_torch.render import renderer as RD

    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    n, sf = 800_000, 448
    v = rng.randn(n, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 1] *= 1.6
    v *= 0.55
    coords = ((v + rng.randn(n, 3) * 0.01) * sf + 512).astype(np.float32)
    cam = RD.generate_cam({"fov": 45.0, "width_px": 512, "height_px": 512,
                           "mode": "circle", "n_imgs": 2, "d": 0, "r": 3,
                           "center_angles": [90, 0]}, device=dev)
    bg = torch.ones(3, device=dev)
    rp = RD.get_rasterize_param_from_camera(cam, 45.0, bg=bg, sh_degree=0,
                                            super_sample_rate=2)
    res = rp["height"]
    config = R.RasterizeConfig(max_dup_per_gaussian=8, chunk_size=128,
                               differentiable=True)
    settings = R.GaussianRasterizationSettings(
        res, res, rp["tanfov"], rp["tanfov"], bg, 1.0, rp["view_t"][0],
        rp["full_t"][0], 0, rp["campos"][0])
    means = RD.pcgc_rescale(torch.from_numpy(coords).to(dev), 512, sf)
    leaves = [means, torch.full((n, 3), 1.0 / sf, device=dev),
              torch.tensor([1.0, 0, 0, 0], device=dev).repeat(n, 1),
              torch.full((n,), 0.9, device=dev),
              torch.from_numpy(rng.rand(n, 3).astype(np.float32)).to(dev)]
    leaves = [x.requires_grad_(True) for x in leaves]
    m, sc, q, o, f = leaves

    with torch.no_grad():
        prep = R.preprocess(m, o, settings, config, scales=sc, rotations=q,
                            colors_precomp=f)
        stream, starts, order, nt, gx = _bin(torch, prep, res, config)
    kernels = _time_training_kernels(
        torch, "800K analytic 1024²", stream, starts, order, nt, gx, 3,
        config, seed=13, plain_reps=1)

    def step():
        for x in leaves:
            x.grad = None
        color, _ = R.rasterize_gaussians(m, o, settings, scales=sc,
                                         rotations=q, colors_precomp=f,
                                         config=config)
        torch.mean((color - 0.5) ** 2).backward()

    def plain_step():
        kept = RS._blend_tiles_cuda, RV._blend_tiles_bwd_cuda
        RS._blend_tiles_cuda = RS.blend_tiles_plain
        RV._blend_tiles_bwd_cuda = RV.blend_tiles_bwd_plain
        try:
            step()
        finally:
            RS._blend_tiles_cuda, RV._blend_tiles_bwd_cuda = kept

    p1 = _event_ms(torch, plain_step, 1)
    k1 = _event_ms(torch, step, 5)
    k2 = _event_ms(torch, step, 5)
    p2 = _event_ms(torch, plain_step, 1)
    gmax = max(float(x.grad.abs().max()) for x in leaves)
    check(all(bool(torch.isfinite(x.grad).all()) for x in leaves) and gmax > 0,
          "rasterizer-only gradients are not finite or all zero")
    log(f"[timing-train] 800K analytic 1024²: forward + loss.backward() "
        f"through the kernels {k1:.2f} / {k2:.2f} ms, through the plain "
        f"versions {p1:.2f} / {p2:.2f} ms (CUDA events); max|g| {gmax:.3e}")
    return kernels


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
    from gpcr_tpu_torch.ops import rasterize_aligned as RA
    from gpcr_tpu_torch.ops import rasterize_stream as RS
    from gpcr_tpu_torch.ops import rasterize_stream_vjp as RV
    from gpcr_tpu_torch.render.renderer import pin_fp32

    pin_fp32()
    dev = torch.device("cuda")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        t0 = time.time()

        def run(phase, *args):
            """One phase, with its seconds on the host clock."""
            t1 = time.time()
            out = phase(*args)
            torch.cuda.synchronize()
            log(f"[time] {phase.__name__}: {time.time() - t1:.1f} s")
            return out

        card = phase_device(torch)
        run(phase_build)
        worst, worst_a, worst_b = run(phase_kernel_vs_plain, torch, dev)
        worst_c = run(phase_aligned_vs_plain, torch, dev)
        run(phase_golden, torch, B)
        launches, timing, peak, ckpt = run(phase_learned, torch, B, RS)
        run(phase_learned_small, torch)
        splats = _learned_splats(torch, ckpt)
        serve, pairs, entries = run(phase_timing, torch, splats)
        aligned_launches = run(phase_aligned_route, torch, B, RA, splats)
        aligned = run(phase_timing_aligned, torch, splats, pairs, entries)
        del splats
        run(phase_scored, torch, B, RS, ckpt)
        run(phase_grad_small, torch)
        train = run(phase_train, torch, RS, RV)
        run(phase_train_stages, torch, train["trainer"])
        k_contrib, k_bwd = run(phase_timing_train, torch, train["trainer"])
        run(phase_timing_raster, torch)
        # the port imports nothing of the JAX package
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "gpcr_tpu"))
        check(not leaked, f"modules of the JAX package got imported: {leaked}")
        log(f"[done] all phases passed in {time.time() - t0:.1f} s")
        log(card)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # max_abs_err is each kernel's largest difference from its plain version
    # at its main path's view-0 shape; the seeded scenes' comparisons were
    # held to their limits above and are in the log
    log(f"[kernel] worst max|d| on the seeded scenes: blend {worst:.3e}, "
        f"aligned blend {worst_c:.3e}, count forward {worst_a:.3e}, replay "
        f"backward {worst_b:.3e} "
        f"(absolute, on gradients up to thousands; limits per column "
        f"{BWD_REL:g} * max|plain| + {BWD_ABS:g} and ||d||_2 <= "
        f"{BWD_L2_REL:g} * ||plain||_2 + {BWD_ABS:g})")
    # no single PyTorch call computes any of the four (a sorted,
    # early-terminating alpha blend and its replay), so library_ms is null
    log(json.dumps({"kernels": [
        {"name": "stream_blend", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/stream_blend.cu",
         "replaces": TPU_KERNEL, "launches": launches, **serve,
         "library_ms": None},
        {"name": "stream_blend_contrib", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/stream_blend.cu",
         "replaces": TPU_KERNEL_CONTRIB, "launches": train["launches"][0],
         **k_contrib, "library_ms": None},
        {"name": "stream_blend_bwd", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/stream_blend_bwd.cu",
         "replaces": TPU_KERNEL_BWD, "launches": train["launches"][1],
         **k_bwd, "library_ms": None},
        {"name": "aligned_blend", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/aligned_blend.cu",
         "replaces": TPU_KERNEL_ALIGNED, "launches": aligned_launches,
         **aligned, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
