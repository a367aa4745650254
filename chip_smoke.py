#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``gpcr_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

Phases, each printing what it found:

1. device: torch / CUDA versions, the card's name and power limit;
2. build: compiles ``gpcr_tpu_torch/csrc/stream_blend.cu``,
   ``stream_blend_bwd.cu``, ``aligned_blend.cu``, ``sparse_conv.cu``,
   ``patch_attn.cu``, ``bin_stream.cu`` and ``preprocess.cu``
   with nvcc for sm_90a (all compilers started together; seconds per
   library) into
   ``gpcr_tpu_torch/build/`` and prints ptxas' registers, shared memory and
   spills for C = 3, 9 and 12 and for every sparse conv, attention,
   binning and preprocess kernel,
   and the stages and shared memory of the chunk rings of the count
   forward and the aligned blend at their main-path shapes;
3. kernel vs plain: on seeded ~20K-gaussian scenes (512² and 1024², 9 and
   12 channels) the CUDA blend kernel against its plain PyTorch version
   (downscale 1 and 2, all tiles and a covering tile budget; limits
   max |diff| <= 1e-4 and mean |diff| <= 1e-6), the contributor-count
   forward (same limits, counts equal) and the replay backward (per column
   max |diff| <= 1e-4 * max |plain| + 1e-6 and ||diff||_2 <= 1e-5 *
   ||plain||_2 + 1e-6, seeded non-uniform dL/dout and non-zero upstream
   of T; the same bits on a second launch); then the aligned all-tiles
   kernel against its plain version
   (acc and T, same limits) at C = 3, 9, 12 and chunk 64, 128, 256, on a
   500² image (sides no multiple of 16), each also on an over-drawn scene
   that takes the block's early exit;
4. golden: the ``simple`` CLI task on tests/golden/pcd_0.ply renders the
   12 golden views through the kernel; each must reach 50 dB PSNR;
5. learned slice (serving): the ``pcrender`` CLI task, PCEncoder at the
   deployed width ``9 32 64 128 256 128`` with seeded random weights (saved
   as a JAX-layout .npz and loaded back), on a synthetic 800K-point cloud
   at scale factor 448, 12 circle views at 512² with x2 supersampling; the
   launch counters are reset just before it: the blend's must grow, the
   sparse conv's by 68 per encode, the binning's by 12 per render (one per
   view). Then a small
   learned render on the card is held against the CPU path; the U-Net's
   sparse convs on ``csrc/sparse_conv.cu`` at that cloud's shapes (plan
   and kernel maps built and timed; every conv against its plain
   version, the same bits on a second launch; each conv timed beside its
   bound and its plain version, ``[sparse]`` per kind and level and
   ``[sparse-conv]`` per conv; the U-Net pass on the kernel against the
   differentiable ops); Point Transformer V3 at Pointcept's base widths
   on that cloud (one ``PCMLRender.render`` of the 12 views with the
   launch counters reset: 22 attentions and 27 sparse convs per encode,
   12 binnings;
   every attention of a pass on ``csrc/patch_attn.cu`` against its plain
   version and timed per level beside ``F.scaled_dot_product_attention``,
   ``[ptv3-attn]``; the 5³ stem's five launches and the 22 CPE convs
   against ``conv_map_plain``, ``[ptv3-conv]``; the pass against the
   benchmark's reference ``cellbench/reference/ptv3.py``); the
   end-to-end forward entry (``gpcr_tpu_torch/entry.py``, twin of
   ``__graft_entry__.py::entry``: 256 points, ``9 16 16 16 16 16``, one
   32² view) runs on the card with its launch counters at 0 (one serving
   launch per call, a finite (12, 32, 32) image within 1e-4 of the CPU),
   its warm calls timed, its host syncs counted by line and one call
   traced, and ``python -m gpcr_tpu_torch.entry`` runs in a subprocess
   pinned to this card (a one-rank dry run); then the
   kernel is timed against its plain version at this path's view-0 shape,
   beside that view's distributions over its tiles of the entries and of
   the entries walked (``[tile-work]``); the binning kernels
   (``csrc/bin_stream.cu``) at that view (717,176 splats) and at view 0
   of the analytic headline (800K points, 2048² inside) against
   ``bin_sorted_stream_plain``, every output bit-equal, both timed (CUDA
   events) beside the bound by bytes (``[binning]``); then one request
   of each benchmark cell through the cell's own program, every view
   preprocessed on ``csrc/preprocess.cu`` and binned on the kernels by
   ``LAUNCHES_PREP`` / ``LAUNCHES_BIN`` and by the request's
   ``prep_kernel_views`` / ``bin_kernel_views`` counters
   (``[cell-binning]``), and the preprocess kernel at each cell's view 0
   against ``fuse_view_features`` + ``preprocess`` (every field
   bit-equal), both timed (CUDA events; the kernel's device time) beside
   the bound by bytes (``[preprocess]``);
6. aligned route: ``render_views_fused(use_pallas=True)`` renders the 12
   golden views (50 dB against the golden PNGs, and against the stream
   route's float images of the same run) and view 0 of the learned cell's
   splats (finite, against the stream route); its launch counter is reset
   just before and must grow. The aligned kernel is then timed against
   its plain version at the learned view-0 shape, beside that layout's
   chunks per tile and chunks walked (``[tile-work]``);
7. scored run: a textured stretched-sphere mesh made from a seed is
   written as OBJ and sampled to a ~800K-point cloud at scale factor 448;
   the ``simple`` and ``pcrender`` CLI tasks (the latter at the deployed
   width, seeded random weights) run WITHOUT ``--skip_mesh``: ray-traced
   ground truth, 12 views 512² x2, PSNR / MS-SSIM scored (LPIPS reported
   as skipped: its weights are not in the repository); ``--metric_only``
   must give the same numbers, and the ``cam`` task a trajectory that
   ``Camera.load`` reads back;
8. pipeline: the scored run's OBJ through ``preprocess_obj`` into a new
   dataset root; ``cli.sample_pcd`` with ``uniform_quantized`` at the
   scored run's 1.3M candidates (the same PLY, byte for byte),
   ``poisson_disk`` at 200K points (no two closer than half the
   elimination radius, grid-checked on the card) and ``uniform_camera``
   at 800K; the native PLY parser against the Python reader (equal
   arrays, both timed); ``pipeline.rescale_run`` / ``scale_run`` at factor
   448 (xyz within 1e-3, rgb equal); ``simple --down_sample_ratio 0.5``
   against the mesh (>= SIMPLE_PSNR_FLOOR; ``voxel_downsampling`` on the
   card against the CPU: equal cells, 1e-5; CUDA-event ms); ``pcrender``
   at the deployed width on the round-tripped cloud within 0.1 dB of the
   scored run's; ``pipeline.evaluate_pair`` equal to the CLI's scores and
   ``save_difference_map``; a ``manual`` trajectory and its spiral through
   ``simple`` (the launch counter reset before each must grow); the
   z-buffer against the ray caster on one 512² view (tests/test_mesh.py's
   bars) and ``RGBDImage.get_pcd`` on the card against the CPU (1e-5);
   the 12 views titled and tiled into one PNG;
9. tools: the structures and utilities on the scored cloud (875,060
   points) and the learned cell's grid, each device function against the
   CPU: the surfel z-buffer (12 views 512², three shadings); the k points
   nearest to the 16,384 rays of one 128² view against ``GridRayQuery``
   (radius 2) and against the CPU on 512 rays, with projection, uv
   correspondence and sampling, capture geometry; ``interpolate_trilinear``
   and ``prune`` on the 717,176-voxel grid with 32 channels; ``get_mesh``
   voxel (cell 4, all points), Poisson (depth 7, a 200K subsample; closed,
   near the cloud, its ray cast against the surfel hits) and alpha (a 50K
   subsample); ``remesh_file`` of the scored OBJ; Camera slicing and frame
   meshes; a PointersectRecord from a ray cast back to its points; 1M vMF
   samples and per-row shuffles; one ColorCorrector step; golden view 0
   with ``settings.debug`` under ``utils/debug.trace`` (the serving
   kernel in the trace, a NaN mean raising FloatingPointError, ``timed``);
10. gradients: one small scene through the differentiable rasterizer on the
   card against the CPU path;
11. training slice: the ``train`` CLI at the deployed width on synthetic
   scenes (batch 1, 200K points, 2 views at 512², scale factor 448) takes
   4 steps, then resumes for a 5th; both training launch counters are
   reset just before and must grow; losses finite, parameters moved, no
   dropped entries. The two training kernels are then compared and timed
   against their plain versions at this path's view-0 shape, and the
   rasterizer's forward + backward is timed at 800K analytic gaussians,
   1024², C = 3 (each shape with its ``[tile-work]`` line);
12. sharded: the serving kernel with a tile window on each window of a
   4-way split of the learned view 0 (the split a 4-card ``--shard tiles``
   run makes) against its plain version (max 1e-4 / mean 1e-6), the
   assembled windows bit-equal to the unwindowed kernel, and per window
   its entries, windowed-binning and kernel times (``[sharded]``); then,
   in a one-rank NCCL process group, the 12 golden views through
   ``simple --shard views`` (PNGs byte-equal to the golden phase's) and
   ``--shard tiles`` (within one uint8 level; both >= 50 dB, the launch
   counter reset before each and 24 launches after: a warm and a timed
   run of 12 views), and ``train --sp 1``
   for 3 steps, whose losses must be the training phase's within 1e-4;
13. bench: the port's benchmark and demo entry points at their full
   sizes: ``python -m gpcr_tpu_torch.bench`` at its defaults (800K
   points, 1024² x2 = 2048² inside, 16 views per call; no dropped tile
   or entry; 16 binnings on the kernels per call), ``scripts.bench_matrix``
   c1 / c3a / c4 / c5 (c5 is the
   first non-square frame, 3840x2160 inside), ``scripts.bench_train_step``
   (3 reps; finite, non-zero gradients; peak memory),
   ``scripts.bench_pcrender --dup_cap 256`` (the CLI in a subprocess, no
   dropped entry) and ``scripts.train_demo`` for 100 of its 500 default
   steps (held-out PSNR up by more than 0.5 dB; DEMO_STEPS says why) and
   a resumed run of 5 more from its checkpoint, each JSON / ``#``
   line printed as the entry point prints it, the launch counters reset
   before each; device time by op and idle share of one headline call and
   one demo step (``torch.profiler``); then the serving kernel at view 0
   of the headline, c1, c4 and c5 scenes and the training kernels at the
   demo's view 0 against their plain versions (max 1e-4 / mean 1e-6),
   timed beside their bounds;
14. one JSON line describing the eight kernels (kernel 1 also with its
   launches in the ``--shard tiles`` run and in one entry call; each blend
   kernel with its launches in the bench phase and its times at the
   benchmarks' shapes; the sparse conv with its per-pass times, bounds
   and fill at the learned cloud; the binning's ms per view and bound at
   its two shapes; the preprocess's ms per view at each cell's view 0),
   then the result line.

It imports the port only (``gpcr_tpu_torch``) and fails if ``jax`` or any
module of the JAX package got imported. It exits non-zero, printing no
result, when there is no CUDA device or any phase fails; a failed phase
prints ``[fail] <phase> after <s> s: <error>`` first.
"""

from __future__ import annotations

import dataclasses
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
# sample_pcd's poisson_disk at a quarter of the CLI's 800K points (1M
# candidates through the elimination) to hold the pipeline phase's time
POISSON_POINTS = 200_000
# phase_tools at its users' sizes: the surfel z-buffer at 12 views 512²;
# the k nearest points to the rays of one 128² view, 256 rays per chunk,
# 512 of them again on the CPU; the learned cell's 800K points; Poisson of
# a 200K subsample (np.add.at and the depth-7 grid's tetrahedra on the
# host) and the alpha shape of a 50K one (scipy's Delaunay) instead of all
# 875K points; 1M vMF directions
TOOL_VIEWS, TOOL_RES, KNN_RES, KNN_CHUNK, KNN_CPU_RAYS = 12, 512, 128, 256, 512
LEARNED_POINTS, LEARNED_VOXELS = 800_000, 717_176
POISSON_SUBSAMPLE, ALPHA_SUBSAMPLE, VMF_SAMPLES = 200_000, 50_000, 1_000_000
# rays of the k-nearest view whose surfel render hits: the share of them
# that must have a point within the radius (a 128² pixel spans 7-9 voxels
# of a surface sampled about once per voxel, so only silhouette pixels may
# miss)
KNN_COVER = 0.9
# phase_sharded: the learned view 0 split as a 4-card tiles run splits it;
# its train --sp 1 losses against phase_train's of the same seed (the
# U-Net's index_add_ atomics sum in another order from run to run)
SHARD_WINDOWS, SHARD_LOSS_REL = 4, 1e-4
MANUAL_EYES = ["0 0.3 3", "3 0.3 0", "0 -0.3 -3", "-3 -0.3 0"]
TRAIN_ARGS = ["--batch_size", "1", "--n_points", "200000", "--n_views", "2",
              "--hw", "512", "--scale_factor", "448", "--warmup", "1",
              "--channels", "9 32 64 128 256 128", "--log_every", "1",
              "--seed", "0", "--device", "cuda"]
# phase_bench: train_demo's steps at its defaults (48², 2,048 points,
# batch 2 x 2 views), then a resumed run of a few more. Its 500 default
# steps took 505 s on an H100: a step runs over 10,000 small GEMMs of a
# U-Net on ~2K voxels and the card idles 0.88-0.92 of it, which smaller
# images or clouds do not cut (32², 1,024 points: 0.84-0.86 s per step);
# 100 steps hold the smoke's time, and the held-out PSNR rose by 2.75 dB
# by step 50 of that run
DEMO_STEPS, DEMO_RESUME = 100, 5
# phase_entry: the end-to-end forward entry on the card against the CPU
# (phase_learned_small's bar: the U-Net's float32 sums run in another
# order), its warm calls timed, and the seconds its subprocess may take
ENTRY_TOL, ENTRY_REPS, ENTRY_TIMEOUT = 1e-4, 20, 300
KERNEL_NAMES = ("stream_blend", "stream_blend_contrib", "stream_blend_bwd",
                "aligned_blend")
# the U-Net's sparse convs per encode, each one launch of
# csrc/sparse_conv.cu: 62 3³ (a block's shared gather as two), 3 down, 3 up
UNET_CONVS = 68
# sparse conv kernel vs its plain version: the same float32 products summed
# in another order, so per output within SPARSE_REL of the sum of the
# terms' magnitudes (|x| @ |W| + |b| over the same pairs) + SPARSE_ABS
SPARSE_REL, SPARSE_ABS = 1e-5, 1e-7
# PTv3: attention blocks per pass (encoder 2 2 2 6 2, decoder 2 2 2 2); the
# attention kernel against its plain version on outputs of |v| ~ 1 (float32
# sums in another order, exp2 for exp); the backbone against the benchmark
# reference (features of rms ~2 through ~20 layers of such differences)
PTV3_BLOCKS, ATTN_ABS, PTV3_TOL = 22, 1e-5, 1e-4
# the benchmark's cells (cellbench/workloads/) and the seed of their one
# request each in phase_cell_binning
CELLS = ("pcml800k.circle12", "ptv3_800k.circle12", "splat800k.orbit16",
         "ptv2_800k.circle12", "splat800k.orbit1")
CELL_SEED = 2**31 + 101
# PTv3's sparse convs per encode: the 5³ stem as five launches of 25
# offsets, and one 3³ CPE conv per block
PTV3_CONVS = 5 + PTV3_BLOCKS
# PTv2: grouped vector attentions per pass (patch embedding 1, encoder
# 2 2 6 2, decoder 1 1 1 1); the GVA kernel against its plain version
# (the same folded function, float32 sums in other orders) relative to
# the plain output's largest value; the backbone against the benchmark
# reference (unfolded) through 17 blocks
PTV2_BLOCKS, GVA_REL, PTV2_TOL = 17, 1e-5, 1e-4
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

    names = ("stream_blend", "stream_blend_bwd", "aligned_blend",
             "sparse_conv", "patch_attn", "bin_stream", "preprocess", "gva")
    t0 = time.time()

    def load(name):
        t1 = time.time()
        cuda_build.load(name)
        return time.time() - t1

    # one nvcc per source, started together (a thread each: the compiler
    # runs in a child process); a failed build raises out of result()
    with ThreadPoolExecutor(len(names)) as pool:
        seconds = [job.result() for job in [pool.submit(load, name)
                                            for name in names]]
    log(f"[build] {', '.join(names)} built/loaded in {time.time() - t0:.1f} s "
        f"into {os.path.relpath(cuda_build.BUILD_DIR, HERE)}; each: "
        + ", ".join(f"{n} {t:.1f} s" for n, t in zip(names, seconds)))
    # ptxas reports four lines per instantiation (entry, properties, stack
    # and spills, registers and shared memory); show C = 3 (the
    # rasterizer-only timing), 9 (analytic) and 12 (learned, training):
    # the serving and count forwards, the replay backward's two passes,
    # every instantiation of the sparse convolution (BN, TM, KC), the
    # binning's four kernels beside the CUB radix sort's, and the
    # preprocess kernel per SH degree
    for name in names:
        lines = cuda_build.BUILD_LOGS.get(name, "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and (name in (
                    "sparse_conv", "patch_attn", "bin_stream",
                    "preprocess", "gva") or any(
                    f"ILi{c}E" in line for c in (3, 9, 12))):
                for shown in lines[i:i + 4]:
                    log(f"[build] {name}: " + shown.strip())
    # the chunk rings of the count forward and the aligned blend at their
    # main-path shapes (stages, dynamic shared memory per CTA)
    from gpcr_tpu_torch.ops import rasterize_aligned as RA
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    for tag, (stages, smem) in (
            ("count forward, training (C=12, chunk 64)",
             RS.count_ring_stages(20, 64)),
            ("count forward, 800K analytic (C=3, chunk 128)",
             RS.count_ring_stages(11, 128)),
            ("aligned blend, learned (C=12, chunk 256)",
             RA.aligned_ring_stages(12, 256))):
        log(f"[build] ring of the {tag}: {stages} stages, {smem} bytes of "
            "shared memory per CTA")
    # the sparse conv's ring per (Cin, Cout) of the U-Net and PTv3 passes
    from gpcr_tpu_torch.ops import sparse as TSP

    for cin, cout in ((9, 32), (32, 8), (8, 8), (8, 16), (64, 16),
                      (16, 16), (16, 32), (64, 64), (128, 32), (32, 32),
                      (32, 64), (128, 128), (256, 64), (64, 128),
                      (256, 128), (128, 256), (256, 256), (512, 512)):
        p = TSP.sparse_conv_plan(cin, cout)
        log(f"[build] sparse conv {cin} -> {cout}: BN {p['bn']}, tile "
            f"{p['tm']}x{p['tn']}, KC {p['kc']}, {p['groups']} group(s), "
            f"{p['stages']} stages, {p['threads']} threads, {p['smem']} "
            "bytes of shared memory per CTA")


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
    plain versions on the same inputs, and the backward against a second
    launch of itself (the same bits). Returns (forward max |d|, backward
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
    again = RV.blend_tiles_bwd(*bargs)
    torch.cuda.synchronize()
    check(bool(torch.equal(rows, again)), "replay backward gave other bits "
          f"on a second launch at {int((rows != again).sum())} values")
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
    from gpcr_tpu_torch.utils.blend_inputs import bin_view
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
            stream, starts, order, nt, gx = bin_view(prep, res, base)
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
                f"bit-equal on two launches, max|d|={b_err:.3e}, worst "
                f"column at {ratio:.3f} of its "
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


def _golden_cli(B, tag, *more):
    """The ``simple`` CLI task on the golden cloud (12 views) into
    ``WORK/<tag>``; returns (its output directory, PSNR dB per view against
    the golden PNGs)."""
    import numpy as np

    from gpcr_tpu_torch.io import read_png, read_ply, write_ply

    golden = os.path.join(HERE, "tests", "golden")
    with open(os.path.join(golden, "manifest.json")) as f:
        m = json.load(f)
    ds = os.path.join(WORK, "golden_ds", "scene")
    if not os.path.isdir(ds):
        os.makedirs(ds)
        # the golden cloud has no normals, and for such a cloud the simple
        # task first estimates them on the host (a brute-force kNN, minutes
        # for 100K points) although it renders none: hand it the cloud with
        # placeholders
        cloud = read_ply(os.path.join(golden, "pcd_0.ply"))
        write_ply(os.path.join(ds, "pcd_0.ply"), cloud["xyz"], cloud["rgb"],
                  np.zeros_like(cloud["xyz"]))
    rpth = os.path.join(WORK, tag) + "/"
    B.main([
        "simple", "--id_list", "scene",
        "--dataset_root", os.path.dirname(ds), "--rpth", rpth,
        "--skip_mesh", "--voxelized",
        "--scale_factor", str(m["scale_factor"]), "--fov", str(int(m["fov"])),
        "--sigma", str(m["sigma"]), "--background_color", "1",
        "--device", "cuda", *more,
    ])
    out_dir = rpth + f"scene_simple_sigma_{m['sigma']}"
    psnrs = []
    for i in range(m["n_views"]):
        got = read_png(os.path.join(out_dir, f"rgb_{i}.png")).astype(np.float64)
        ref = read_png(os.path.join(golden, f"rgb_{i}.png")).astype(np.float64)
        mse = np.mean((got - ref) ** 2)
        psnrs.append(99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse))
    return out_dir, psnrs


def phase_golden(torch, B):
    _, psnrs = _golden_cli(B, "golden_out")
    log("[golden] PSNR dB per view: " + " ".join(f"{p:.2f}" for p in psnrs))
    check(len(psnrs) == 12 and min(psnrs) >= 50.0,
          f"golden PSNR below 50 dB: {min(psnrs)}")
    return psnrs


def _learned_inputs(torch):
    """The synthetic 800K THuman-like cloud of scripts/bench_pcrender.py
    (seed 0, scale factor 448) and a seeded full-width checkpoint, written
    by the port's twin of that script."""
    from gpcr_tpu_torch.scripts.bench_pcrender import write_inputs

    root = os.path.join(WORK, "learned_ds")
    ckpt = write_inputs(root, os.path.join(WORK, "learned_run"), 800_000, 448)
    return root, ckpt


def phase_learned(torch, B, RS):
    from gpcr_tpu_torch.ops import preprocess as P
    from gpcr_tpu_torch.ops import sparse as TSP

    root, ckpt = _learned_inputs(torch)
    torch.cuda.reset_peak_memory_stats()
    RS.LAUNCHES = RS.LAUNCHES_BIN = P.LAUNCHES_PREP = 0
    TSP.LAUNCHES = 0
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
    bin_launches = RS.LAUNCHES_BIN
    prep_launches = P.LAUNCHES_PREP
    sparse_launches = TSP.LAUNCHES
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
        f"launches {launches}, binning launches {bin_launches}, preprocess "
        f"launches {prep_launches}, sparse conv launches {sparse_launches}")
    check(coverage > 0, "learned render covers no pixel")
    check(timing["dup_overflow"] == 0, "learned render dropped entries")
    check(launches > 0, "the learned path never launched the blend kernel")
    # the CLI renders its 12 views twice (a warm and a timed run), each view
    # preprocessed and binned once on the kernels
    check(prep_launches == bin_launches == launches == 2 * 12,
          f"{prep_launches} preprocess, {bin_launches} binning and "
          f"{launches} blend launches: not 12 per render of the ring")
    # every conv of every encode (two per render) on the kernel
    check(sparse_launches > 0 and sparse_launches % UNET_CONVS == 0,
          f"{sparse_launches} sparse conv launches: not {UNET_CONVS} per "
          "encode")
    return launches, sparse_launches, timing, peak, ckpt


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


def _conv_calls(torch, model, grid, plan):
    """Every ``sparse.conv_map`` call of one inference forward of the
    encoder's backbone, per weight: [(cmap, feats, weight, bias, relu)]."""
    from gpcr_tpu_torch.ops import sparse as TSP

    calls, real = [], TSP.conv_map

    def record(cmap, feats_list, weights, biases, relu=False):
        calls.extend((cmap, f, w, b, relu)
                     for f, w, b in zip(feats_list, weights, biases))
        return real(cmap, feats_list, weights, biases, relu)

    TSP.conv_map = record
    try:
        with torch.no_grad():
            model.color_encoder(grid, plan)
    finally:
        TSP.conv_map = real
    return calls


def _sparse_bound_ms(cmap, cin, cout):
    """(bound by operations, bound by bytes) in ms of one conv: 2 Cin Cout
    per map pair (an output row and an offset with an input row: the work
    the conv needs, whatever the kernel's tiles compute) at PEAK_FLOPS;
    its input rows, weight and output rows each once, and the map, at
    PEAK_BYTES."""
    t = cmap.tiled_map()
    flops = 2.0 * t.pairs * cin * cout
    nbytes = 4 * (cmap.src.num * cin + t.nbr.shape[0] * cin * cout
                  + cmap.dst.num * cout + t.nbr.numel() + t.rows.numel()
                  + t.tile_masks.numel())
    return flops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3


def phase_sparse_conv(torch):
    """The U-Net's sparse convolutions on ``csrc/sparse_conv.cu`` at the
    learned cell's shapes: the smoke's 800K-point cloud (717,176 voxels),
    PCEncoder at the deployed width with seeded weights. Builds the plan
    (timed), records the inputs of every conv of one inference forward,
    holds every conv against the plain version (SPARSE_REL / SPARSE_ABS)
    and one per level to the same bits on a second launch, then times
    every conv (CUDA events) beside its bound and the plain version, and
    the whole U-Net pass on the kernel against the same pass on the
    differentiable ops. Returns the record for the kernels line."""
    from gpcr_tpu_torch.cli.profile_pcrender import (LEARNED_INFO,
                                                     synthetic_cloud)
    from gpcr_tpu_torch.models.encoder import (PCEncoder, PCMLInfo,
                                               assemble_input_features)
    from gpcr_tpu_torch.ops import sparse as TSP

    dev = torch.device("cuda")
    info = PCMLInfo.from_dict(dict(LEARNED_INFO, scale_factor=448))
    coords, rgb = synthetic_cloud(LEARNED_POINTS, 448, seed=0)
    xyz = torch.from_numpy(coords).to(dev)
    grid = TSP.quantize_average(xyz, assemble_input_features(
        info, xyz, torch.from_numpy(rgb).to(dev), 512))
    check(grid.num == LEARNED_VOXELS, f"the learned grid has {grid.num} voxels")
    model = PCEncoder(info, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = model.build_plan(grid)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    # the kernel maps, which a forward builds at each map's first launch
    t0 = time.perf_counter()
    for ms in plan["maps"].values():
        for m in ms:
            m.tiled_map()
    torch.cuda.synchronize()
    tiles_s = time.perf_counter() - t0
    level = {id(g): i for i, g in enumerate(plan["grids"])}
    calls = _conv_calls(torch, model, grid, plan)
    check(len(calls) == UNET_CONVS, f"{len(calls)} convs in one forward")

    records, worst = [], 0.0
    for i, (cmap, feats, w, b, relu) in enumerate(calls):
        cin, cout = w.shape[1], w.shape[2]
        lvl = level[id(cmap.dst)]
        t = cmap.tiled_map()

        def kernel():
            return TSP.conv_map(cmap, [feats], [w], [b], relu=relu)[0]

        def plain():
            return TSP.conv_map_plain(t, feats, w, b, cmap.dst.num, relu)

        with torch.no_grad():
            got, ref = kernel(), plain()
            scale = TSP.conv_map_plain(t, feats.abs(), w.abs(), b.abs(),
                                       cmap.dst.num)
            excess = float(((got - ref).abs()
                            - SPARSE_REL * scale - SPARSE_ABS).max())
            err = float((got - ref).abs().max())
            worst = max(worst, err)
            check(excess <= 0, f"sparse conv {i} ({cmap.kind}, level "
                  f"{lvl}, {cin} -> {cout}) disagrees with its plain "
                  f"version: max|d| {err}")
            if not any(r["level"] == lvl for r in records):
                check(torch.equal(got, kernel()), f"sparse conv {i}: "
                      "another launch gave other bits")
            del got, ref, scale
            ms = _event_ms(torch, kernel, 5)
            plain_ms = _event_ms(torch, plain, 1, warmup=0)
        ops_ms, bytes_ms = _sparse_bound_ms(cmap, cin, cout)
        records.append(dict(
            kind=cmap.kind, level=lvl, cin=cin, cout=cout, rows=cmap.dst.num,
            pairs=t.pairs, slots=t.slots, fill=t.pairs / t.slots, ms=ms,
            plain_ms=plain_ms, bound_ms=max(ops_ms, bytes_ms),
            bound_by="operations" if ops_ms >= bytes_ms else "bytes",
            slots_ms=2.0 * t.slots * cin * cout / PEAK_FLOPS * 1e3))

    def ops_path(cmap, feats_list, weights, biases, relu=False):
        outs = TSP._conv_ops(cmap, feats_list, weights, biases)
        return [torch.relu(o) for o in outs] if relu else outs

    with torch.no_grad():
        unet_ms = _event_ms(torch, lambda: model.color_encoder(grid, plan), 5)
        real = TSP.conv_map
        TSP.conv_map = ops_path
        try:
            ops_ms = _event_ms(torch, lambda: model.color_encoder(grid, plan),
                               2)
        finally:
            TSP.conv_map = real

    by = {}
    for r in records:
        key = (r["kind"], r["level"])
        agg = by.setdefault(key, dict(convs=0, ms=0.0, plain_ms=0.0,
                                      bound_ms=0.0, slots_ms=0.0, pairs=0,
                                      slots=0))
        agg["convs"] += 1
        for k in ("ms", "plain_ms", "bound_ms", "slots_ms", "pairs",
                  "slots"):
            agg[k] += r[k]
    # the two levers apart: the fill (pairs / slots) and the per-slot
    # efficiency (the computed slots' operations at peak / kernel time;
    # = the pair bound by operations / time / fill)
    for agg in by.values():
        agg["fill"] = agg["pairs"] / agg["slots"]
        agg["slot_eff"] = agg["slots_ms"] / agg["ms"]
    for (kind, lvl), agg in sorted(by.items()):
        log(f"[sparse] {kind} -> level {lvl} ({plan['grids'][lvl].num} rows):"
            f" {agg['convs']} convs, kernel {agg['ms']:.4f} ms, bound "
            f"{agg['bound_ms']:.4f} ms ({agg['bound_ms'] / agg['ms']:.1%}), "
            f"pairs {agg['pairs']}, slots {agg['slots']} (fill "
            f"{agg['fill']:.3f}; the slots at peak {agg['slots_ms']:.4f} "
            f"ms, per-slot efficiency {agg['slot_eff']:.1%}), plain "
            f"{agg['plain_ms']:.2f} ms")
    total = {k: sum(r[k] for r in records)
             for k in ("ms", "plain_ms", "bound_ms", "slots_ms", "pairs",
                       "slots")}
    total["fill"] = total["pairs"] / total["slots"]
    total["slot_eff"] = total["slots_ms"] / total["ms"]
    log(f"[sparse] per pass: {len(records)} launches, kernels "
        f"{total['ms']:.4f} ms (bound {total['bound_ms']:.4f} ms, "
        f"{total['bound_ms'] / total['ms']:.1%}), pairs {total['pairs']}, "
        f"slots {total['slots']} (fill {total['fill']:.4f}; the slots at "
        f"peak {total['slots_ms']:.4f} ms, per-slot efficiency "
        f"{total['slot_eff']:.1%}), plain {total['plain_ms']:.1f} "
        f"ms; U-Net pass {unet_ms:.4f} ms on the kernel, {ops_ms:.4f} ms "
        f"on the differentiable ops; plan {plan_s:.3f} s, kernel maps "
        f"{tiles_s:.3f} s; levels "
        f"{[g.num for g in plan['grids']]}; worst max|d| {worst:.3e}")
    for r in records:
        log("[sparse-conv] " + json.dumps(r))
    return dict(unet_ms=unet_ms, unet_ops_ms=ops_ms, plan_s=plan_s,
                tiles_s=tiles_s, max_abs_err=worst, per_level={
                    f"{kind}.L{lvl}": agg for (kind, lvl), agg in by.items()},
                **{f"pass_{k}": v for k, v in total.items()})


def phase_ptv3(torch):
    """Point Transformer V3 (``model_type`` "ptv3", Pointcept's base widths)
    on the smoke's 800K-point cloud (717,176 voxels) with the benchmark
    reference's seeded weights, through the cell's entry: the launch
    counters are reset just before one ``PCMLRender.render`` of 12 circle
    views at 512² x2 (two encodes), which must launch PTV3_BLOCKS
    attentions and PTV3_CONVS sparse convs per encode. Then, on the
    renderer's own grid and cached plan (a plan build timed apart): every
    attention of one pass held against the plain version (ATTN_ABS) and,
    once per level, to the same bits on a second launch, timed (CUDA
    events) beside its bound, its plain version and
    ``F.scaled_dot_product_attention`` on the same gathered patches
    (``[ptv3-attn]`` per level); every sparse conv of the pass (the 5³
    stem's five launches, the 22 CPE convs) against ``conv_map_plain``
    (SPARSE_REL / SPARSE_ABS) and timed beside its bound
    (``[ptv3-conv]`` per kind and level); the backbone against the
    reference (PTV3_TOL). Returns the record for the kernels line."""
    from cellbench.reference import ptv3 as REF
    from gpcr_tpu_torch.cli.profile_pcrender import synthetic_cloud
    from gpcr_tpu_torch.ops import patch_attn as PA
    from gpcr_tpu_torch.ops import rasterize as R
    from gpcr_tpu_torch.ops import sparse as TSP
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    dev = torch.device("cuda")
    coords, rgb_np = synthetic_cloud(LEARNED_POINTS, 448, seed=0)
    xyz = torch.from_numpy(coords).to(dev)
    rgb = torch.from_numpy(rgb_np).to(dev)
    s = REF.settings({})
    w = REF.make_weights(s, 13, torch.Generator(device=dev).manual_seed(0),
                         dev)
    rdr = RD.PCMLRender(
        info={"model_type": "ptv3", "scale_factor": 448,
              "clr_encoder_channels": "9"},
        voxelized=True, scale_factor=448, device="cuda",
        config=R.RasterizeConfig(max_dup_per_gaussian=DUP_CAP,
                                 chunk_size=256, opacity_radius=True))
    rdr.model.color_encoder.load_state_dict(w)
    model = rdr.model.color_encoder
    pcd = PointCloud(xyz_w=xyz[None], rgb=rgb[None])
    cam = RD.generate_cam({"fov": 45, "width_px": 512, "height_px": 512,
                           "mode": "circle", "n_imgs": 12, "d": 0, "r": 3,
                           "center_angles": [90, 0]}, device=dev)
    timing = {}
    torch.cuda.synchronize()
    PA.LAUNCHES = 0
    TSP.LAUNCHES = 0
    out = rdr.render(pcd, 448, cam, 45.0, super_sample_rate=2,
                     background_color=0.0, timing=timing)
    torch.cuda.synchronize()
    attn_launches, conv_launches = PA.LAUNCHES, TSP.LAUNCHES
    for k in ("rgb", "xyz_w", "hitmap", "normal"):
        check(tuple(out[k].shape) == (1, 12, 512, 512, 3)
              and bool(torch.isfinite(out[k]).all()),
              f"the PTv3 render's {k} is not a finite (1, 12, 512, 512, 3)")
    coverage = float((out["hitmap"] > 0).any(-1).float().mean())
    log(f"[ptv3] render of 12 views at 512² x2: model time "
        f"{timing['model_time']:.4f} s, rgb time {timing['rgb_time']:.4f} "
        f"s, coverage {coverage:.4f}, dup_overflow "
        f"{timing['dup_overflow']}, attention launches {attn_launches}, "
        f"sparse conv launches {conv_launches}")
    check(coverage > 0, "the PTv3 render covers no pixel")
    check(attn_launches == 2 * PTV3_BLOCKS,
          f"{attn_launches} attention launches in a request: not "
          f"{PTV3_BLOCKS} per encode")
    check(conv_launches == 2 * PTV3_CONVS,
          f"{conv_launches} sparse conv launches in a request: not "
          f"{PTV3_CONVS} per encode")
    del out

    with torch.no_grad():
        _, grid, plan = rdr.encode(pcd)
        check(grid.num == LEARNED_VOXELS, f"the grid has {grid.num} voxels")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.build_plan(grid)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
    level = {id(pt): i for i, lv in enumerate(plan["levels"])
             for pt in lv.patches}

    calls, real = [], PA.patch_attention

    def record(qkv, pt, heads):
        calls.append((qkv.clone(), pt, heads))
        return real(qkv, pt, heads)

    PA.patch_attention = record
    try:
        with torch.no_grad():
            model(grid, plan)
    finally:
        PA.patch_attention = real
    check(len(calls) == PTV3_BLOCKS, f"{len(calls)} attentions in a pass")

    records, worst, lib_worst, seen = [], 0.0, 0.0, set()
    for qkv, pt, heads in calls:
        lvl = level[id(pt)]

        def kernel():
            return PA.patch_attention(qkv, pt, heads)

        def plain():
            return PA.patch_attention_plain(qkv, pt, heads)

        def library():
            return _sdpa_patches(torch, qkv, pt, heads)

        with torch.no_grad():
            got, ref = kernel(), plain()
            err = float((got - ref).abs().max())
            worst = max(worst, err)
            check(err <= ATTN_ABS, f"attention at level {lvl}, {heads} "
                  f"heads disagrees with its plain version: max|d| {err}")
            if (lvl, heads) not in seen:
                seen.add((lvl, heads))
                check(torch.equal(got, kernel()), f"attention at level "
                      f"{lvl}: another launch gave other bits")
            lib_worst = max(lib_worst,
                            float((library() - ref).abs().max()))
            del got, ref
            ms = _event_ms(torch, kernel, 5)
            plain_ms = _event_ms(torch, plain, 1, warmup=0)
            library_ms = _event_ms(torch, library, 3)
        d = qkv.shape[1] // (3 * heads)
        # the queries the function needs (the last patch's shared rows are
        # the patch before's), K keys each: the two products and the exp
        ops = (4 * d + 1) * pt.k * pt.n * heads
        nbytes = 4 * heads * d * (2 * pt.patches * pt.k + 2 * pt.n)
        records.append(dict(level=lvl, n=pt.n, k=pt.k, patches=pt.patches,
                            heads=heads, ms=ms, plain_ms=plain_ms,
                            library_ms=library_ms,
                            bound_ms=max(ops / PEAK_FLOPS,
                                         nbytes / PEAK_BYTES) * 1e3))
    del calls
    by = {}
    for r in records:
        agg = by.setdefault(r["level"], dict(launches=0, ms=0.0,
                                             plain_ms=0.0, library_ms=0.0,
                                             bound_ms=0.0))
        agg["launches"] += 1
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            agg[k] += r[k]
    for lvl, agg in sorted(by.items()):
        log(f"[ptv3-attn] level {lvl} ({plan['levels'][lvl].grid.num} rows):"
            f" {agg['launches']} launches, kernel {agg['ms']:.4f} ms, bound "
            f"{agg['bound_ms']:.4f} ms ({agg['bound_ms'] / agg['ms']:.1%}),"
            f" plain {agg['plain_ms']:.2f} ms, sdpa {agg['library_ms']:.4f}"
            f" ms")

    # every sparse conv of the pass: the stem's five 25-offset launches
    # and the CPE's 3³ convs, each against its plain version
    conv_level = {id(lv.grid): i for i, lv in enumerate(plan["levels"])}
    stem_ids = {id(m) for m in plan["stem"]}
    convs = _conv_calls(torch, rdr.model, grid, plan)
    check(len(convs) == PTV3_CONVS, f"{len(convs)} sparse convs in a pass")
    conv_by, conv_worst, stem_err = {}, 0.0, 0.0
    for cmap, feats, wt, b, relu in convs:
        kind = "stem" if id(cmap) in stem_ids else "cpe"
        lvl = conv_level[id(cmap.dst)]
        cin, cout = wt.shape[1], wt.shape[2]
        t = cmap.tiled_map()

        def kernel():
            return TSP.conv_map(cmap, [feats], [wt], [b], relu=relu)[0]

        with torch.no_grad():
            got = kernel()
            ref = TSP.conv_map_plain(t, feats, wt, b, cmap.dst.num, relu)
            scale = TSP.conv_map_plain(
                t, feats.abs(), wt.abs(), None if b is None else b.abs(),
                cmap.dst.num)
            err = float((got - ref).abs().max())
            check(float(((got - ref).abs() - SPARSE_REL * scale
                         - SPARSE_ABS).max()) <= 0,
                  f"PTv3 {kind} conv at level {lvl} ({cin} -> {cout}) "
                  f"disagrees with its plain version: max|d| {err}")
            del got, ref, scale
            ms = _event_ms(torch, kernel, 5)
        conv_worst = max(conv_worst, err)
        if kind == "stem":
            stem_err = max(stem_err, err)
        ops_ms, bytes_ms = _sparse_bound_ms(cmap, cin, cout)
        agg = conv_by.setdefault(f"{kind}.L{lvl}", dict(
            convs=0, cin=cin, cout=cout, ms=0.0, bound_ms=0.0, pairs=0,
            slots=0))
        agg["convs"] += 1
        agg["ms"] += ms
        agg["bound_ms"] += max(ops_ms, bytes_ms)
        agg["pairs"] += t.pairs
        agg["slots"] += t.slots
    del convs
    for key, agg in conv_by.items():
        agg["fill"] = agg["pairs"] / agg["slots"]
        log(f"[ptv3-conv] {key}: {agg['convs']} convs {agg['cin']} -> "
            f"{agg['cout']}, kernel {agg['ms']:.4f} ms, bound "
            f"{agg['bound_ms']:.4f} ms ({agg['bound_ms'] / agg['ms']:.1%}),"
            f" fill {agg['fill']:.3f}")

    with torch.no_grad():
        pass_ms = _event_ms(torch, lambda: model(grid, plan), 3)
        got = model.backbone(grid, plan)
        _, _, want, _ = REF.backbone(xyz, rgb, w, s, 448)
    pass_err = float((got - want).abs().max())
    check(pass_err <= PTV3_TOL, f"the PTv3 pass disagrees with the "
          f"reference: max|d| {pass_err}")
    total = {k: sum(r[k] for r in records)
             for k in ("ms", "plain_ms", "bound_ms")}
    library_ms = sum(r["library_ms"] for r in records)
    log(f"[ptv3] per pass: {len(records)} attention launches, kernels "
        f"{total['ms']:.4f} ms (bound {total['bound_ms']:.4f} ms, "
        f"{total['bound_ms'] / total['ms']:.1%}), plain "
        f"{total['plain_ms']:.1f} ms, sdpa {library_ms:.4f} ms "
        f"(max|d| from plain {lib_worst:.3e}); {PTV3_CONVS} sparse convs "
        f"{sum(a['ms'] for a in conv_by.values()):.4f} ms; PTv3 pass "
        f"{pass_ms:.4f} ms; plan {plan_s:.3f} s; levels "
        f"{[lv.grid.num for lv in plan['levels']]}; worst attention max|d|"
        f" {worst:.3e}, conv {conv_worst:.3e}, stem {stem_err:.3e}, pass "
        f"against the reference {pass_err:.3e}")
    return dict(launches=attn_launches, sparse_conv_launches=conv_launches,
                pass_ms=pass_ms, plan_s=plan_s, max_abs_err=worst,
                conv_max_abs_err=conv_worst, stem_max_abs_err=stem_err,
                pass_max_abs_err=pass_err, library_max_abs_err=lib_worst,
                library="F.scaled_dot_product_attention (efficient or "
                        "math, float32, TF32 off)",
                per_level={f"L{lvl}": agg for lvl, agg in by.items()},
                convs=conv_by,
                **{f"attn_{k}": v for k, v in total.items()},
                library_ms=library_ms)


def phase_ptv2(torch):
    """Point Transformer V2 (``model_type`` "ptv2", Pointcept's m2 base
    widths) through its cell's own program (``ptv2_800k.circle12``: the
    cell's seeded cloud, weights and cameras): the launch counters are
    reset just before one ``PCMLRender.render`` of the 12-view ring at 512²
    x2 (two encodes), which must launch PTV2_BLOCKS grouped vector
    attentions per encode and no sparse conv or patch attention. Then, on
    the renderer's grid and cached plan: a plan build timed (its kNN apart)
    and held against the reference's geometry (brute-force kNN, pooling):
    0 neighbour-list mismatches at every level; every attention of one
    pass held against the plain version (GVA_REL) and timed (CUDA events)
    beside its least-work bound and the plain version (``[ptv2-gva]`` per
    level); the backbone against the reference (PTV2_TOL). Returns the
    record for the kernels line."""
    from cellbench import harness, scene, systems
    from cellbench.reference import network
    from cellbench.reference import ptv2 as REF
    from gpcr_tpu_torch.ops import gva as GV
    from gpcr_tpu_torch.ops import knn as KN
    from gpcr_tpu_torch.ops import patch_attn as PA
    from gpcr_tpu_torch.ops import sparse as TSP

    dev = torch.device("cuda")
    cell = harness.load_cell("ptv2_800k.circle12")
    cfg, traffic = cell["config"], cell["traffic"]
    system = systems.load(cfg["renderer"])
    inputs = system.make_inputs(cfg, CELL_SEED, dev)
    prog = system.Program(cfg, traffic, inputs, dev)
    cams = scene.Cameras(traffic, CELL_SEED, dev)
    timing = {}
    torch.cuda.synchronize()
    GV.LAUNCHES = PA.LAUNCHES = TSP.LAUNCHES = 0
    with harness.quiet():
        out = prog(cams.request(0), timing)
    torch.cuda.synchronize()
    launches = GV.LAUNCHES
    for k in ("rgb", "xyz_w", "hitmap", "normal"):
        check(tuple(out[k].shape) == (1, 12, 512, 512, 3)
              and bool(torch.isfinite(out[k]).all()),
              f"the PTv2 render's {k} is not a finite (1, 12, 512, 512, 3)")
    coverage = float((out["hitmap"] > 0).any(-1).float().mean())
    log(f"[ptv2] render of 12 views at 512² x2 (the plan built in it): "
        f"model time {timing['model_time']:.4f} s, rgb time "
        f"{timing['rgb_time']:.4f} s, coverage {coverage:.4f}, "
        f"dup_overflow {timing['dup_overflow']}, gva launches {launches}, "
        f"patch attention {PA.LAUNCHES}, sparse conv {TSP.LAUNCHES}")
    check(coverage > 0, "the PTv2 render covers no pixel")
    check(launches == 2 * PTV2_BLOCKS and PA.LAUNCHES == TSP.LAUNCHES == 0,
          f"{launches} gva, {PA.LAUNCHES} patch attention and "
          f"{TSP.LAUNCHES} sparse conv launches in a request: not "
          f"{PTV2_BLOCKS} gva per encode and nothing else")
    del out

    rdr = prog.rdr
    model = rdr.model.color_encoder
    knn_s, real_knn = [], KN.knn

    def timed_knn(*args):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got = real_knn(*args)
        torch.cuda.synchronize()
        knn_s.append(time.perf_counter() - t1)
        return got

    with torch.no_grad():
        _, grid, plan = rdr.encode(prog.pcd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        KN.knn = timed_knn
        try:
            model.build_plan(grid)
        finally:
            KN.knn = real_knn
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        s = REF.settings(cfg["pcml_info"])
        vox, _ = network.voxelize(inputs["xyz"], inputs["rgb"])
        t0 = time.perf_counter()
        levels = REF.hierarchy(vox, s)
        ref_s = time.perf_counter() - t0
    mismatches = []
    for got, want in zip(plan["levels"], levels):
        check(got.n == want.n, f"a plan level of {got.n} points, the "
              f"reference's {want.n}")
        mismatches.append(int((got.nbr.long() != want.nbr).any(1).sum()))
        check(torch.equal(got.delta, want.delta) and (
            want.cluster is None or torch.equal(got.cluster, want.cluster)),
            "the plan's relative positions or clusters differ from the "
            "reference's")
    log(f"[ptv2-knn] levels {[lv.n for lv in plan['levels']]}: plan "
        f"{plan_s:.3f} s, kNN {[round(t, 4) for t in knn_s]} s "
        f"(reference brute force and pooling {ref_s:.1f} s); neighbour-list "
        f"mismatches against the reference per level {mismatches}")
    check(sum(mismatches) == 0, f"kNN mismatches {mismatches}")
    del levels

    calls, real = [], GV.grouped_vector_attention
    level_of = {id(lv.nbr): i for i, lv in enumerate(plan["levels"])}

    def record(*args):
        calls.append(args)
        return real(*args)

    GV.grouped_vector_attention = record
    try:
        with torch.no_grad():
            model.backbone(grid, plan)
    finally:
        GV.grouped_vector_attention = real
    check(len(calls) == PTV2_BLOCKS, f"{len(calls)} attentions in a pass")
    records, worst = [], 0.0
    for args in calls:
        q, k, v, nbr, delta, kk, f = args
        n, c = q.shape
        g = f.m.shape[0]
        with torch.no_grad():
            got, ref = real(*args), GV.gva_plain(*args)
            err = float((got - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-30)
            worst = max(worst, rel)
            check(rel <= GVA_REL, f"gva at {c} channels, {kk} neighbours "
                  f"disagrees with its plain version: max|d| {err} "
                  f"({rel:.2e} of the largest output)")
            check(torch.equal(got, real(*args)), f"gva at {c} channels: "
                  "another launch gave other bits")
            del got, ref
            ms = _event_ms(torch, lambda: real(*args), 5)
            plain_ms = _event_ms(torch, lambda: GV.gva_plain(*args), 1,
                                 warmup=0)
        ops = REF.gva_least_ops(n, kk, c, g)
        nbytes = REF.gva_least_bytes(n, kk, c, g)
        records.append(dict(level=level_of[id(nbr)], n=n, k=kk, c=c, ms=ms,
                            plain_ms=plain_ms,
                            bound_ms=max(ops / PEAK_FLOPS,
                                         nbytes / PEAK_BYTES) * 1e3))
    del calls
    by = {}
    for r in records:
        agg = by.setdefault(r["level"], dict(launches=0, c=r["c"], ms=0.0,
                                             plain_ms=0.0, bound_ms=0.0))
        agg["launches"] += 1
        for key in ("ms", "plain_ms", "bound_ms"):
            agg[key] += r[key]
    for lvl, agg in sorted(by.items()):
        log(f"[ptv2-gva] level {lvl} ({plan['levels'][lvl].n} points, C "
            f"{agg['c']}): {agg['launches']} launches, kernel "
            f"{agg['ms']:.4f} ms, bound {agg['bound_ms']:.4f} ms "
            f"({agg['bound_ms'] / agg['ms']:.1%}), plain "
            f"{agg['plain_ms']:.2f} ms")

    with torch.no_grad():
        pass_ms = _event_ms(torch, lambda: model(grid, plan), 3)
        got = model.backbone(grid, plan)
        _, _, want, _, _ = REF.backbone(inputs["xyz"], inputs["rgb"],
                                        inputs["weights"], s,
                                        cfg["cloud"]["scale_factor"])
    pass_err = float((got - want).abs().max())
    log(f"[ptv2] backbone against the reference: max|d| {pass_err:.3e} on "
        f"outputs of max {float(want.abs().max()):.3f}, rms "
        f"{float(want.pow(2).mean().sqrt()):.3f}")
    check(pass_err <= PTV2_TOL, f"the PTv2 pass disagrees with the "
          f"reference: max|d| {pass_err}")
    total = {k: sum(r[k] for r in records)
             for k in ("ms", "plain_ms", "bound_ms")}
    log(f"[ptv2] per pass: {len(records)} gva launches, kernels "
        f"{total['ms']:.4f} ms (bound {total['bound_ms']:.4f} ms, "
        f"{total['bound_ms'] / total['ms']:.1%}), plain "
        f"{total['plain_ms']:.1f} ms; PTv2 pass {pass_ms:.4f} ms; worst "
        f"gva relative max|d| {worst:.3e}, pass against the reference "
        f"{pass_err:.3e}")
    del prog, inputs
    torch.cuda.empty_cache()
    return dict(launches=launches, pass_ms=pass_ms, plan_s=plan_s,
                knn_s=knn_s, knn_mismatches=mismatches,
                max_rel_err=worst, pass_max_abs_err=pass_err,
                per_level={f"L{lvl}": agg for lvl, agg in by.items()},
                **{f"gva_{k}": v for k, v in total.items()},
                library_ms=None)


def _sdpa_patches(torch, qkv, pt, heads):
    """The library's attention on ``pt``'s gathered patches: the gather
    and the unpad of ``patch_attention_plain`` around one
    ``F.scaled_dot_product_attention`` call in float32 (the memory-
    efficient backend, else the math one)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    c = qkv.shape[1] // 3
    d = c // heads
    t = qkv.index_select(0, pt.pad_rows).view(pt.patches, pt.k, 3, heads, d)
    q, k, v = t.permute(2, 0, 3, 1, 4).unbind(0)  # (patches, H, K, d)
    with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]):
        o = F.scaled_dot_product_attention(q, k, v)
    return o.transpose(1, 2).reshape(-1, c).index_select(0, pt.unpad_slots)


def _host_syncs(torch, fn):
    """Run ``fn`` under ``torch.cuda.set_sync_debug_mode("warn")`` and
    count the host syncs it makes, by the innermost line of the port on
    the Python stack where each was made."""
    import collections
    import traceback
    import warnings

    pkg = os.path.join(HERE, "gpcr_tpu_torch") + os.sep
    waits = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        # c10's warning on a sync; not the notice that the mode is a
        # prototype, which setting it gives
        if "called a synchronizing CUDA operation" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg)]
        where = ((os.path.relpath(ours[-1].filename, HERE), ours[-1].lineno)
                 if ours else (filename, lineno))
        waits["%s:%d" % where] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return waits


def _entry_subprocess():
    """``python -m gpcr_tpu_torch.entry`` with only this process's card
    visible, so that its dry run is a world of one rank; its process group
    is killed if it outlasts ENTRY_TIMEOUT. Returns (exit code, stdout,
    stderr, seconds)."""
    import signal

    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")[0]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible.strip() or "0")
    t = time.time()
    p = subprocess.Popen([sys.executable, "-m", "gpcr_tpu_torch.entry"],
                         cwd=HERE, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=ENTRY_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)  # with the dry run's ranks
        out, err = p.communicate()
        err += f"\n(killed after {ENTRY_TIMEOUT} s)"
    return p.returncode, out, err, time.time() - t


def phase_entry(torch, RS, RV, card):
    """The end-to-end forward entry (``gpcr_tpu_torch/entry.py``, the twin
    of ``__graft_entry__.py::entry``) on the card: a finite (12, 32, 32)
    image from exactly one serving-kernel launch and no training kernel
    per call, within ENTRY_TOL of ``entry(device="cpu")``; the warm wall
    time per call (host clock after ``torch.cuda.synchronize()`` over
    ENTRY_REPS calls); the host syncs of one call by the line that waits,
    and the device's busy time and idle share of one traced call; then
    ``python -m gpcr_tpu_torch.entry`` in a subprocess, which must exit 0.
    Returns the serving launches of the one call driven with the counters
    at 0."""
    import statistics

    from gpcr_tpu_torch import entry as E
    from gpcr_tpu_torch.cli.profile_pcrender import _traced

    counts = dict.fromkeys(KERNEL_NAMES, 0)
    fn, args = E.entry()
    fn_c, args_c = E.entry(device="cpu")
    with torch.no_grad():
        out, got = _counted(RS, RV, counts, lambda: fn(*args))
        torch.cuda.synchronize()
        want = fn_c(*args_c)
        check(tuple(out.shape) == (12, E.HW, E.HW),
              f"entry image has shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "entry image is not finite")
        check(got == (1, 0, 0), f"entry launched (serving, count forward, "
              f"replay backward) = {got}, not one serving launch")
        err = float((out.cpu() - want).abs().max())
        check(err <= ENTRY_TOL, f"entry on the card disagrees with the "
              f"CPU: max|d| {err}")
        times = []
        for _ in range(ENTRY_REPS):
            t = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        waits = _host_syncs(torch, lambda: fn(*args))
        trace = _traced("entry call", lambda: fn(*args), torch.device("cuda"),
                        8)
    log(f"[entry] (12, 32, 32) image, cuda vs cpu max|d|={err:.3e}, "
        f"(serving, count, backward) launches of one call {got}; warm wall "
        f"ms per call median {statistics.median(times):.4f}, min "
        f"{min(times):.4f}, max {max(times):.4f} over {ENTRY_REPS} calls "
        f"(host clock after synchronize; {card}); traced call "
        f"{trace['wall_ms']:.4f} ms wall, {trace['device_busy_ms']:.4f} ms "
        f"on the device, idle share {trace['idle_share']:.4f}")
    log(f"[entry] host syncs in one call: {sum(waits.values())}; by the "
        "port's line that waits: " + json.dumps(dict(waits.most_common())))
    rc, sub_out, sub_err, sub_s = _entry_subprocess()
    log(f"[entry] python -m gpcr_tpu_torch.entry (one visible card): exit "
        f"{rc} in {sub_s:.1f} s; "
        + " | ".join(sub_out.strip().splitlines()[-3:]))
    check(rc == 0, "python -m gpcr_tpu_torch.entry failed:\n"
          + sub_err[-3000:])
    return got[0]


def _learned_splats(torch, ckpt):
    """The learned cell's splats and raster parameters, built as the
    renderer builds them (same weights, cloud, cameras and config): a dict
    of ``render_views_fused``'s arguments plus ``config``
    (``utils/blend_inputs.learned_splats``)."""
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.structures.pointcloud import PointCloud
    from gpcr_tpu_torch.utils.blend_inputs import learned_splats

    rdr = RD.PCMLRender(ckpt, voxelized=True, scale_factor=448, device="cuda")
    pcd = PointCloud.from_ply(os.path.join(WORK, "learned_ds", "0519",
                                           "pcd_0.ply"), device="cuda")
    return learned_splats(rdr, pcd, DUP_CAP)


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


def _event_ms(torch, fn, reps, warmup=1):
    for _ in range(warmup):
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


def _log_tile_work(tag, starts, order, cnt, chunk, forward):
    """The step-1 distributions of a blend's work over its rendered tiles
    (``utils/blend_inputs.tile_work``): entries per tile, entries a tile's
    one-CTA walk covers, and the share of those (entry, pixel) slots whose
    pixel had already stopped."""
    from gpcr_tpu_torch.utils.blend_inputs import tile_work

    w = tile_work(starts, order, cnt, chunk, forward)
    d = " / ".join(f"{w[k]['max']} / {w[k]['p99']:.0f} / {w[k]['median']:.0f}"
                   for k in ("entries", "walked"))
    log(f"[tile-work] {tag}: {w['tiles']} non-empty tiles; entries per tile "
        f"and walked per tile (max / p99 / median) {d}; "
        f"{w['stopped_share']:.3f} of the walked (entry, pixel) slots belong "
        f"to pixels already stopped")


def _pairs(torch, stream, starts, order, nt, gx, channels, config):
    """(walked, live) (entry, pixel) pairs of the blend on this stream: the
    sums of the contributor counts and of the composited positions (the
    walk is the same at downscale 1 and 2), and the counts themselves.
    The walked count is the CUDA kernel's own, held equal to the plain
    version's."""
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    cfg = config._replace(downscale=1)
    _, _, cnt = RS.blend_tiles(stream, starts, order, nt, gx, channels, cfg,
                               with_contrib=True)
    _, _, cnt_p, live = RS.blend_tiles_plain(
        stream, starts, order, nt, gx, channels, cfg, with_contrib=True,
        with_live=True)
    check(bool(torch.equal(cnt, cnt_p)), "n_contrib differs from plain")
    return int(cnt.sum()), int(live.sum()), cnt


def _time_serving(torch, tag, stream, starts, order, nt, gx, channels,
                  config):
    """Kernel 1 against its plain version on one stream (max 1e-4 / mean
    1e-6), then timed in turns plain / kernel / kernel / plain (CUDA
    events, 20 launches per kernel turn), beside its bound on this data.
    Returns (the kernels line's record, the (walked, live) pair counts,
    the contributor count)."""
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    *pairs, cnt = _pairs(torch, stream, starts, order, nt, gx, channels,
                         config)
    bound_ms, bound_by = _fwd_bound(
        pairs, stream.shape[0], stream.shape[1], channels,
        order.numel() * 256 // config.downscale ** 2, 0)
    mx, mean = _compare(torch, stream, starts, order, nt, gx, channels, config)
    check(mx <= MAX_ERR and mean <= MEAN_ERR,
          f"kernel disagrees with plain at {tag}: {mx} / {mean}")
    args = (stream, starts, order, nt, gx, channels, config)
    # plain, kernel, kernel, plain: the pairs bracket any drift
    p1 = _event_ms(torch, lambda: RS.blend_tiles_plain(*args), 3)
    k1 = _event_ms(torch, lambda: RS.blend_tiles(*args), 20)
    k2 = _event_ms(torch, lambda: RS.blend_tiles(*args), 20)
    p2 = _event_ms(torch, lambda: RS.blend_tiles_plain(*args), 3)
    log(f"[timing] {tag} blend, ds={config.downscale}, C={channels}, "
        f"chunk {config.chunk_size}, entries={stream.shape[0]}, tiles {nt} "
        f"(grid_x {gx}), rendered {order.numel()}, active "
        f"{int((starts[1:] > starts[:-1]).sum())}: kernel {k1:.4f} / "
        f"{k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms (CUDA events); "
        f"max|d|={mx:.3e} mean|d|={mean:.3e}; {pairs[0]} (entry, pixel) "
        f"pairs walked, {pairs[1]} of them live, bound {bound_ms:.4f} ms by "
        f"{bound_by}")
    return (dict(ms=min(k1, k2), plain_ms=min(p1, p2), max_abs_err=mx,
                 bound_ms=bound_ms, bound_by=bound_by), pairs, cnt)


def phase_timing(torch, sp):
    """Kernel 1 at the learned view-0 shape; also returns the (walked,
    live) pair counts of that stream, its number of entries, and its
    contributor count and entries per tile."""
    from gpcr_tpu_torch.utils.blend_inputs import view0_stream

    stream, starts, order, nt, gx, channels, config = view0_stream(sp)
    serve, pairs, cnt = _time_serving(torch, "learned view 0 (1024² inside)",
                                      stream, starts, order, nt, gx, channels,
                                      config)
    _log_tile_work("learned view 0", starts, order, cnt, config.chunk_size,
                   forward=True)
    return serve, pairs, stream.shape[0], (cnt, starts[1:] - starts[:-1])


def _bin_bound(entries, kept, ncols, bits):
    """(bound_ms, bytes) of one view's binning on this data, at the HBM
    bandwidth: the emit's (tile, rank) pairs written once (8 B per
    entry), each radix sort pass reading and writing them (CUB's 8-bit
    digits: ceil(bits / 8) passes), the stream rows written once, the
    kept entries' rank (4 B) and gidx_s (8 B) read once. Left out (so the
    bound is lower than the least time): the presort of the n depths, the
    rects the count and emit read, and the splat fields the rows
    gather."""
    passes = -(-bits // 8)
    nbytes = (entries * 8 + passes * entries * 16 + kept * ncols * 4
              + kept * 12)
    return nbytes / PEAK_BYTES * 1e3, nbytes


def _time_binning(torch, tag, prep, nt, gx, config):
    """``bin_sorted_stream`` on ``csrc/bin_stream.cu`` against
    ``bin_sorted_stream_plain`` on one view: every output bit-equal (the
    stream, starts, overflow, sorted ranks and presort permutation), then
    both timed in turns plain / kernel / kernel / plain (CUDA events over
    the whole binning, its host read of the emit size included), beside the
    bound by bytes. Returns the record for the kernels line."""
    from gpcr_tpu_torch.ops import rasterize as R
    from gpcr_tpu_torch.ops import rasterize_stream as RS

    with torch.no_grad():
        before = RS.LAUNCHES_BIN
        got = RS.bin_sorted_stream(prep, nt, gx, config, return_entries=True)
        torch.cuda.synchronize()
        check(RS.LAUNCHES_BIN == before + 1,
              f"{tag}: the binning did not run on the kernels")
        ref = RS.bin_sorted_stream_plain(prep, nt, gx, config,
                                         return_entries=True)
        check(bool(torch.equal(got[0].view(torch.int32),
                               ref[0].view(torch.int32))),
              f"{tag}: the kernels' stream differs from the plain version's")
        for name, g, r in zip(("starts", "overflow", "sorted ranks",
                               "presort"), got[1:], ref[1:]):
            check(g.dtype == r.dtype and bool(torch.equal(g, r)),
                  f"{tag}: the kernels' {name} differ from the plain "
                  "version's")
        entries = int(R.entry_count(prep, config))
        kept, ncols = got[0].shape
        del got, ref
        p1 = _event_ms(torch, lambda: RS.bin_sorted_stream_plain(
            prep, nt, gx, config), 3)
        k1 = _event_ms(torch, lambda: RS.bin_sorted_stream(
            prep, nt, gx, config), 20)
        k2 = _event_ms(torch, lambda: RS.bin_sorted_stream(
            prep, nt, gx, config), 20)
        p2 = _event_ms(torch, lambda: RS.bin_sorted_stream_plain(
            prep, nt, gx, config), 3)
        # device time per op of one kernel binning (torch.profiler, 5 calls)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                RS.bin_sorted_stream(prep, nt, gx, config)
            torch.cuda.synchronize()
    ops = sorted(((e.key[:48], e.device_time_total / 5e3)
                  for e in prof.key_averages() if e.device_time_total > 0),
                 key=lambda kv: -kv[1])
    log(f"[binning] {tag}: device ms per op of one kernel binning, "
        f"{sum(ms for _, ms in ops):.4f} in all: "
        + "; ".join(f"{k} {ms:.4f}" for k, ms in ops))
    bits = nt.bit_length()  # the sort's key bits, as the wrapper takes
    bound_ms, nbytes = _bin_bound(entries, kept, ncols, bits)
    log(f"[binning] {tag}: {prep.depth.shape[0]} splats, {entries} entries "
        f"emitted, {kept} kept, rows of {ncols} floats, {nt} tiles "
        f"({bits} key bits): kernels {k1:.4f} / {k2:.4f} ms, plain "
        f"{p1:.4f} / {p2:.4f} ms (CUDA events); bit-equal; bound "
        f"{bound_ms:.4f} ms by bytes ({nbytes} B at "
        f"{PEAK_BYTES / 1e12:.2f} TB/s)")
    return dict(ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=bound_ms,
                bound_by="bytes", splats=prep.depth.shape[0],
                entries=entries, kept=kept, tiles=nt, key_bits=bits)


def phase_binning(torch, sp):
    """The binning kernels at the learned view 0 (the 717,176-voxel cloud's
    splats, 4,096 tiles, dup cap 256) and at view 0 of the analytic
    headline (800K points, 2048² inside: 16,384 tiles, dup cap 4, k_budget
    1.8M): ``_time_binning`` at each."""
    from gpcr_tpu_torch.scripts import bench_matrix
    from gpcr_tpu_torch.utils.blend_inputs import bench_view0_prep, view0_prep

    prep, _, res = view0_prep(sp)
    check(prep.depth.shape[0] == LEARNED_VOXELS,
          f"the learned view 0 has {prep.depth.shape[0]} splats")
    gx = -(-res // 16)
    learned = _time_binning(torch, "learned view 0", prep, gx * gx, gx,
                            sp["config"])
    del prep
    coords, rgb = bench_matrix.make_cloud(800_000, 448)
    scene = bench_matrix.make_scene(coords, rgb, 448, 1024, 1024, 5)
    config = bench_matrix.raster_config(4, 1_800_000, 6144)
    prep, nt, gx, _, config = bench_view0_prep(scene, config)
    analytic = _time_binning(torch, "analytic headline view 0", prep, nt, gx,
                             config)
    return {"learned_view0": learned, "analytic_view0": analytic}


def phase_cell_binning(torch, RS):
    """One request of each benchmark cell through the cell's own program
    (``cellbench``'s seeded inputs, program and cameras, after one warm
    request), recorded under ``trace.recording()``: every view of the
    request preprocessed on ``csrc/preprocess.cu`` and binned on
    ``csrc/bin_stream.cu``, counted alike by ``LAUNCHES_PREP`` /
    ``LAUNCHES_BIN`` and by the request's ``prep_kernel_views`` /
    ``bin_kernel_views``. Returns, per cell, the views binned and the
    views preprocessed on the kernels in one request, and the arguments
    of the request's first ``preprocess_view`` (view 0)."""
    from cellbench import harness, scene, systems
    from gpcr_tpu_torch.ops import preprocess as P
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.utils import trace

    dev = torch.device("cuda")
    bins, preps, view0 = {}, {}, {}
    real = RD.preprocess_view
    for name in CELLS:
        cell = harness.load_cell(name)
        cfg, traffic = cell["config"], cell["traffic"]
        system = systems.load(cfg["renderer"])
        inputs = system.make_inputs(cfg, CELL_SEED, dev)
        prog = system.Program(cfg, traffic, inputs, dev)
        cams = scene.Cameras(traffic, CELL_SEED, dev)
        seen = []

        def spy(*args):
            if not seen:
                seen.append(args)
            return real(*args)

        with harness.quiet():
            prog(cams.warm(0), {})
            torch.cuda.synchronize()
            before = RS.LAUNCHES_BIN, P.LAUNCHES_PREP
            RD.preprocess_view = spy
            try:
                with trace.recording() as rec:
                    prog(cams.request(0), {})
                    torch.cuda.synchronize()
            finally:
                RD.preprocess_view = real
        launches = RS.LAUNCHES_BIN - before[0]
        prep_launches = P.LAUNCHES_PREP - before[1]
        counted = {k: {r: c[k] for r, c in rec.counters.items() if k in c}
                   for k in ("bin_kernel_views", "prep_kernel_views")}
        log(f"[cell-binning] {name}: a request of {traffic['views']} views "
            f"binned {launches} views on the kernels (LAUNCHES_BIN) and "
            f"preprocessed {prep_launches} on the kernel (LAUNCHES_PREP); "
            f"by request {counted}")
        views = traffic["views"]
        check(launches == prep_launches == views
              and counted == {"bin_kernel_views": {0: views},
                              "prep_kernel_views": {0: views}},
              f"{name}: {launches} kernel binnings, {prep_launches} kernel "
              f"preprocesses and counters {counted} in a request of {views} "
              "views")
        bins[name], preps[name], view0[name] = launches, prep_launches, seen[0]
        del prog, inputs
        torch.cuda.empty_cache()
    return bins, preps, view0


def _prep_bytes(args, prep):
    """Bytes one view's preprocess must move at the least: each input byte
    the kernel reads once (one row of a stride-0 input; opacity only for
    opacity-aware rects; the SH rows the degree needs), each output byte
    written once."""
    settings, means, scales, rots, op, shs, normal, valid, config, wn = args
    n = means.shape[0]
    per = 12 + 12 + (3 * 4 * (settings.sh_degree + 1) ** 2)
    per += 4 * config.opacity_radius + 12 * wn + (valid is not None)
    read = n * per + 16 * (n if rots.stride(0) else 1)
    written = sum(t.numel() * t.element_size() for t in prep[:7])
    return read + written


def phase_preprocess(torch, view0):
    """The preprocess kernel at view 0 of each benchmark cell (the
    arguments its program passed, ``phase_cell_binning``) against the
    plain ops (``fuse_view_features`` then ``preprocess``): every field
    bit-equal; both timed in turns plain / kernel / kernel / plain (CUDA
    events over the whole call), the kernel's device time
    (``torch.profiler``, 5 calls), beside the bound by bytes. Returns the
    records for the kernels line, by cell."""
    from torch.profiler import ProfilerActivity, profile

    from gpcr_tpu_torch.ops import preprocess as P
    from gpcr_tpu_torch.ops import rasterize as R

    got = {}
    for name, args in view0.items():
        (settings, means, scales, rots, op, shs, normal, valid, config,
         with_normal) = args

        def kernel():
            return P.preprocess_view(*args)

        def plain():
            feats = P.fuse_view_features(settings.campos, means, shs, normal,
                                         settings.sh_degree, with_normal)
            return R.preprocess(means, op, settings, config, scales=scales,
                                rotations=rots, colors_precomp=feats,
                                valid_mask=valid)

        with torch.no_grad():
            before = P.LAUNCHES_PREP
            k = kernel()
            torch.cuda.synchronize()
            check(P.LAUNCHES_PREP == before + 1,
                  f"{name}: the preprocess did not run on the kernel")
            p = plain()
            for field, a, b in zip(k._fields, k, p):
                a, b = a.contiguous(), b.contiguous()
                if a.dtype == torch.float32:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                check(a.dtype == b.dtype and bool(torch.equal(a, b)),
                      f"{name}: the kernel's {field} differs from the plain "
                      "ops'")
            nbytes = _prep_bytes(args, k)
            del k, p
            p1 = _event_ms(torch, plain, 3)
            k1 = _event_ms(torch, kernel, 20)
            k2 = _event_ms(torch, kernel, 20)
            p2 = _event_ms(torch, plain, 3)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    kernel()
                torch.cuda.synchronize()
        device_ms = sum(e.device_time_total for e in prof.key_averages()
                        if "preprocess_kernel" in e.key) / 5e3
        bound_ms = nbytes / PEAK_BYTES * 1e3
        n = means.shape[0]
        log(f"[preprocess] {name} view 0: {n} splats, C = "
            f"{12 if with_normal else 9}, SH degree {settings.sh_degree} of "
            f"{shs.shape[1]} coefficients, {settings.image_width}²: kernel "
            f"{k1:.4f} / {k2:.4f} ms (device {device_ms:.4f}), plain "
            f"{p1:.4f} / {p2:.4f} ms (CUDA events); every field bit-equal; "
            f"bound {bound_ms:.4f} ms by bytes ({nbytes} B at "
            f"{PEAK_BYTES / 1e12:.2f} TB/s)")
        got[name] = dict(ms=min(k1, k2), device_ms=device_ms,
                         plain_ms=min(p1, p2), bound_ms=bound_ms,
                         bound_by="bytes", splats=n)
    return got


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


def phase_timing_aligned(torch, sp, pairs, entries, work):
    """Kernel 4 at the learned view-0 shape (the same entries as kernel 1's
    timing, full-size output), in turns plain / kernel / kernel / plain.
    ``pairs`` are kernel 1's (walked, live) counts on these ``entries``:
    the walk is the same, and padding slots are no work the data needs;
    ``work`` is the contributor count and the entries per tile of the same
    stream, for the layout's ``[tile-work]`` line."""
    from gpcr_tpu_torch.utils.blend_inputs import aligned_work, view0_prep
    from gpcr_tpu_torch.ops import rasterize_aligned as RA

    prep, channels, res = view0_prep(sp)
    config = sp["config"]
    gx = -(-res // 16)
    nt = gx * gx
    mx, mean, args, _ = _compare_aligned(torch, prep, nt, gx, channels, config)
    check(mx <= MAX_ERR and mean <= MEAN_ERR, "aligned kernel disagrees with "
          f"plain at the learned view-0 shape: {mx} / {mean}")
    cstarts, scal, feat = args[:3]
    w = aligned_work(cstarts, *work, config.chunk_size)
    d = " / ".join(f"{w[k]['max']} / {w[k]['p99']:.0f} / {w[k]['median']:.0f}"
                   for k in ("chunks", "walked_chunks"))
    log(f"[tile-work] aligned learned view 0: {w['tiles']} non-empty tiles, "
        f"{w['empty_tiles']} empty (launched last); chunks per tile and "
        f"walked per tile (max / p99 / median) {d}; {w['stopped_share']:.3f} "
        "of the walked (slot, pixel) pairs belong to pixels already stopped")
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
# data preparation and evaluation
# --------------------------------------------------------------------------


def _same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _min_dist_at_least(torch, xyz, bound):
    """True when no two points of ``xyz`` (a tensor on the card) lie
    closer than ``bound``: a radius-``bound`` outlier pass (a grid of
    ``bound`` cells, 27 neighbours each) must find every point alone."""
    from gpcr_tpu_torch.structures.pointcloud import PointCloud

    alone = PointCloud(xyz_w=xyz[None]).remove_outlier(bound, min_neighbors=1)
    return int(alone.get_num_valid_points(0)) == 0


def _render_traj(B, RS, traj, root, tag, common):
    """``simple --skip_mesh`` on a trajectory saved as a camera file (the
    CLI resamples it to its 12 views of 512²); returns (rgb, launches)."""
    cam_path = os.path.join(WORK, "pipeline_out", f"{tag}.npz")
    os.makedirs(os.path.dirname(cam_path), exist_ok=True)
    traj.get_camera(fov=45.0, width_px=512, height_px=512).save(cam_path)
    RS.LAUNCHES = 0
    out, _ = B.main(["simple", *common(root, tag), "--skip_mesh",
                     "--cam_mode", "file", "--cam_json", cam_path])["0001"]
    return out["rgb"], RS.LAUNCHES


def phase_pipeline(torch, B, RS, ckpt, scored):
    """From a mesh to a scored render through the data-preparation tools:
    preprocess_obj, sample_pcd (three methods), the native PLY reader, the
    voxel <-> world round trip, ``simple --down_sample_ratio``, pcrender
    on the round-tripped cloud, pipeline scoring, manual / spiral
    trajectories, the z-buffer against the ray caster, tiled views."""
    import numpy as np

    from gpcr_tpu_torch import native_bindings as NB
    from gpcr_tpu_torch.cli import pipeline as PL
    from gpcr_tpu_torch.cli import sample_pcd as SP
    from gpcr_tpu_torch.io import read_png, write_png
    from gpcr_tpu_torch.io import ply as PLY
    from gpcr_tpu_torch.structures.mesh import Mesh
    from gpcr_tpu_torch.structures.pointcloud import PointCloud
    from gpcr_tpu_torch.structures.trajectory import CameraTrajectory
    from gpcr_tpu_torch.utils import media
    from gpcr_tpu_torch.utils.preprocess_obj import preprocess_obj

    src = os.path.join(WORK, "scored_ds", "0001")
    root = os.path.join(WORK, "pipeline_ds")
    asset = os.path.join(root, "0001")
    rpth = os.path.join(WORK, "pipeline_out") + "/"

    def common(r, tag):
        return ["--id_list", "0001", "--dataset_root", r,
                "--rpth", rpth + tag + "/", "--voxelized",
                "--scale_factor", "448", "--fov", "45",
                "--background_color", "1", "--device", "cuda"]

    # 1. preprocess the asset into a new dataset root
    obj = preprocess_obj(os.path.join(src, "0001.obj"), asset)
    check(sorted(os.listdir(asset)) == ["0001.obj", "mat.mtl", "tex.png"],
          f"preprocess_obj wrote {sorted(os.listdir(asset))}")

    # 2. sample it with three methods
    runs = (("uniform_quantized", 1_300_000, "pcd_0.ply"),
            ("poisson_disk", POISSON_POINTS, "pcd_poisson.ply"),
            ("uniform_camera", 800_000, "pcd_camera.ply"))
    counts = {}
    for method, n, name in runs:
        t0 = time.time()
        written = SP.main(["--dataset_root", root, "--id_list", "0001",
                           "--method", method, "--num_points", str(n),
                           "--out_name", name, "--workers", "1",
                           "--device", "cuda"])
        sec = time.time() - t0
        path = os.path.join(asset, name)
        check(written == [path], f"sample_pcd {method} wrote {written}")
        counts[method] = len(PLY.read_ply(path)["xyz"])
        log(f"[pipeline] sample_pcd {method} --num_points {n}: "
            f"{counts[method]} points in {sec:.2f} s")
    check(_same_bytes(os.path.join(asset, "pcd_0.ply"),
                      os.path.join(src, "pcd_0.ply")),
          "sample_pcd uniform_quantized differs from the scored cloud")
    check(counts["poisson_disk"] == POISSON_POINTS,
          f"poisson_disk gave {counts['poisson_disk']} points")
    check(300_000 <= counts["uniform_camera"] <= 2_700_000,
          f"uniform_camera gave {counts['uniform_camera']} points")
    mesh = Mesh(obj, scale=1.0)
    tri = mesh.vertices[mesh.triangles]
    area = 0.5 * float(np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0],
                                               tri[:, 2] - tri[:, 0]),
                                      axis=-1).sum())
    bound = 0.5 * np.sqrt(area / (2.0 * np.sqrt(3.0) * POISSON_POINTS))
    poisson = PLY.read_ply(os.path.join(asset, "pcd_poisson.ply"))["xyz"]
    check(_min_dist_at_least(torch, torch.from_numpy(poisson).cuda(), bound),
          f"poisson_disk has two points closer than {bound:.3e}")
    log(f"[pipeline] poisson_disk: no two of {len(poisson)} points closer "
        f"than 0.5 r_max = {bound:.4e} (grid-checked on the card)")

    # 3. the PLY readers on the 875K-point cloud
    cloud_path = os.path.join(asset, "pcd_0.ply")
    check(NB.get_ply_parser() is not None, "the native PLY parser is missing")
    times = {}
    for tag, read in (("native", NB.read_ply_native),
                      ("python", PLY.read_ply_python)):
        spans = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = read(cloud_path)
            spans.append(time.perf_counter() - t0)
        times[tag] = (min(spans), got)
    nat, py = times["native"][1], times["python"][1]
    check(sorted(nat) == sorted(py) and all(
        np.array_equal(nat[k], py[k]) for k in py),
        "the native PLY parser and the Python reader disagree")
    log(f"[pipeline] PLY read of {len(py['xyz'])} points (best of 3): native "
        f"{times['native'][0] * 1e3:.2f} ms, Python "
        f"{times['python'][0] * 1e3:.2f} ms; arrays equal")

    # 4. voxel -> world -> voxel, as a PCC codec round trip does
    rt_root = os.path.join(WORK, "pipeline_rt")
    rt_asset = os.path.join(rt_root, "0001")
    os.makedirs(rt_asset)
    for name in ("0001.obj", "mat.mtl", "tex.png"):
        shutil.copy(os.path.join(asset, name), rt_asset)
    world = os.path.join(WORK, "pipeline_out", "world.ply")
    os.makedirs(os.path.dirname(world), exist_ok=True)
    PL.rescale_run(cloud_path, world, 448)
    PL.scale_run(world, os.path.join(rt_asset, "pcd_0.ply"), 448)
    back = PLY.read_ply(os.path.join(rt_asset, "pcd_0.ply"))
    rt_err = float(np.abs(back["xyz"] + 512.0 - py["xyz"]).max())
    check(rt_err <= 1e-3 and np.array_equal(back["rgb"], py["rgb"]),
          f"the round trip moved xyz by {rt_err} or changed rgb")
    log(f"[pipeline] rescale_run / scale_run at factor 448: max |xyz + 512 - "
        f"original| {rt_err:.3e}, rgb equal")

    # 5. simple --down_sample_ratio on the card, scored against the mesh
    pcd = PointCloud.from_ply(cloud_path, device="cuda")
    down = pcd.voxel_downsampling(cell_width=2.0)
    ms = _event_ms(torch, lambda: pcd.voxel_downsampling(cell_width=2.0), 5)
    pcd_cpu = pcd.to("cpu")
    t0 = time.perf_counter()
    for _ in range(3):
        down_cpu = pcd_cpu.voxel_downsampling(cell_width=2.0)
    cpu_ms = (time.perf_counter() - t0) / 3 * 1e3
    n_down = int(down.get_num_valid_points(0))
    check(torch.equal(down.valid_mask.cpu(), down_cpu.valid_mask),
          "voxel_downsampling: the card's cells differ from the CPU's")
    vox_err = max(float((getattr(down, k).cpu() - getattr(down_cpu, k))
                        .abs().max()) for k in ("xyz_w", "rgb", "normal_w"))
    check(vox_err <= 1e-5, f"voxel_downsampling card vs CPU: {vox_err}")
    RS.LAUNCHES = 0
    out, timing = B.main(["simple", *common(root, "down"),
                          "--down_sample_ratio", "0.5"])["0001"]
    launches = RS.LAUNCHES
    s = timing["scores"]
    log(f"[pipeline] voxel_downsampling (cell width 2) of {pcd.get_num_points()}"
        f" points: {n_down} cells, {ms:.3f} ms on the card (CUDA events, "
        f"mean of 5), {cpu_ms:.1f} ms on the CPU (host clock, mean of 3), "
        f"card vs CPU max |d| {vox_err:.2e}; simple --down_sample_ratio 0.5: "
        f"PSNR {s['psnr']:.4f} dB, MS-SSIM {s['msssim']:.6f}, ground truth "
        f"{timing['gt_time']:.2f} s, blend kernel launches {launches}")
    check(launches > 0, "simple --down_sample_ratio launched no blend kernel")
    check(s["psnr"] >= SIMPLE_PSNR_FLOOR,
          f"downsampled simple scores {s['psnr']} dB")

    # 6. pcrender on the round-tripped cloud (voxel coordinates - 512,
    # hence --input_offset 512)
    RS.LAUNCHES = 0
    out, timing = B.main(["pcrender", "--ckpt", ckpt, "--dup_cap",
                          str(DUP_CAP), *common(rt_root, "rt"),
                          "--input_offset", "512,512,512"])["0001"]
    s = timing["scores"]
    d_psnr = s["psnr"] - scored["pcrender"]["psnr"]
    log(f"[pipeline] pcrender on the round-tripped cloud: PSNR "
        f"{s['psnr']:.4f} dB ({d_psnr:+.4f} against the original cloud), "
        f"MS-SSIM {s['msssim']:.6f}, dup_overflow {timing['dup_overflow']}, "
        f"blend kernel launches {RS.LAUNCHES}")
    check(RS.LAUNCHES > 0 and timing["dup_overflow"] == 0,
          "pcrender on the round-tripped cloud")
    check(abs(d_psnr) <= 0.1, f"the round trip moved pcrender by {d_psnr} dB")

    # 7. the pipeline's scorers on the same directories
    render_dir = rpth + "rt/0001_pcrender"
    gt_dir = rpth + "rt/0001_mesh_gt"
    ev = PL.evaluate_pair(render_dir, gt_dir, device="cuda")
    check(ev["psnr"] == s["psnr"] and ev["ms_ssim"] == s["msssim"]
          and ev["lpips"] is None,
          f"evaluate_pair gives {ev}, the CLI {s}")
    gt = np.stack([read_png(os.path.join(gt_dir, f"rgb_{i}.png"))
                   for i in range(12)])[None].astype(np.float32) / 255.0
    diff_dir = rpth + "rt_diff"
    PL.save_difference_map(gt, out["rgb"], diff_dir)
    n_diff = len(os.listdir(os.path.join(diff_dir, "diff")))
    check(n_diff == 12, f"save_difference_map wrote {n_diff} PNGs")
    log(f"[pipeline] evaluate_pair equals the CLI's scores (LPIPS skipped: "
        f"no weights); save_difference_map wrote {n_diff} PNGs")

    # 8. manual and spiral trajectories, the z-buffer, RGBD unprojection
    traj = CameraTrajectory("manual", n_imgs=4, total=1,
                            params={"eye": MANUAL_EYES}, device="cuda")
    spiral = CameraTrajectory.get_spiral_trajectory(traj.cam_poses, 4, 0.2)
    for tag, t in (("manual", traj), ("spiral", spiral)):
        rgb, n = _render_traj(B, RS, t, root, tag, common)
        check(n > 0 and bool(torch.isfinite(rgb).all())
              and tuple(rgb.shape) == (1, 12, 512, 512, 3),
              f"{tag} trajectory: {n} launches, shape {tuple(rgb.shape)}")
        cover = float(((rgb - 1.0).abs() > 1e-3).any(-1).float().mean())
        log(f"[pipeline] {tag} trajectory through simple: 12 views, blend "
            f"kernel launches {n}, coverage {cover:.4f}")
        check(cover > 0.01, f"{tag} trajectory shows nothing")
    cam = traj.get_camera(fov=45.0, width_px=512, height_px=512)
    cam = dataclasses.replace(cam, H_c2w=cam.H_c2w[:, :1],
                              intrinsic=cam.intrinsic[:, :1])
    spans = {}
    for method in ("ray_cast", "rasterization"):
        t0 = time.time()
        spans[method] = (mesh.get_rgbd_image(cam, render_method=method),
                         time.time() - t0)
    rc, rs = spans["ray_cast"][0], spans["rasterization"][0]
    h1, h2 = rc.hit_map.cpu() > 0.5, rs.hit_map.cpu() > 0.5
    both = h1 & h2
    rim = float((h1 ^ h2).float().mean())
    d_err = float((rc.depth.cpu()[both] - rs.depth.cpu()[both]).abs().max())
    c_err = float((rc.rgb.cpu()[both] - rs.rgb.cpu()[both]).abs().max())
    n_err = float((rc.normal_w.cpu()[both] - rs.normal_w.cpu()[both])
                  .abs().max())
    log(f"[pipeline] one 512² view: ray cast {spans['ray_cast'][1]:.2f} s, "
        f"z-buffer {spans['rasterization'][1]:.2f} s (host); hit "
        f"{float(h1.float().mean()):.4f}, silhouette disagreement {rim:.5f}, "
        f"max |d| depth {d_err:.2e}, rgb {c_err:.2e}, normal {n_err:.2e}")
    check(rim < 0.02 and d_err <= 1e-3 and c_err < 2e-2 and n_err <= 1e-4,
          "the z-buffer disagrees with the ray caster")
    pc_gpu = rc.get_pcd()
    pc_cpu = dataclasses.replace(rc, camera=rc.camera.to("cpu"),
                                 rgb=rc.rgb.cpu(), depth=rc.depth.cpu(),
                                 normal_w=rc.normal_w.cpu(),
                                 hit_map=rc.hit_map.cpu()).get_pcd()
    mask = pc_cpu.valid_mask
    check(pc_gpu.device.type == "cuda"
          and torch.equal(pc_gpu.valid_mask.cpu(), mask),
          "get_pcd on the card: another valid mask")
    pcd_err = max(float((torch.where(mask, getattr(pc_gpu, k).cpu(), 0.0)
                         - torch.where(mask, getattr(pc_cpu, k), 0.0))
                        .abs().max())
                  for k in ("xyz_w", "captured_view_direction_w"))
    log(f"[pipeline] get_pcd on the card vs the CPU: {int(mask.sum())} "
        f"points, max |d| {pcd_err:.2e}")
    check(pcd_err <= 1e-5, f"get_pcd card vs CPU: {pcd_err}")

    # 9. the 12 round-tripped views, titled and tiled
    views = out["rgb"][0].cpu().numpy()
    sheet = media.tile_images([media.add_title_to_image(v, f"VIEW {i}")
                               for i, v in enumerate(views)])
    sheet_path = rpth + "views.png"
    write_png(sheet_path, sheet)
    check(sheet.shape == (3 * (512 + 24) + 4, 4 * 512 + 6, 3)
          and read_png(sheet_path).shape == sheet.shape,
          f"tiled sheet has shape {sheet.shape}")
    log(f"[pipeline] 12 views titled and tiled into a {sheet.shape[1]}x"
        f"{sheet.shape[0]} PNG")


# --------------------------------------------------------------------------
# structures and utilities
# --------------------------------------------------------------------------


def _ring_camera(torch, n, res, centre, radius, dev):
    """``n`` look-at views of ``res``² (fov 45) on a circle of ``radius``
    around ``centre`` (0.2 radius above it), view 0 on the +x side."""
    from gpcr_tpu_torch.structures.camera import Camera, derive_camera_intrinsics
    from gpcr_tpu_torch.utils import rigid_motion as RM

    ang = torch.arange(n, dtype=torch.float64) * (2 * math.pi / n)
    c = torch.tensor(centre, dtype=torch.float64)
    eyes = torch.stack([c[0] + radius * torch.cos(ang),
                        torch.full_like(ang, float(c[1]) + 0.2 * radius),
                        c[2] + radius * torch.sin(ang)], -1).float()
    H = RM.get_H_c2w_lookat(eyes.to(dev), c.float().expand(n, 3).to(dev),
                            torch.tensor([[0.0, 1.0, 0.0]], device=dev).expand(n, 3))
    K = derive_camera_intrinsics(res, res, 45.0, device=dev)
    return Camera(H_c2w=H[None], intrinsic=K.expand(1, n, 3, 3), width_px=res,
                  height_px=res)


def _knn_agree(idx_a, d_a, idx_b, d_b, compare, tol):
    """Slots of two k-nearest answers (rows sorted by distance) where
    ``compare`` holds: distances within ``tol`` and indices equal, except
    where the distance ties (within ``tol``) with a neighbouring slot of its
    row, which either answer may order either way. Returns (slots
    compared, tie swaps, max |d|) and fails on any other difference."""
    import numpy as np

    err = float(np.abs(d_a - d_b)[compare].max()) if compare.any() else 0.0
    check(err <= tol, f"k-nearest distances differ by {err} (limit {tol})")
    tie = np.zeros_like(compare)
    gap = np.abs(np.diff(d_a, axis=-1)) <= tol
    tie[..., 1:] |= gap
    tie[..., :-1] |= gap
    tie[..., -1] = True  # the k-th place may tie with the (k+1)-th
    differ = compare & (idx_a != idx_b)
    check(not (differ & ~tie).any(),
          f"k-nearest indices differ at {int((differ & ~tie).sum())} slots "
          "that tie with no other")
    return int(compare.sum()), int(differ.sum()), err


def _edge_counts(f):
    import numpy as np

    f = np.asarray(f)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [0, 2]]]), 1)
    return np.unique(e, axis=0, return_counts=True)[1]


def _golden_view(torch, dev, debug, nan_at=None):
    """View 0 of the golden ``simple`` render (12 circle views, 512² x2) as
    one ``rasterize_gaussians`` call with ``settings.debug``, the CLI's
    raster config and the x2 downscale folded into the blend as
    ``render_views_fused`` does; with ``nan_at`` that gaussian's mean is
    NaN. Returns a function that renders it: the (9, 512, 512) image."""
    from gpcr_tpu_torch.io import read_ply
    from gpcr_tpu_torch.ops import preprocess as P
    from gpcr_tpu_torch.ops import rasterize as R
    from gpcr_tpu_torch.render import renderer as RD
    from gpcr_tpu_torch.utils import sh as sh_utils

    golden = os.path.join(HERE, "tests", "golden")
    with open(os.path.join(golden, "manifest.json")) as f:
        m = json.load(f)
    cloud = read_ply(os.path.join(golden, "pcd_0.ply"))
    xyz = torch.from_numpy(cloud["xyz"]).to(dev)
    rgb = torch.from_numpy(cloud["rgb"]).to(dev)
    n, sf = xyz.shape[0], m["scale_factor"]
    cam = RD.generate_cam({"fov": m["fov"], "width_px": 512, "height_px": 512,
                           "mode": "circle", "n_imgs": 12, "d": 0, "r": 3,
                           "center_angles": [90, 0], "alt_yaxis": False},
                          device=dev)
    means = RD.pcgc_rescale(xyz, 512, sf)
    if nan_at is not None:
        means[nan_at, 0] = float("nan")
    shs = torch.cat([sh_utils.RGB2SH(rgb)[:, None, :],
                     torch.zeros((n, 12, 3), device=dev)], dim=1)
    bg3 = torch.ones((3,), device=dev)
    rp = RD.get_rasterize_param_from_camera(cam, m["fov"], bg=bg3, sh_degree=1,
                                            super_sample_rate=2)
    feats = P.fuse_view_features(rp["campos"][0], means, shs,
                                 torch.zeros_like(means), 1, False)
    bg = P.view_background(bg3, False)
    settings = R.GaussianRasterizationSettings(
        image_height=rp["height"], image_width=rp["width"],
        tanfovx=rp["tanfov"], tanfovy=rp["tanfov"], bg=bg, scale_modifier=1.0,
        viewmatrix=rp["view_t"][0], projmatrix=rp["full_t"][0], sh_degree=1,
        campos=rp["campos"][0], debug=debug)
    config = R.RasterizeConfig(max_dup_per_gaussian=16, chunk_size=256,
                               opacity_radius=True, downscale=2)
    kw = dict(scales=torch.ones((n, 3), device=dev) * (m["sigma"] / sf),
              rotations=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
              .expand(n, 4), colors_precomp=feats, config=config)
    opacity = torch.ones((n,), device=dev)
    return lambda: R.rasterize_gaussians(means, opacity, settings, **kw)[0]


def phase_tools(torch, RS):
    """The structures and utilities of the port on the card at the size
    their users run them: the surfel z-buffer, ray-point geometry against
    ``GridRayQuery``, sparse trilinear interpolation and pruning, meshing,
    ``remesh_file``, Camera slicing and frame meshes, PointersectRecord,
    vMF sampling, ColorCorrector, and the rasterizer's ``debug`` flag under
    ``utils/debug.trace``; each device function against the CPU."""
    import numpy as np
    from scipy.spatial import cKDTree

    from gpcr_tpu_torch import native_bindings as NB
    from gpcr_tpu_torch.cli.profile_pcrender import synthetic_cloud
    from gpcr_tpu_torch.io import read_png
    from gpcr_tpu_torch.ops import sparse as TSP
    from gpcr_tpu_torch.structures import mesh as TM
    from gpcr_tpu_torch.structures.camera import Camera
    from gpcr_tpu_torch.structures.color_corrector import ColorCorrector
    from gpcr_tpu_torch.structures.pointcloud import PointCloud
    from gpcr_tpu_torch.structures.pointersect_record import PointersectRecord
    from gpcr_tpu_torch.structures.ray import Ray
    from gpcr_tpu_torch.utils import debug as DBG
    from gpcr_tpu_torch.utils import geometry as G
    from gpcr_tpu_torch.utils import sampling as SMP
    from gpcr_tpu_torch.utils.timing import timed

    dev = torch.device("cuda")
    cpu = torch.device("cpu")
    stats = {}
    src = os.path.join(WORK, "scored_ds", "0001")
    out_dir = os.path.join(WORK, "tools_out")
    os.makedirs(out_dir, exist_ok=True)
    pcd = PointCloud.from_ply(os.path.join(src, "pcd_0.ply"), device=dev)
    pcd_cpu = pcd.to(cpu)
    n_pts = pcd.get_num_points()
    xyz_np = pcd_cpu.xyz_w[0].numpy()
    lo, hi = xyz_np.min(0), xyz_np.max(0)
    centre = ((lo + hi) / 2).tolist()
    radius = 3.2 * float((hi - lo).max()) / 2

    # 1. the surfel z-buffer: 12 views, raw; one view each of the shadings
    cam = _ring_camera(torch, TOOL_VIEWS, TOOL_RES, centre, radius, dev)
    res_ = TOOL_RES
    surf = pcd.rasterize_surfel(cam)
    check(tuple(surf.rgb.shape) == (1, TOOL_VIEWS, res_, res_, 3)
          and surf.rgb.is_cuda and bool(torch.isfinite(surf.rgb).all()),
          "surfel render")
    hit = float(surf.hit_map.mean())
    check(0.05 < hit < 0.9, f"surfel hit fraction {hit}")
    stats["surfel_ms_per_view"] = _event_ms(
        torch, lambda: pcd.rasterize_surfel(cam), 3) / TOOL_VIEWS
    one = cam.index_select(1, [0])
    for shading in ("directional", "half"):
        img = pcd.rasterize_surfel(one, shading=shading)
        check(bool(torch.isfinite(img.rgb).all()), f"surfel {shading}")
        stats[f"surfel_{shading}_ms"] = _event_ms(
            torch, lambda: pcd.rasterize_surfel(one, shading=shading), 3)
    two = cam.index_select(1, [0, 1])
    want = pcd_cpu.rasterize_surfel(two.to(cpu))
    got_hit, got_rgb = surf.hit_map[:, :2].cpu(), surf.rgb[:, :2].cpu()
    same = (got_hit == want.hit_map) & (got_rgb == want.rgb).all(-1)
    # pixels a point falls on in one device's projection and not in the
    # other's (floor(uv) rounded across a pixel edge): there the nearest z
    # itself may differ; elsewhere only the winner inside the 1e-6 tie
    # window may (the PLY's 8-bit colours repeat, so equal colours do not
    # show the same winner, and depth is held pixel by pixel)
    moved = torch.zeros(got_hit.shape, dtype=torch.bool)
    n_moved = 0
    for v in range(2):
        pix = []
        for x, K, H in ((pcd.xyz_w[0], cam.intrinsic[0, v], cam.H_c2w[0, v]),
                        (pcd_cpu.xyz_w[0], two.intrinsic[0, v].cpu(),
                         two.H_c2w[0, v].cpu())):
            pr = G.pinhole_projection(x[None], K[None], H[None])
            px = torch.floor(pr["uv"][0, :, 0]).long()
            py = torch.floor(pr["uv"][0, :, 1]).long()
            ok = (pr["in_front"][0] & (px >= 0) & (px < res_) & (py >= 0)
                  & (py < res_))
            pix.append(torch.where(ok, py * res_ + px, -1).cpu())
        diff = pix[0] != pix[1]
        n_moved += int(diff.sum())
        touched = torch.cat([pix[0][diff], pix[1][diff]])
        touched = touched[touched >= 0]
        moved[0, v].view(-1)[touched] = True
    kept = ~moved
    both = kept & (want.hit_map > 0.5)
    d_rel = float(((surf.depth[:, :2].cpu() - want.depth).abs()
                   / want.depth)[both].max())
    stats["surfel_same_share"] = float(same.float().mean())
    stats["surfel_pixels_differ"] = int((~same).sum())
    stats["surfel_points_moved"] = n_moved
    stats["surfel_depth_rel_err"] = d_rel
    log(f"[tools] rasterize_surfel of {n_pts} points, {TOOL_VIEWS} views "
        f"{res_}²: {stats['surfel_ms_per_view']:.3f} ms per view (raw), "
        f"directional {stats['surfel_directional_ms']:.3f} ms, half "
        f"{stats['surfel_half_ms']:.3f} ms per view; hit {hit:.4f}; card vs "
        f"CPU on 2 views: {stats['surfel_pixels_differ']} of {same.numel()} "
        f"pixels differ in hit or colour; {n_moved} points fall on another "
        f"pixel (floor(uv) rounded across an edge), touching "
        f"{int(moved.sum())} pixels; elsewhere hits equal and depth max rel "
        f"|d| {d_rel:.2e}")
    check(stats["surfel_same_share"] >= 0.999,
          f"surfel card vs CPU: {stats['surfel_same_share']} of pixels agree")
    check(torch.equal(got_hit[kept], want.hit_map[kept]) and d_rel <= 1e-5,
          f"surfel card vs CPU away from moved points: depth {d_rel}")

    # 2. ray-point geometry on the rays of one view
    cam_k = _ring_camera(torch, 1, KNN_RES, centre, radius, dev)
    o, d = cam_k.generate_camera_rays()
    o, d = o.reshape(1, -1, 3), d.reshape(1, -1, 3)
    m_rays = o.shape[1]
    kw = dict(k=8, chunk_rays=KNN_CHUNK)
    knn = G.get_k_neighbor_points_in_chunks(pcd.xyz_w, o, d, **kw)  # warm
    stats["knn_ms"] = _event_ms(
        torch, lambda: G.get_k_neighbor_points_in_chunks(pcd.xyz_w, o, d, **kw),
        1, warmup=0)
    b_idx = knn["sorted_idxs"][0].cpu().numpy()
    b_d = knn["sorted_dists"][0].cpu().numpy()
    t0 = time.perf_counter()
    grid = NB.GridRayQuery(xyz_np, cell_size=2.0)
    g_idx, g_d, _ = grid.query(o[0].cpu().numpy(), d[0].cpu().numpy(), k=8,
                               radius=2.0)
    stats["grid_query_s"] = time.perf_counter() - t0
    inside = b_d <= 2.0 - 1e-5
    n_cmp, n_swap, g_err = _knn_agree(b_idx, b_d, g_idx, g_d, inside, 1e-4)
    outside_ok = (g_idx[~inside] == -1) | (g_d[~inside] > 2.0 - 1e-4)
    check(outside_ok.all(), "GridRayQuery reports a point beyond the radius")
    surf_k = pcd.rasterize_surfel(cam_k).hit_map[0, 0].cpu().numpy() > 0.5
    cover = float(inside.any(-1)[surf_k.reshape(-1)].mean())
    check(cover >= KNN_COVER, f"{cover} of the rays whose surfel render hits "
          f"have a point within the radius (at least {KNN_COVER})")
    # card vs CPU at 1e-4 as against the grid: in voxel units the points lie
    # ~1e3 from the origin, where a float32 step is 6e-5
    c = KNN_CPU_RAYS
    knn_cpu = G.get_k_neighbor_points_in_chunks(
        pcd_cpu.xyz_w, o[:, :c].cpu(), d[:, :c].cpu(), **kw)
    c_cmp, c_swap, c_err = _knn_agree(
        b_idx[:c], b_d[:c], knn_cpu["sorted_idxs"][0].numpy(),
        knn_cpu["sorted_dists"][0].numpy(), np.isfinite(b_d[:c]), 1e-4)
    stats.update(knn_slots_vs_grid=n_cmp, knn_hit_rays_covered=cover,
                 knn_tie_swaps_vs_grid=n_swap,
                 knn_err_vs_grid=g_err, knn_slots_vs_cpu=c_cmp,
                 knn_tie_swaps_vs_cpu=c_swap, knn_err_vs_cpu=c_err)
    log(f"[tools] get_k_neighbor_points_in_chunks (k 8, {KNN_CHUNK} "
        f"rays per chunk): {m_rays} rays x {n_pts} points in "
        f"{stats['knn_ms']:.2f} ms on the card; GridRayQuery (radius 2) "
        f"{stats['grid_query_s']:.3f} s on the host (build + query): "
        f"{n_cmp} slots within the radius, {cover:.4f} of the "
        f"{int(surf_k.sum())} rays whose surfel render hits have one; "
        f"{n_swap} swapped ties, max |d| "
        f"{g_err:.2e}; card vs CPU on {c} rays: {c_cmp} slots, {c_swap} "
        f"swapped ties, max |d| {c_err:.2e}")
    near = torch.from_numpy(b_idx[:, 0]).to(dev)
    hit_ray = torch.from_numpy(np.isfinite(b_d[:, 0])).to(dev)
    pts = pcd.xyz_w[0][near[hit_ray]][None]
    K1, H1 = cam.intrinsic[:, 1], cam.H_c2w[:, 1]
    proj = G.pinhole_projection(pts, K1, H1)
    corr = G.find_corresponding_uv(pts, K1, H1, res_, res_)
    samp = G.uv_sampling(surf.rgb[0, 1], corr["uv"][0])
    zd = G.compute_3d_zdir_and_dps(surf.depth[0, 0], cam.intrinsic[0, 0],
                                   cam.H_c2w[0, 0])
    stats["geometry_ms"] = _event_ms(torch, lambda: (
        G.pinhole_projection(pts, K1, H1),
        G.find_corresponding_uv(pts, K1, H1, res_, res_),
        G.uv_sampling(surf.rgb[0, 1], corr["uv"][0]),
        G.compute_3d_zdir_and_dps(surf.depth[0, 0], cam.intrinsic[0, 0],
                                  cam.H_c2w[0, 0])), 5)
    pts_c, K1c, H1c = pts.cpu(), K1.cpu(), H1.cpu()
    proj_c = G.pinhole_projection(pts_c, K1c, H1c)
    corr_c = G.find_corresponding_uv(pts_c, K1c, H1c, res_, res_)
    uv_c = corr_c["uv"]
    rel = max(float((proj[k].cpu() - proj_c[k]).abs().max()
                    / proj_c[k].abs().max()) for k in ("uv", "z"))
    uvx = uv_c[0]
    edge = ((uvx.abs() < 1e-3) | ((uvx - res_).abs() < 1e-3)).any(-1)
    mism = (corr["valid"][0].cpu() != corr_c["valid"][0])
    check(not (mism & ~edge).any(), "find_corresponding_uv masks differ")
    s_err = float((samp.cpu() - G.uv_sampling(surf.rgb[0, 1].cpu(),
                                              corr["uv"][0].cpu())).abs().max())
    zd_c = G.compute_3d_zdir_and_dps(surf.depth[0, 0].cpu(),
                                     cam.intrinsic[0, 0].cpu(),
                                     cam.H_c2w[0, 0].cpu())
    z_err = 0.0
    for k in zd:
        a, b = zd[k].cpu(), zd_c[k]
        check(torch.equal(torch.isfinite(a), torch.isfinite(b)),
              f"compute_3d_zdir_and_dps {k}: another non-finite pattern")
        fin = torch.isfinite(b)
        z_err = max(z_err, float(((a - b).abs()[fin] / b.abs().max()).max()))
    stats.update(projection_rel_err=rel, uv_sampling_err=s_err,
                 zdir_dps_rel_err=z_err, corresponding_valid=int(corr["valid"].sum()))
    log(f"[tools] pinhole_projection / find_corresponding_uv / uv_sampling / "
        f"compute_3d_zdir_and_dps of {pts.shape[1]} nearest points into view "
        f"1: {stats['geometry_ms']:.3f} ms on the card; card vs CPU rel |d| "
        f"{rel:.2e}, sampling |d| {s_err:.2e}, capture geometry rel |d| "
        f"{z_err:.2e}; {int(mism.sum())} masks differ at a sensor edge")
    check(rel <= 1e-5 and s_err <= 1e-6 and z_err <= 1e-6,
          "geometry card vs CPU")

    # 3. sparse: the learned cell's grid
    coords, _ = synthetic_cloud(LEARNED_POINTS, 448, seed=0)
    pts_l = torch.from_numpy(coords)
    g_cpu = TSP.quantize_average(pts_l, torch.zeros((len(coords), 1)))
    feats = torch.randn((g_cpu.num, 32), generator=torch.Generator().manual_seed(0))
    g_cpu = g_cpu.replace(feats=feats)
    g_dev = g_cpu.replace(codes=g_cpu.codes.to(dev), feats=feats.to(dev))
    pts_d = pts_l.to(dev)
    interp = TSP.interpolate_trilinear(g_dev, pts_d)
    stats["interpolate_ms"] = _event_ms(
        torch, lambda: TSP.interpolate_trilinear(g_dev, pts_d), 5)
    i_err = float((interp.cpu() - TSP.interpolate_trilinear(g_cpu, pts_l))
                  .abs().max())
    keep = torch.rand(g_cpu.num, generator=torch.Generator().manual_seed(1)) > 0.5
    pr_dev = TSP.prune(g_dev, keep.to(dev))
    stats["prune_ms"] = _event_ms(torch, lambda: TSP.prune(g_dev, keep.to(dev)), 5)
    pr_cpu = TSP.prune(g_cpu, keep)
    check(torch.equal(pr_dev.codes.cpu(), pr_cpu.codes)
          and torch.equal(pr_dev.feats.cpu(), pr_cpu.feats), "prune card vs CPU")
    stats.update(grid_voxels=g_cpu.num, interpolate_err=i_err,
                 pruned_voxels=pr_cpu.num)
    log(f"[tools] interpolate_trilinear of {len(coords)} points on the "
        f"{g_cpu.num}-voxel grid, 32 channels: {stats['interpolate_ms']:.3f} ms"
        f" on the card, card vs CPU max |d| {i_err:.2e}; prune to "
        f"{pr_cpu.num} voxels {stats['prune_ms']:.3f} ms, codes and features "
        f"equal")
    check(i_err <= 1e-6, f"interpolate_trilinear card vs CPU: {i_err}")
    check(g_cpu.num == LEARNED_VOXELS, f"the learned grid has {g_cpu.num} voxels")

    # 4. meshing on the host
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    vox = pcd_cpu.get_mesh("voxel", cell_width=4.0)
    stats["mesh_voxel_s"] = time.perf_counter() - t0
    sub = rng.choice(n_pts, POISSON_SUBSAMPLE, replace=False)
    sub_t = torch.from_numpy(sub)
    sub_pc = PointCloud(xyz_w=pcd_cpu.xyz_w[:, sub_t],
                        normal_w=pcd_cpu.normal_w[:, sub_t])
    t0 = time.perf_counter()
    poi = sub_pc.get_mesh("poisson", depth=7)
    stats["mesh_poisson_s"] = time.perf_counter() - t0
    asub = rng.choice(n_pts, ALPHA_SUBSAMPLE, replace=False)
    a_xyz = xyz_np[asub]
    spacing = float(np.median(cKDTree(a_xyz).query(a_xyz, k=2)[0][:, 1]))
    t0 = time.perf_counter()
    alp = PointCloud.from_numpy(a_xyz).get_mesh("alpha", alpha=3 * spacing)
    stats["mesh_alpha_s"] = time.perf_counter() - t0
    for tag, msh in (("voxel", vox), ("poisson", poi), ("alpha", alp)):
        check(len(msh.vertices) > 0 and len(msh.triangles) > 0, f"{tag} mesh empty")
        stats[f"mesh_{tag}_triangles"] = len(msh.triangles)
    for tag, msh in (("voxel", vox), ("poisson", poi)):
        odd = int((_edge_counts(msh.triangles) % 2).sum())
        check(odd == 0, f"the {tag} mesh has {odd} edges on an odd number of "
              "triangles")
    sub_xyz = xyz_np[sub]
    cell = float((sub_xyz.max(0) - sub_xyz.min(0)).max()) * 1.2 / 2 ** 7
    dist = cKDTree(xyz_np).query(poi.vertices)[0]
    # the scored mesh's poles are open (latitudes 0.02 pi .. 0.98 pi of the
    # sphere scaled to a half-height of 1 at 448 voxels per unit): the
    # Poisson indicator closes each hole with a cap whose points lie up to
    # about the hole's radius from its rim; two grid cells of smoothing on top
    hole = 448.0 * math.tan(0.02 * math.pi) / 1.6
    bound = hole + 2 * cell
    stats.update(poisson_cell=cell, poisson_median_dist=float(np.median(dist)),
                 poisson_max_dist=float(dist.max()), poisson_max_bound=bound)
    rays = Ray(o.cpu().reshape(1, KNN_RES, KNN_RES, 3),
               d.cpu().reshape(1, KNN_RES, KNN_RES, 3))
    mesh_hit = poi.get_ray_intersection(rays)["hit_map"][0] > 0.5
    agree = float((mesh_hit == surf_k).mean())
    stats["poisson_hit_agreement"] = agree
    log(f"[tools] get_mesh on the host: voxel (cell 4) of {n_pts} points "
        f"{stats['mesh_voxel_s']:.2f} s, {len(vox.triangles)} triangles; "
        f"poisson (depth 7) of {len(sub)} points {stats['mesh_poisson_s']:.2f} "
        f"s, {len(poi.triangles)} triangles; alpha ({3 * spacing:.3f} = 3x the "
        f"median spacing) of {len(asub)} points {stats['mesh_alpha_s']:.2f} s, "
        f"{len(alp.triangles)} triangles; voxel and poisson edges all on an "
        f"even number of triangles; poisson vertex to cloud: median "
        f"{np.median(dist):.3f}, max {dist.max():.3f} voxels (grid cell "
        f"{cell:.3f}; max bound {bound:.3f} = the open poles' hole radius "
        f"{hole:.3f} + 2 cells); its {KNN_RES}² ray cast agrees with the "
        f"cloud's surfel hits on {agree:.4f} of pixels")
    check(np.median(dist) <= cell, "poisson vertices lie off the cloud")
    check(dist.max() <= bound, f"a poisson vertex lies {dist.max()} from the cloud")
    check(agree >= 0.95, f"poisson ray cast agrees on {agree} of pixels")

    # 5. remesh_file on the scored OBJ
    obj = os.path.join(src, "0001.obj")
    t0 = time.perf_counter()
    TM.remesh_file(obj, os.path.join(out_dir, "remeshed.obj"))
    stats["remesh_file_s"] = time.perf_counter() - t0
    back = TM.load_obj(os.path.join(out_dir, "remeshed.obj"), flip_texture_v=False)
    uv = back["triangle_uvs"]
    n_tri = len(back["triangles"])
    cols = math.ceil(math.sqrt(n_tri))
    rows = math.ceil(n_tri / cols)
    cell_uv = np.floor(uv * [cols, rows]).astype(np.int64)
    own = cell_uv[..., 1] * cols + cell_uv[..., 0]
    check(n_tri == len(TM.load_obj(obj)["triangles"]) and uv.min() >= 0
          and uv.max() <= 1 and (own == np.arange(n_tri)[:, None]).all(),
          "remesh_file: a uv outside [0, 1] or its triangle's atlas cell")
    log(f"[tools] remesh_file of the scored OBJ ({n_tri} triangles): "
        f"{stats['remesh_file_s']:.2f} s; every uv in [0, 1] and in its "
        f"triangle's cell of the {cols}x{rows} atlas")

    # 6. Camera: slicing and frame meshes
    whole = cam.H_c2w
    for parts in (cam.split(res_ * res_ * 5), cam.chunk(5, dim=1)):
        cat = Camera.cat(parts, dim=1)
        check(torch.equal(cat.H_c2w, whole) and torch.equal(cat.intrinsic, cam.intrinsic),
              "Camera.cat of the parts is not the camera")
    sel = cam.index_select(1, [TOOL_VIEWS - 1, 0])
    check(torch.equal(sel.H_c2w, whole[:, [TOOL_VIEWS - 1, 0]]), "index_select")
    frames = os.path.join(out_dir, "frames.obj")
    cam.save_camera_frames(frames, camera_frame_size=0.1 * radius,
                           world_frame_size=0.2 * radius)
    fr = TM.load_obj(frames)
    check(fr["vertices"].shape == ((TOOL_VIEWS + 1) * 32, 3)
          and fr["triangles"].shape == ((TOOL_VIEWS + 1) * 48, 3),
          f"camera frames read back as {fr['vertices'].shape}")
    log(f"[tools] Camera: split {[p.H_c2w.shape[1] for p in cam.split(res_ * res_ * 5)]}"
        f", chunk {[p.H_c2w.shape[1] for p in cam.chunk(5, dim=1)]}, "
        f"index_select and cat equal to the whole; save_camera_frames of "
        f"{TOOL_VIEWS} views + world frame read back "
        f"({len(fr['vertices'])} vertices)")

    # 7. PointersectRecord from a ray cast of the scored mesh
    mesh = TM.Mesh(obj, scale=1.0)
    from gpcr_tpu_torch.structures.camera import derive_camera_intrinsics
    from gpcr_tpu_torch.utils import rigid_motion as RM

    H = RM.get_H_c2w_lookat(torch.tensor([[0.4, 0.3, 3.0]]), torch.zeros(1, 3),
                            torch.tensor([[0.0, 1.0, 0.0]]))
    pc_cam = Camera(H_c2w=H[None], intrinsic=derive_camera_intrinsics(
        res_, res_, 45.0)[None, None], width_px=res_, height_px=res_)
    ro, rd = pc_cam.generate_camera_rays()
    ro, rd = ro.reshape(1, -1, 3), rd.reshape(1, -1, 3)
    t0 = time.perf_counter()
    cast = mesh.get_ray_intersection(Ray(ro, rd))
    stats["record_cast_s"] = time.perf_counter() - t0
    t = torch.from_numpy(cast["ray_ts"]).to(dev)
    xyz_hit = ro.to(dev) + t[..., None] * rd.to(dev)
    rec = PointersectRecord(
        intersection_xyz_w=xyz_hit,
        intersection_surface_normal_w=torch.from_numpy(cast["surface_normals_w"]).to(dev),
        intersection_rgb=torch.from_numpy(cast["ray_rgbs"]).to(dev),
        ray_t=t, ray_hit=torch.from_numpy(cast["hit_map"]).to(dev))
    back_pc = rec.get_rgbd_image(pc_cam.to(dev)).get_pcd()
    valid = back_pc.valid_mask[0, :, 0]
    hit_m = rec.ray_hit[0] > 0.5
    check(back_pc.device.type == dev.type and torch.equal(valid, hit_m)
          and int(valid.sum()) > 0, "PointersectRecord: another hit mask")
    r_err = float((back_pc.xyz_w[0][valid] - xyz_hit[0][valid]).abs().max())
    stats.update(record_hits=int(valid.sum()), record_err=r_err)
    log(f"[tools] PointersectRecord of one {res_}² ray cast of the scored mesh "
        f"({stats['record_cast_s']:.2f} s on the host): get_rgbd_image + "
        f"get_pcd on the card give back its {int(valid.sum())} hit points, "
        f"max |d| {r_err:.2e}")
    check(r_err <= 1e-3, f"PointersectRecord round trip: {r_err}")

    # 8. sampling on the card. The means lie on the hemisphere around +z:
    # get_min_R's K^2 / (1 + cos) term (JAX's formula) loses float32
    # precision as a mean nears -z, which the whole sphere's error shows
    gen = torch.Generator(device=dev).manual_seed(0)
    mu = torch.nn.functional.normalize(
        torch.randn((VMF_SAMPLES, 3), generator=gen, device=dev), dim=-1)
    sg = SMP.SphericalGaussian(kappa=100.0)
    sphere_err = float((torch.linalg.norm(sg.sample(gen, mu), dim=-1) - 1)
                       .abs().max())
    mu = mu * torch.where(mu[:, 2:] < 0, -1.0, 1.0)
    smp = sg.sample(gen, mu)
    stats["vmf_ms"] = _event_ms(torch, lambda: sg.sample(gen, mu), 5)
    norm_err = float((torch.linalg.norm(smp, dim=-1) - 1).abs().max())
    w = (smp * mu).sum(-1).double()
    mean_w = 1.0 / math.tanh(100.0) - 1.0 / 100.0
    z_w = abs(float(w.mean()) - mean_w) / (float(w.std()) / math.sqrt(VMF_SAMPLES))
    a = torch.arange(64_000, device=dev).reshape(1000, 64)
    sh = SMP.shuffle_along_axis(gen, a, axis=1)
    check(torch.equal(torch.sort(sh, dim=1).values, a) and not torch.equal(sh, a),
          "shuffle_along_axis on the card is no per-row permutation")
    stats.update(vmf_norm_err=norm_err, vmf_mean_w_z=z_w,
                 vmf_norm_err_whole_sphere=sphere_err)
    log(f"[tools] SphericalGaussian(kappa 100).sample of {VMF_SAMPLES} directions "
        f"on the card: {stats['vmf_ms']:.3f} ms, max ||s| - 1| {norm_err:.2e} "
        f"(means on the +z hemisphere; {sphere_err:.2e} with means on the "
        f"whole sphere), mean w {float(w.mean()):.6f} against coth(k) - 1/k "
        f"= {mean_w:.6f} ({z_w:.2f} standard errors); shuffle_along_axis a "
        f"permutation per row")
    check(norm_err <= 1e-5 and z_w <= 4.0, "vMF samples")

    # 9. ColorCorrector: one Adam step on the card
    cc = ColorCorrector(device=dev)
    opt = torch.optim.Adam(cc.parameters(), lr=1e-2)
    x = surf.rgb[0, 0]
    loss = torch.mean((cc(x) - x * torch.tensor([0.9, 1.0, 1.1], device=dev)) ** 2)
    loss.backward()
    opt.step()
    moved = float((cc.wrgb.detach() - 1).abs().max())
    check(cc.wrgb.is_cuda and moved > 0, "ColorCorrector did not move")

    # 10. the rasterizer's debug flag, traced
    render = _golden_view(torch, dev, debug=True)
    RS.LAUNCHES = 0
    trace_dir = os.path.join(out_dir, "trace")
    with DBG.trace(trace_dir):
        img = render()
    launches = RS.LAUNCHES
    with open(os.path.join(trace_dir, "trace.json")) as f:
        named = "stream_blend_kernel" in f.read()
    ref = read_png(os.path.join(HERE, "tests", "golden", "rgb_0.png"))
    psnr = _psnr_u8(img[:3].permute(1, 2, 0), ref)
    raised = False
    try:
        _golden_view(torch, dev, debug=True, nan_at=5)()
    except FloatingPointError:
        raised = True
    med, _, _ = timed(_golden_view(torch, dev, debug=False), warmup=1, iters=5)
    stats.update(debug_launches=launches, debug_psnr=psnr, debug_view_ms=med,
                 trace_names_kernel=named, colorcorrector_moved=moved)
    log(f"[tools] golden view 0 with settings.debug under utils/debug.trace: "
        f"serving kernel launches {launches}, the trace names "
        f"stream_blend_kernel: {named}, {psnr:.2f} dB against the golden PNG;"
        f" one NaN mean raises FloatingPointError: {raised}; timed: "
        f"{med:.3f} ms (median of 5, host clock); ColorCorrector moved "
        f"wrgb by {moved:.2e}")
    check(raised, "a NaN mean did not raise with settings.debug")
    check(psnr >= 50.0, f"the debug render is {psnr} dB off the golden PNG")
    check(launches >= 1 and named, "the debug render did not go through "
          "the serving kernel, or the trace does not name it")
    log("[tools] " + json.dumps(stats))
    return stats


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
    _log_tile_work(tag, starts, order, cnt, config.chunk_size, forward=False)
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
    from gpcr_tpu_torch.utils.blend_inputs import train_view0

    (stream, starts, order, nt, gx, channels, config,
     n_splats) = train_view0(trainer, 200_000, 512)
    log(f"[timing-train] training view 0: {n_splats} splats, "
        f"{stream.shape[0]} entries per view, 512², C={channels}")
    return _time_training_kernels(torch, "train view 0", stream, starts,
                                  order, nt, gx, channels, config, seed=11)


def phase_timing_raster(torch):
    """Rasterizer-only forward + backward at 800K analytic gaussians,
    1024², C = 3, dup cap 8, chunk 128, no k_budget (the scene of
    ``scripts.bench_train_step``, whose k_budget of 6M and max_active of
    4,096 cut nothing there): kernel A, kernel B and
    one whole forward + ``loss.backward()``, each in turns plain / kernel /
    kernel / plain. The plain turns of the whole step swap the two plain
    versions into the autograd Function (here only; the port never does)."""
    from gpcr_tpu_torch.utils.blend_inputs import analytic_scene, bin_view
    from gpcr_tpu_torch.ops import rasterize as R
    from gpcr_tpu_torch.ops import rasterize_stream as RS
    from gpcr_tpu_torch.ops import rasterize_stream_vjp as RV

    leaves, settings, config = analytic_scene(800_000, torch.device("cuda"))
    leaves = [x.requires_grad_(True) for x in leaves]
    m, sc, q, o, f = leaves

    with torch.no_grad():
        prep = R.preprocess(m, o, settings, config, scales=sc, rotations=q,
                            colors_precomp=f)
        stream, starts, order, nt, gx = bin_view(prep, settings.image_height,
                                                 config)
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


def phase_sharded(torch, B, RS, ckpt, train):
    """The multi-GPU paths on the one card: the serving kernel with a tile
    window on every window of a 4-way split of the learned view 0 (against
    its plain version; assembled, the unwindowed kernel's bits; entries,
    binning and kernel times per window), then, in a one-rank NCCL group,
    the 12 golden views through ``simple --shard views`` and ``--shard
    tiles`` and ``train --sp 1`` against the unsharded runs of this script.
    Returns (per-window records, the kernel's launches in the tiles run)."""
    import numpy as np

    from gpcr_tpu_torch.cli import train as T
    from gpcr_tpu_torch.io import read_png
    from gpcr_tpu_torch.parallel import distributed
    from gpcr_tpu_torch.parallel.render import window_of
    from gpcr_tpu_torch.utils.blend_inputs import view0_prep

    splats = _learned_splats(torch, ckpt)
    config = splats["config"]._replace(downscale=2)
    prep, channels, res = view0_prep(splats)
    gx = -(-res // 16)
    nt = gx * gx
    with torch.no_grad():
        stream, starts, ovf = RS.bin_sorted_stream(prep, nt, gx, config)
        order, _ = RS.render_order(starts, ovf, nt, config)
        full = (stream, starts, order, nt, gx, channels, config)
        acc, t = RS.blend_tiles(*full)
        bin_ms = _event_ms(torch, lambda: RS.bin_sorted_stream(
            prep, nt, gx, config), 5)
        k1 = _event_ms(torch, lambda: RS.blend_tiles(*full), 20)
        windows, parts = [], []
        for d in range(SHARD_WINDOWS):
            base, count = window_of(nt, SHARD_WINDOWS, d)
            w_stream, w_starts, w_ovf = RS.bin_sorted_stream(
                prep, nt, gx, config, tile_window=(base, count))
            w_order, _ = RS.render_order(w_starts, w_ovf, count, config)
            args = (w_stream, w_starts, w_order, count, gx, channels, config)
            got = RS.blend_tiles(*args, tile_base=base)
            torch.cuda.synchronize()
            ref = RS.blend_tiles_plain(*args, tile_base=base)
            errs = [(a - b).abs() for a, b in zip(got, ref)]
            mx = max(float(e.max()) for e in errs)
            mean = max(float(e.mean()) for e in errs)
            check(mx <= MAX_ERR and mean <= MEAN_ERR, f"windowed kernel, "
                  f"window {d}, disagrees with plain: {mx} / {mean}")
            parts.append(got)
            windows.append(dict(
                window=d, base=base, tiles=count,
                entries=int(w_stream.shape[0]),
                binning_ms=_event_ms(torch, lambda: RS.bin_sorted_stream(
                    prep, nt, gx, config, tile_window=(base, count)), 5),
                kernel_ms=_event_ms(
                    torch, lambda: RS.blend_tiles(*args, tile_base=base), 20),
                max_abs_err=mx))
        k2 = _event_ms(torch, lambda: RS.blend_tiles(*full), 20)
    check(bool(torch.equal(torch.cat([p[0] for p in parts])[:nt], acc)
               and torch.equal(torch.cat([p[1] for p in parts])[:nt], t)),
          "the assembled windows differ from the unwindowed kernel's output")
    check(sum(w["entries"] for w in windows) == int(stream.shape[0]),
          "the windows' entries do not add up to the frame's")
    worst = max(w["kernel_ms"] for w in windows)
    log("[sharded] learned view 0 in " + str(SHARD_WINDOWS) + " windows: "
        + json.dumps({"entries": int(stream.shape[0]), "tiles": nt,
                      "kernel_ms": [k1, k2], "binning_ms": bin_ms,
                      "windows": windows,
                      "max_window_over_kernel": worst / min(k1, k2)}))

    # a one-rank NCCL group: the collectives of the sharded entry points
    rdv = os.path.join(WORK, "rendezvous")
    check(distributed.initialize(init_method="file://" + rdv, world_size=1,
                                 rank=0), "no process group was started")
    try:
        check(torch.distributed.get_backend() == "nccl",
              f"backend {torch.distributed.get_backend()}, not nccl")
        golden = {}
        for mode in ("views", "tiles"):
            RS.LAUNCHES = 0
            out_dir, psnrs = _golden_cli(B, f"golden_{mode}", "--shard", mode)
            golden[mode] = (out_dir, psnrs, RS.LAUNCHES)
            log(f"[sharded] golden --shard {mode}: PSNR dB per view "
                + " ".join(f"{p:.2f}" for p in psnrs)
                + f"; serving kernel launches {RS.LAUNCHES}")
            check(len(psnrs) == 12 and min(psnrs) >= 50.0,
                  f"--shard {mode} golden PSNR below 50 dB: {min(psnrs)}")
            # the CLI renders every view twice: a warm run, a timed run
            check(RS.LAUNCHES == 24, f"--shard {mode} launched the serving "
                  f"kernel {RS.LAUNCHES} times, not twice per view")
        unsharded = os.path.join(WORK, "golden_out", os.path.basename(
            golden["views"][0]))
        for name in sorted(os.listdir(unsharded)):
            check(_same_bytes(os.path.join(unsharded, name),
                              os.path.join(golden["views"][0], name)),
                  f"--shard views: {name} differs from the unsharded PNG")
            ref = read_png(os.path.join(unsharded, name)).astype(np.int32)
            tiles = read_png(os.path.join(golden["tiles"][0], name))
            level = int(np.abs(tiles.astype(np.int32) - ref).max())
            check(level <= 1, f"--shard tiles: {name} is {level} uint8 "
                  "levels off the unsharded PNG")

        # the same seed as phase_train: steps 1-3 must give its losses (step
        # 1 has learning rate 0; step 3's loss follows step 2's update)
        t0 = time.time()
        got = T.main(["--steps", "3", "--sp", "1", "--out_dir",
                      os.path.join(WORK, "train_sp"), *TRAIN_ARGS])
        sp_seconds = time.time() - t0
        check(got["trainer"].mesh.world is not None,
              "train --sp 1 ran without the process group")
    finally:
        torch.distributed.destroy_process_group()
    ref_hist = train["history"][:3]
    for h, r in zip(got["history"], ref_hist):
        rel = abs(h["loss"] - r["loss"]) / abs(r["loss"])
        check(rel <= SHARD_LOSS_REL, f"train --sp 1 step {h['step']}: loss "
              f"{h['loss']} against the unsharded {r['loss']}")
    log("[sharded] train --sp 1 in a one-rank NCCL group: loss per step "
        + " ".join(f"{h['loss']:.6f}" for h in got["history"])
        + " (unsharded " + " ".join(f"{r['loss']:.6f}" for r in ref_hist)
        + "); s/step " + " ".join(f"{h['s_per_step']:.3f}"
                                  for h in got["history"])
        + " (unsharded " + " ".join(f"{r['s_per_step']:.3f}"
                                    for r in ref_hist)
        + f"); {sp_seconds:.1f} s in all")
    return windows, golden["tiles"][2]


def _counted(RS, RV, counts, fn):
    """Run ``fn`` with the three launch counters of the stream kernels set
    to 0 just before; add what it launched to ``counts`` and return
    (``fn``'s result, its (serving, count forward, replay backward)
    launches)."""
    RS.LAUNCHES = RS.LAUNCHES_CONTRIB = RV.LAUNCHES_BWD = 0
    out = fn()
    got = (RS.LAUNCHES, RS.LAUNCHES_CONTRIB, RV.LAUNCHES_BWD)
    for name, n in zip(KERNEL_NAMES[:3], got):
        counts[name] += n
    return out, got


def phase_bench(torch, RS, RV):
    """The benchmark and demo entry points of the port at their full
    sizes, through their ``main``s: ``bench`` at its defaults (800K
    points, 1024² x2, 16 views per call, 5 timed calls), ``bench_matrix``
    c1 / c3a / c4 / c5, ``bench_train_step`` (3 reps), ``bench_pcrender``
    (``--dup_cap 256``, the CLI in a subprocess, whose launches this
    process does not count) and ``train_demo`` (DEMO_STEPS steps, then a
    resumed run of DEMO_RESUME more). Each launch counter is reset just
    before each entry point; every one must have launched its kernels.
    Then the serving kernel at view 0 of the headline, c1, c4 and c5
    scenes and the two training kernels at the demo's view 0 are held
    against their plain versions and timed. Returns (launches per kernel,
    kernel 1's records per shape, kernels 2-3's at the demo shape, the
    headline's views binned on the kernels)."""
    from gpcr_tpu_torch import bench
    from gpcr_tpu_torch.ops import preprocess as P
    from gpcr_tpu_torch.scripts import (bench_matrix, bench_pcrender,
                                        bench_train_step, train_demo)
    from gpcr_tpu_torch.train.data import DataLoader
    from gpcr_tpu_torch.utils.blend_inputs import (bench_view0_stream,
                                                   train_view0)

    counts = dict.fromkeys(KERNEL_NAMES, 0)
    card = phase_device(torch)
    RS.LAUNCHES_BIN = P.LAUNCHES_PREP = 0
    head, got = _counted(RS, RV, counts, lambda: bench.main([]))
    bin_launches, prep_launches = RS.LAUNCHES_BIN, P.LAUNCHES_PREP
    log(f"[bench] headline: {head['ms']:.4f} ms/frame median, per call "
        f"{head['times_ms']}, nonempty_tiles {head['nonempty_tiles']}, "
        f"dropped tiles / entries {head['dropped_tiles']} / "
        f"{head['dropped_entries']}, render_dup_overflow "
        f"{head['render_dup_overflow']}, tile_bin overflow "
        f"{head['overflow']}; serving launches {got[0]}, binning launches "
        f"{bin_launches}, preprocess launches {prep_launches}; {card}")
    check(math.isfinite(head["ms"]), "bench gave no finite ms per frame")
    check(got[0] == 6 * 16, f"bench launched the serving kernel {got[0]} "
          "times, not 16 views x (1 warm + 5 timed calls)")
    check(bin_launches == prep_launches == 6 * 16,
          f"bench binned {bin_launches} and preprocessed {prep_launches} "
          "views on the kernels, not 16 per call of 16 views")
    check(head["dropped_tiles"] == head["dropped_entries"]
          == head["render_dup_overflow"] == head["overflow"] == 0,
          "the headline frame dropped entries")

    for key, cfg in bench_matrix.CONFIGS.items():
        res, got = _counted(RS, RV, counts,
                            lambda: bench_matrix.main([key]))
        res = res[key]
        calls = 1 + -(-(cfg.get("frames") or cfg["n_views"]) // cfg["vpd"])
        check(math.isfinite(res["ms_per_frame"]),
              f"{key}: no finite ms per frame")
        check(got[0] == calls * cfg["vpd"], f"{key} launched the serving "
              f"kernel {got[0]} times, not {calls} calls x {cfg['vpd']}")
        log(f"[bench] {key}: {res['ms_per_frame']} ms/frame, per call "
            f"{res['times_ms']}, {res['points']} points, dup_overflow "
            f"{res['dup_overflow']}, render_dup_overflow "
            f"{res['render_dup_overflow']}; serving launches {got[0]}")

    torch.cuda.reset_peak_memory_stats()
    step, got = _counted(RS, RV, counts, lambda: bench_train_step.main(
        ["--reps", "3"]))
    peak = torch.cuda.max_memory_allocated()
    log(f"[bench] train step: {step['ms']:.2f} ms median of {step['times_ms']}"
        f", first {step['first_s']:.2f} s, loss {step['loss']:.6f}, max|g| "
        f"{step['max_grad']:.3e}, peak memory {peak / 2**30:.3f} GiB; "
        f"launches {got}")
    check(step["grads_finite"] and step["max_grad"] > 0,
          "bench_train_step's gradients are not finite or all zero")
    check(got[1] == got[2] == 4, f"bench_train_step launched the training "
          f"kernels {got[1:]} times, not 4 each (first + 3 reps)")

    pcr = bench_pcrender.main(["--root", os.path.join(WORK, "bench_pcrender"),
                               "--dup_cap", "256"])
    check(pcr["returncode"] == 0, "bench_pcrender's CLI run failed")
    check(any("rgb time" in line for line in pcr["lines"]),
          "bench_pcrender printed no timing line")
    check(not any("dropped" in line for line in pcr["lines"]),
          "bench_pcrender dropped entries at --dup_cap 256")

    out = os.path.join(WORK, "train_demo")
    t0 = time.time()
    demo, got = _counted(RS, RV, counts, lambda: train_demo.main(
        ["--steps", str(DEMO_STEPS), "--out", out]))
    demo_s = time.time() - t0
    check(got[1] > 0 and got[2] > 0, f"train_demo launched the training "
          f"kernels {got[1:]} times")
    check(demo["improved"], "train_demo's held-out PSNR did not rise by "
          "more than 0.5 dB")
    curve = [(h["step"], round(h["psnr"], 4)) for h in demo["history"]
             if "psnr" in h]
    resumed, _ = _counted(RS, RV, counts, lambda: train_demo.main(
        ["--steps", str(DEMO_STEPS + DEMO_RESUME), "--out", out,
         "--resume"]))
    steps = [h["step"] for h in resumed["history"] if "loss" in h]
    # the resumed run starts from the saved weights: its held-out PSNR
    # before its first step is the first run's last one (the U-Net's
    # index_add_ sums in another order from run to run)
    check(abs(resumed["psnr_start"] - curve[-1][1]) <= 1e-3,
          f"the resumed train_demo starts at {resumed['psnr_start']} dB, "
          f"the first run ended at {curve[-1][1]} dB")
    check(resumed["start_step"] == DEMO_STEPS
          and steps == list(range(1, DEMO_STEPS + DEMO_RESUME + 1))
          and resumed["trainer"].optimizer.count == DEMO_STEPS + DEMO_RESUME,
          f"the resumed train_demo started at {resumed['start_step']}")
    log(f"[bench] train_demo: {DEMO_STEPS} steps in {demo_s:.1f} s, "
        f"held-out PSNR by step {curve}; resumed from "
        f"{resumed['start_step']} to {steps[-1]}")

    def scene_of(kw):
        """A bench_matrix config's scene and raster config."""
        coords, rgb = bench_matrix.make_cloud(
            kw["n_pts"], kw["sf"], quantize=kw.get("quantize", False))
        return (bench_matrix.make_scene(coords, rgb, kw["sf"], kw["res_w"],
                                        kw["res_h"], kw["n_views"]),
                bench_matrix.raster_config(kw.get("dup_cap", 4),
                                           kw["k_budget"],
                                           kw.get("max_active", 8192)))

    # bench's defaults as a bench_matrix config
    headline = dict(n_pts=800_000, sf=448, res_w=1024, res_h=1024, n_views=5,
                    dup_cap=4, k_budget=1_800_000, max_active=6144)
    # device time by op and the card's idle share of one headline call (16
    # views) and of one train_demo step
    from gpcr_tpu_torch.cli.profile_pcrender import _traced

    scene, config = scene_of(headline)
    views = [j % 5 for j in range(16)]
    bench_matrix.render(scene, config, views)
    traces = {"headline call": _traced(
        "headline call (16 views)",
        lambda: bench_matrix.render(scene, config, views),
        torch.device("cuda"), 12)}
    trainer = demo["trainer"]
    demo_batch = DataLoader(batch_size=2, n_points=2048, n_views=2, hw=48,
                            scale_factor=96, seed=0, device="cuda").next_batch()
    traces["train_demo step"] = _traced(
        "train_demo step", lambda: trainer.train_step(demo_batch),
        torch.device("cuda"), 12)

    shapes = {}
    for tag, kw in (("headline", headline),
                    ("c1", bench_matrix.CONFIGS["c1"]),
                    ("c4", bench_matrix.CONFIGS["c4"]),
                    ("c5", bench_matrix.CONFIGS["c5"])):
        scene, config = scene_of(kw)
        (stream, starts, order, nt, gx, channels, config,
         ovf) = bench_view0_stream(scene, config)
        check(ovf == 0, f"{tag} view 0 drops {ovf} entries")
        rec, _, _ = _time_serving(
            torch, f"{tag} view 0 ({kw['res_w'] * 2}x{kw['res_h'] * 2} "
            "inside)", stream, starts, order, nt, gx, channels, config)
        shapes[tag] = dict(rec, entries=int(stream.shape[0]), tiles=nt,
                           grid_x=gx)
        del scene, stream
    (stream, starts, order, nt, gx, channels, config,
     _) = train_view0(trainer, 2048, 48, scale_factor=96)
    demo_kernels = _time_training_kernels(
        torch, "train_demo view 0 (48²)", stream, starts, order, nt, gx,
        channels, config, seed=17)
    log("[bench] launches of the entry points (bench_pcrender's CLI "
        "subprocess not counted): " + json.dumps(counts))
    log("[bench] traces: " + json.dumps(traces))
    return counts, shapes, demo_kernels, bin_launches


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
            try:
                out = phase(*args)
                torch.cuda.synchronize()
            except BaseException as e:
                log(f"[fail] {phase.__name__} after {time.time() - t1:.1f} "
                    f"s: {type(e).__name__}: {e}")
                raise
            log(f"[time] {phase.__name__}: {time.time() - t1:.1f} s")
            return out

        card = phase_device(torch)
        run(phase_build)
        worst, worst_a, worst_b = run(phase_kernel_vs_plain, torch, dev)
        worst_c = run(phase_aligned_vs_plain, torch, dev)
        run(phase_golden, torch, B)
        launches, sparse_launches, timing, peak, ckpt = run(
            phase_learned, torch, B, RS)
        run(phase_learned_small, torch)
        sparse = run(phase_sparse_conv, torch)
        ptv3 = run(phase_ptv3, torch)
        ptv2 = run(phase_ptv2, torch)
        entry_launches = run(phase_entry, torch, RS, RV, card)
        splats = _learned_splats(torch, ckpt)
        serve, pairs, entries, work = run(phase_timing, torch, splats)
        binning = run(phase_binning, torch, splats)
        cell_bins, cell_preps, view0 = run(phase_cell_binning, torch, RS)
        prep_times = run(phase_preprocess, torch, view0)
        del view0
        aligned_launches = run(phase_aligned_route, torch, B, RA, splats)
        aligned = run(phase_timing_aligned, torch, splats, pairs, entries,
                      work)
        del work
        del splats
        scored = run(phase_scored, torch, B, RS, ckpt)
        run(phase_pipeline, torch, B, RS, ckpt, scored)
        run(phase_tools, torch, RS)
        run(phase_grad_small, torch)
        train = run(phase_train, torch, RS, RV)
        run(phase_train_stages, torch, train["trainer"])
        k_contrib, k_bwd = run(phase_timing_train, torch, train["trainer"])
        k_raster = run(phase_timing_raster, torch)
        windows, windowed_launches = run(phase_sharded, torch, B, RS, ckpt,
                                         train)
        bench, serve_shapes, k_demo, bench_bins = run(phase_bench, torch,
                                                      RS, RV)
        # the port imports nothing of the JAX package
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "gpcr_tpu", "scripts"))
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
    # early-terminating alpha blend and its replay), so library_ms is null;
    # nor a sparse convolution over a neighbour map (sparse_conv: its plain
    # version and the differentiable ops are timed in phase_sparse_conv);
    # patch_attn's library_ms is F.scaled_dot_product_attention on the same
    # gathered patches, and its launches those of one PTv3 request;
    # bin_stream's launches are the views binned on the kernels in one
    # request of each cell (phase_cell_binning), its bench_launches those
    # of phase_bench's headline run, its times per view at two shapes;
    # preprocess's launches the views preprocessed on the kernel in the
    # same requests, its times per view at each cell's view 0
    # entry_launches: kernel 1's launches in one call of the entry's fn;
    # bench_launches: each kernel's launches in phase_bench's entry points;
    # bench_shapes: the kernel at the benchmarks' shapes (kernel 1 at view 0
    # of the headline and c1 / c4 / c5; kernels 2-3 at bench_train_step's
    # 800K scene, which phase_timing_raster times, and at train_demo's
    # view 0)
    log(json.dumps({"kernels": [
        {"name": "stream_blend", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/stream_blend.cu",
         "replaces": TPU_KERNEL, "launches": launches, **serve,
         "library_ms": None, "windowed_launches": windowed_launches,
         "entry_launches": entry_launches,
         "bench_launches": bench["stream_blend"],
         "bench_shapes": serve_shapes},
        {"name": "stream_blend_contrib", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/stream_blend.cu",
         "replaces": TPU_KERNEL_CONTRIB, "launches": train["launches"][0],
         **k_contrib, "library_ms": None,
         "bench_launches": bench["stream_blend_contrib"],
         "bench_shapes": {"bench_train_step": k_raster[0],
                          "train_demo": k_demo[0]}},
        {"name": "stream_blend_bwd", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/stream_blend_bwd.cu",
         "replaces": TPU_KERNEL_BWD, "launches": train["launches"][1],
         **k_bwd, "library_ms": None,
         "bench_launches": bench["stream_blend_bwd"],
         "bench_shapes": {"bench_train_step": k_raster[1],
                          "train_demo": k_demo[1]}},
        {"name": "aligned_blend", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/aligned_blend.cu",
         "replaces": TPU_KERNEL_ALIGNED, "launches": aligned_launches,
         **aligned, "library_ms": None,
         "bench_launches": bench["aligned_blend"]},
        {"name": "sparse_conv", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/sparse_conv.cu",
         "replaces": None, "launches": sparse_launches, **sparse,
         "library_ms": None},
        {"name": "patch_attn", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/patch_attn.cu", "replaces": None,
         **ptv3},
        {"name": "gva", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/gva.cu", "replaces": None, **ptv2},
        {"name": "bin_stream", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/bin_stream.cu", "replaces": None,
         "launches": cell_bins, "bench_launches": bench_bins,
         **binning, "library_ms": None},
        {"name": "preprocess", "route": "cuda",
         "source": "gpcr_tpu_torch/csrc/preprocess.cu", "replaces": None,
         "launches": cell_preps, **prep_times, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
