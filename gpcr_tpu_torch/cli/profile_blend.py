"""Per-tile work, per-CTA spans and timings in one process of the serving
stream blend (``csrc/stream_blend.cu``) and the replay backward
(``csrc/stream_blend_bwd.cu``) at their main-path shapes:

    python -m gpcr_tpu_torch.cli.profile_blend                 # on the card
    python -m gpcr_tpu_torch.cli.profile_blend --diag --baseline DIR
    python -m gpcr_tpu_torch.cli.profile_blend --n_points 3000 \
        --train_points 2000 --channels "9 8 8 8 8 8" --hw 64 --device cpu

Shapes (each built from a seed, ``utils/blend_inputs.py``):

- learned view 0: the synthetic 800K-point cloud of ``profile_pcrender``
  through ``PCEncoder`` at the deployed width with seeded weights, the
  ``pcrender`` CLI's first camera (512² x2), dup cap 256, chunk 256,
  downscale 2, C = 12: the serving blend;
- training view 0: the trainer's seeded weights on the first 200K-point
  example of the ``train`` CLI's loader (512², chunk 64, C = 12): the
  contributor-count forward and the replay backward;
- 800K analytic: isotropic gaussians on a stretched sphere, 1024², C = 3,
  dup cap 8, chunk 128 (``chip_smoke.py``'s rasterizer-only shape).

It prints, per shape, the distribution over rendered tiles of the entries
per tile and of the entries a tile's CTA walks (max, p99, median), and the
share of a CTA's (entry, pixel) slots that belong to pixels that already
stopped. It times this tree's kernel, and the serving blend also with its
tiles launched by ascending id instead of longest first. With ``--diag``
it builds the kernels with ``-DGPCR_DIAG`` and prints per-CTA spans
(global timer) and SM ids: the kernel's span, the longest CTA and its
tile, and the busy share of the SMs. Each ``--baseline DIR`` (repeatable;
a directory holding another version's ``stream_blend.cu`` and / or
``stream_blend_bwd.cu``, with the ``.cuh`` headers they include) is timed
against this tree's kernels on the same inputs, in turns: every run once,
then again in the reverse turn; with a ``stream_blend.cu``, the
contributor-count forward is timed against it too at the backward's
shapes. A baseline replay backward whose C entry takes no scratch (the
one-CTA-per-tile versions) is called through its own interface. One JSON line per
measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import time

import torch

from ..ops import cuda_build
from ..ops import rasterize_stream as RS
from ..ops import rasterize_stream_vjp as RV
from ..render import renderer as RD
from ..structures.pointcloud import PointCloud
from ..utils.blend_inputs import (analytic_view0, distribution,
                                  learned_splats, tile_work, train_view0,
                                  view0_stream)
from .profile_pcrender import LEARNED_INFO, synthetic_cloud


# --------------------------------------------------------------------------
# measurements
# --------------------------------------------------------------------------


def _timed_ms(fn, reps: int, device) -> float:
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _parent_bwd(lib, stream, starts, order, dl_dout, n_contrib, dt_tot,
                t_final, grid_x, channels, config):
    """The replay backward of a version whose C entry takes no scratch
    (one CTA per tile): ``gpcr_stream_blend_bwd`` with 14 arguments."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.gpcr_stream_blend_bwd
    fn.argtypes = [vp, ci, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp, vp]
    fn.restype = ci
    grads = torch.zeros_like(stream)
    rc = fn(stream.data_ptr(), stream.shape[1], starts.data_ptr(),
            order.data_ptr(), order.numel(), grid_x, channels,
            config.chunk_size, dl_dout.data_ptr(), n_contrib.data_ptr(),
            dt_tot.data_ptr(), t_final.data_ptr(), grads.data_ptr(),
            torch.cuda.current_stream(stream.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline stream_blend_bwd launch failed ({rc})")
    return grads


def _spans(fn, lib, setter: str, n_ctas: int, device) -> dict:
    """Launch ``fn`` once with the diagnostic build ``lib`` and summarise
    its CTAs' records (4 int64 each: clock64 span, global start and end in
    ns, SM id)."""
    buf = torch.zeros((n_ctas, 4), dtype=torch.int64, device=device)
    set_buf = getattr(lib, setter)
    set_buf.argtypes, set_buf.restype = [ctypes.c_void_p], ctypes.c_int
    rc = set_buf(buf.data_ptr())
    if rc != 0:
        raise RuntimeError(f"{setter} failed ({rc})")
    fn()
    torch.cuda.synchronize()
    rec = buf[buf[:, 2] > 0].cpu().double()
    t0, t1 = rec[:, 1].min(), rec[:, 2].max()
    dur = rec[:, 2] - rec[:, 1]
    i = int(dur.argmax())
    n_sm = int(rec[:, 3].max()) + 1
    ends = torch.sort(rec[:, 2] - t0).values
    return {"ctas": int(rec.shape[0]), "span_us": float(t1 - t0) / 1e3,
            "longest_cta_us": float(dur[i]) / 1e3, "longest_cta": i,
            "longest_cta_start_us": float(rec[i, 1] - t0) / 1e3,
            "cta_us": distribution(dur / 1e3),
            "cta_clock64": distribution(rec[:, 0]),
            "half_ctas_done_us": float(ends[len(ends) // 2]) / 1e3,
            "p90_ctas_done_us": float(ends[int(len(ends) * 0.9)]) / 1e3,
            "sms": n_sm,
            "sm_busy_share": float(dur.sum() / (n_sm * (t1 - t0)))}


def _upstream(nt, channels, seed, device):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(nt, 256, channels, generator=g).to(device),
            torch.randn(nt, 256, generator=g).to(device))


def _baselines(dirs, name: str) -> dict:
    """{label: library} of the baseline directories holding
    ``<name>.cu`` (label: the directory's name)."""
    return {os.path.basename(os.path.normpath(d)): cuda_build.load(
        name, csrc_dir=d) for d in dirs
        if os.path.isfile(os.path.join(d, name + ".cu"))}


def _in_turns(runs: dict, reps: int, device) -> dict:
    """ms of each run: every run once in turn, then again in the reverse
    turn."""
    labels = list(runs)
    ms = {k: [] for k in labels}
    for k in labels + labels[::-1]:
        ms[k].append(_timed_ms(runs[k], reps, device))
    return ms


def profile_shape(tag, inputs, args, device, kernel):
    stream, starts, order, nt, gx, channels, config = inputs
    rec = {"shape": tag, "entries": int(stream.shape[0]),
           "channels": channels, "chunk": config.chunk_size}
    c1 = config._replace(downscale=1)
    _, t, cnt = RS.blend_tiles(stream, starts, order, nt, gx, channels, c1,
                               with_contrib=True)
    rec["work"] = tile_work(starts, order, cnt, config.chunk_size,
                            forward=kernel == "forward")
    if kernel == "forward":
        name = "stream_blend"

        def call(order=order):
            return RS.blend_tiles(stream, starts, order, nt, gx, channels,
                                  config)[0]

        def other(lib):
            with cuda_build.use_library(name, lib):
                return call()
        ids = torch.arange(nt, dtype=torch.int32, device=device)
        runs = {"current": call,
                "ascending tile ids": lambda: call(ids)}
    else:
        name = "stream_blend_bwd"
        dl_dout, dt_tot = _upstream(nt, channels, 11, device)
        bargs = (stream, starts, order, dl_dout, cnt, dt_tot, t, gx,
                 channels, config)

        def call():
            return RV.blend_tiles_bwd(*bargs)

        def other(lib):
            if not hasattr(lib, "gpcr_bwd_segment_length"):
                return _parent_bwd(lib, *bargs)
            with cuda_build.use_library(name, lib):
                return call()
        runs = {"current": call}
    for label, lib in _baselines(args.baseline, name).items():
        runs[label] = lambda lib=lib: other(lib)
    ref = call()
    rec["max_abs_vs_current"] = {
        k: float((fn() - ref).abs().max()) for k, fn in runs.items()}
    rec["ms"] = _in_turns(runs, args.reps, device)
    count_libs = _baselines(args.baseline, "stream_blend")
    if kernel == "backward" and count_libs:
        # the contributor-count forward (same source as the serving blend)
        # beside the baselines'
        fwd = (stream, starts, order, nt, gx, channels, c1)

        def count():
            return RS.blend_tiles(*fwd, with_contrib=True)

        def count_other(lib):
            with cuda_build.use_library("stream_blend", lib):
                return count()
        cruns = {"current": count}
        for label, lib in count_libs.items():
            cruns[label] = lambda lib=lib: count_other(lib)
        rec["count_max_abs_vs_current"] = {
            k: max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(fn(), count()))
            for k, fn in cruns.items()}
        rec["count_ms"] = _in_turns(cruns, args.reps, device)
    if args.diag:
        dlib = cuda_build.load(name, defines=("GPCR_DIAG",))
        setter = ("gpcr_stream_blend_set_diag" if kernel == "forward"
                  else "gpcr_stream_blend_bwd_set_diag")
        n_ctas = stream.shape[0] // 16 + order.numel() + 1
        with cuda_build.use_library(name, dlib):
            rec["diag"] = _spans(call, dlib, setter, n_ctas, device)
    print(json.dumps({"profile_blend": kernel, **rec}), flush=True)
    return rec


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_points", type=int, default=800_000)
    ap.add_argument("--train_points", type=int, default=200_000)
    ap.add_argument("--analytic_points", type=int, default=800_000)
    ap.add_argument("--channels", type=str, default="9 32 64 128 256 128")
    ap.add_argument("--hw", type=int, default=512,
                    help="training view side")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--baseline", type=str, action="append", default=[],
                    help="directory with another version's kernel sources "
                         "(repeatable)")
    ap.add_argument("--diag", action="store_true",
                    help="per-CTA spans from a -DGPCR_DIAG build")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if device.type != "cuda" and (args.baseline or args.diag):
        raise ValueError("--baseline and --diag build CUDA kernels")
    RD.pin_fp32()
    from ..train.trainer import Trainer

    info = dict(LEARNED_INFO, clr_encoder_channels=args.channels)
    rdr = RD.PCMLRender(info=info, voxelized=True, scale_factor=448,
                        device=device)
    xyz, rgb = synthetic_cloud(args.n_points, 448)
    sp = learned_splats(rdr, PointCloud.from_numpy(xyz, rgb, device=device))
    trainer = Trainer(info=info, render_hw=(args.hw, args.hw), device=device,
                      generator=torch.Generator().manual_seed(0))
    out = []
    out.append(profile_shape("learned view 0", view0_stream(sp), args,
                             device, "forward"))
    out.append(profile_shape(
        "training view 0",
        train_view0(trainer, args.train_points, args.hw)[:7], args, device,
        "backward"))
    out.append(profile_shape(
        "800K analytic", analytic_view0(args.analytic_points, device),
        args, device, "backward"))
    return out


if __name__ == "__main__":
    main()
