"""Per-tile work, per-CTA spans, per-warp records and timings in one
process of the four blend kernels at their main-path shapes: the serving
stream blend (kernel 1) and the contributor-count forward (kernel 2) of
``csrc/stream_blend.cu``, the replay backward (kernel 3,
``csrc/stream_blend_bwd.cu``) and the aligned all-tiles blend (kernel 4,
``csrc/aligned_blend.cu``):

    python -m gpcr_tpu_torch.cli.profile_blend                 # on the card
    python -m gpcr_tpu_torch.cli.profile_blend --diag --kernels 2,4 \
        --baseline DIR [--baseline DIR2 ...]
    python -m gpcr_tpu_torch.cli.profile_blend --n_points 3000 \
        --train_points 2000 --channels "9 8 8 8 8 8" --hw 64 \
        --analytic_points 3000 --device cpu

Shapes (each built from a seed, ``utils/blend_inputs.py``):

- learned view 0: the synthetic 800K-point cloud of ``profile_pcrender``
  through ``PCEncoder`` at the deployed width with seeded weights, the
  ``pcrender`` CLI's first camera (512² x2), dup cap 256, chunk 256, C =
  12: kernel 1 (downscale 2) and kernel 4 (its chunk-aligned layout of the
  same entries, all 4,096 tiles);
- training view 0: the trainer's seeded weights on the first 200K-point
  example of the ``train`` CLI's loader (512², chunk 64, C = 12): kernels
  2 and 3;
- 800K analytic: isotropic gaussians on a stretched sphere, 1024², C = 3,
  dup cap 8, chunk 128 (``chip_smoke.py``'s rasterizer-only shape):
  kernels 2 and 3.

Per kernel and shape it prints one JSON line: the distribution over
rendered tiles of the entries (kernel 4: chunks) per tile and of those a
tile's CTA walks (max, p99, median), the share of a CTA's walked (entry,
pixel) slots that belong to pixels already stopped, and CUDA-event times
of this tree's kernel, in turns with each ``--baseline DIR`` (repeatable;
a directory holding another version's ``stream_blend.cu``,
``stream_blend_bwd.cu`` and / or ``aligned_blend.cu`` with the ``.cuh``
they include, e.g. ``git show <rev>:...`` or a copy with one step undone)
and, for kernels 1, 2 and 4, with its tiles launched by ascending id
instead of longest first: every run once, then again in the reverse turn.
A baseline serving blend is called with the parameters its source
declares; a baseline replay backward whose C entry takes no scratch, and
a baseline aligned blend whose C entry takes no tile order, are called
through their own interfaces. With ``--diag`` it builds every library that has the
diagnostic setters with ``-DGPCR_DIAG`` and adds per-CTA spans (global
timer) and SM ids (the kernel's span, the longest CTA and its start, when
half and 90% of the CTAs were done, the SMs' busy share) and, from the
per-warp record, each warp's visited entries, its cycles waiting for a
chunk (at a CTA barrier or a ring stage) and its cycles in all: over all
CTAs and for the longest CTA, warp by warp.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import re
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import cuda_build
from ..ops import rasterize_aligned as RA
from ..ops import rasterize_stream as RS
from ..ops import rasterize_stream_vjp as RV
from ..render import renderer as RD
from ..structures.pointcloud import PointCloud
from ..utils.blend_inputs import (aligned_view0, aligned_work, analytic_view0,
                                  distribution, learned_splats, tile_work,
                                  train_view0, view0_stream)
from .profile_pcrender import LEARNED_INFO, synthetic_cloud

SOURCES = ("stream_blend", "stream_blend_bwd", "aligned_blend")


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


@functools.lru_cache(maxsize=None)
def _c_params(src_dir: str, name: str, entry: str):
    """[(parameter name, is a pointer)] of the C entry ``entry`` as
    ``<src_dir>/<name>.cu`` declares it (read once: the timed calls must
    not wait on the host)."""
    with open(os.path.join(src_dir, name + ".cu")) as f:
        m = re.search(r"\b" + entry + r"\(([^)]*)\)\s*\{", f.read())
    if m is None:
        raise ValueError(f"no {entry}(...) in {src_dir}/{name}.cu")
    return [(re.split(r"[\s*]+", p.strip())[-1], "*" in p)
            for p in m.group(1).split(",")]


def _serving(lib, stream, starts, order, nt, gx, channels, config):
    """Kernel 1 of ``lib``. A baseline's ``gpcr_stream_blend`` is called
    with the parameters its source declares, by name (a version before
    the tile window has no ``tile_base``)."""
    if not hasattr(lib, "source_dir"):  # this tree's build
        with cuda_build.use_library("stream_blend", lib):
            return RS.blend_tiles(stream, starts, order, nt, gx, channels,
                                  config)
    p_out = 256 // config.downscale ** 2
    acc = torch.zeros((nt, p_out, channels), device=stream.device)
    t = torch.ones((nt, p_out), device=stream.device)
    value = {
        "stream": stream.data_ptr(), "ncols": stream.shape[1],
        "starts": starts.data_ptr(), "order": order.data_ptr(),
        "n_order": order.numel(), "grid_x": gx, "tile_base": 0,
        "channels": channels, "chunk": config.chunk_size,
        "downscale": config.downscale, "acc_out": acc.data_ptr(),
        "t_out": t.data_ptr(),
        "cuda_stream": torch.cuda.current_stream(stream.device).cuda_stream,
    }
    params = _c_params(lib.source_dir, "stream_blend", "gpcr_stream_blend")
    fn = lib.gpcr_stream_blend
    fn.argtypes = [ctypes.c_void_p if ptr else ctypes.c_int
                   for _, ptr in params]
    fn.restype = ctypes.c_int
    rc = fn(*(value[k] for k, _ in params))
    if rc != 0:
        raise RuntimeError(f"baseline stream_blend launch failed ({rc})")
    return acc, t


def _aligned(lib, cstarts, scal, feat, nt, gx, channels, config, order):
    """Kernel 4 of ``lib`` on the layout, tiles launched in ``order``. A
    version whose C entry takes no tile order (one CTA per tile id, the
    versions before the ring) is called through its own interface and
    ignores ``order``."""
    if hasattr(lib, "gpcr_aligned_blend_stages"):
        with cuda_build.use_library("aligned_blend", lib):
            return RA._blend_aligned_cuda(cstarts, scal, feat, nt, gx,
                                          channels, config, order=order)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.gpcr_aligned_blend
    fn.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp]
    fn.restype = ci
    acc = torch.empty((nt, 256, channels), device=scal.device)
    t = torch.empty((nt, 256), device=scal.device)
    rc = fn(cstarts.data_ptr(), scal.data_ptr(), feat.data_ptr(),
            scal.shape[0], nt, gx, channels, config.chunk_size,
            acc.data_ptr(), t.data_ptr(),
            torch.cuda.current_stream(scal.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"baseline aligned_blend launch failed ({rc})")
    return acc, t


def _set_buffer(lib, setter: str, buf) -> None:
    fn = getattr(lib, setter)
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    rc = fn(buf.data_ptr())
    if rc != 0:
        raise RuntimeError(f"{setter} failed ({rc})")


def _spans(fn, lib, setter: str, n_ctas: int, device) -> dict:
    """Launch ``fn`` once with the diagnostic build ``lib`` and summarise
    its CTAs' records (4 int64 each: clock64 span, global start and end in
    ns, SM id) and, where the build has them, its warps' (visited entries,
    cycles waiting for a chunk, cycles in all, chunks walked)."""
    buf = torch.zeros((n_ctas, 4), dtype=torch.int64, device=device)
    _set_buffer(lib, setter, buf)
    wbuf = None
    if hasattr(lib, setter + "_warp"):
        wbuf = torch.zeros((n_ctas, 8, 4), dtype=torch.int64, device=device)
        _set_buffer(lib, setter + "_warp", wbuf)
    fn()
    torch.cuda.synchronize()
    used = buf[:, 2] > 0
    if not bool(used.any()):
        return {"ctas": 0}  # a build whose kernel records no span
    rec = buf[used].cpu().double()
    t0, t1 = rec[:, 1].min(), rec[:, 2].max()
    dur = rec[:, 2] - rec[:, 1]
    i = int(dur.argmax())
    n_sm = int(rec[:, 3].max()) + 1
    ends = torch.sort(rec[:, 2] - t0).values
    out = {"ctas": int(rec.shape[0]), "span_us": float(t1 - t0) / 1e3,
           "longest_cta_us": float(dur[i]) / 1e3,
           "longest_cta_start_us": float(rec[i, 1] - t0) / 1e3,
           "cta_us": distribution(dur / 1e3),
           "cta_clock64": distribution(rec[:, 0]),
           "half_ctas_done_us": float(ends[len(ends) // 2]) / 1e3,
           "p90_ctas_done_us": float(ends[int(len(ends) * 0.9)]) / 1e3,
           "sms": n_sm,
           "sm_busy_share": float(dur.sum() / (n_sm * (t1 - t0)))}
    if wbuf is not None:
        w = wbuf[used].cpu().double()  # (ctas, 8, [visited, wait, all, chunks])
        lw = w[i]
        out["warps"] = {
            "wait_share": float(w[..., 1].sum() / w[..., 2].sum()),
            "visited": distribution(w[..., 0].flatten()),
            "longest_cta": {
                "visited": lw[:, 0].long().tolist(),
                "wait_cycles": lw[:, 1].long().tolist(),
                "cycles": lw[:, 2].long().tolist(),
                "chunks": lw[:, 3].long().tolist(),
                "wait_share": float(lw[:, 1].sum() / lw[:, 2].sum()),
                "walk_share_of_span": float(
                    (lw[:, 2] - lw[:, 1]).max() / rec[i, 0])}}
    return out


def _upstream(nt, channels, seed, device):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(nt, 256, channels, generator=g).to(device),
            torch.randn(nt, 256, generator=g).to(device))


def _baselines(dirs, name: str, defines=()) -> dict:
    """{label: library} of the baseline directories holding
    ``<name>.cu`` (label: the directory's name); each library's
    ``source_dir`` is its directory."""
    libs = {}
    for d in dirs:
        if os.path.isfile(os.path.join(d, name + ".cu")):
            lib = cuda_build.load(name, csrc_dir=d, defines=defines)
            lib.source_dir = d
            libs[os.path.basename(os.path.normpath(d))] = lib
    return libs


def _in_turns(runs: dict, reps: int, device) -> dict:
    """ms of each run: every run once in turn, then again in the reverse
    turn."""
    labels = list(runs)
    ms = {k: [] for k in labels}
    for k in labels + labels[::-1]:
        ms[k].append(_timed_ms(runs[k], reps, device))
    return ms


def _max_abs(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b))


def _measure(rec, name, call, variant, runs, args, device, setter, n_ctas):
    """Time ``runs`` (label -> fn returning the outputs) in turns, after
    holding each against ``call``; with ``--diag`` add the spans of this
    tree's diagnostic build and of each baseline's (``variant(lib)``
    runs ``call`` through another library)."""
    ref = call()
    rec["max_abs_vs_current"] = {k: _max_abs(fn(), ref)
                                 for k, fn in runs.items()}
    rec["ms"] = _in_turns(runs, args.reps, device)
    if args.diag:
        libs = {"current": cuda_build.load(name, defines=("GPCR_DIAG",))}
        libs.update(_baselines(args.baseline, name, ("GPCR_DIAG",)))
        rec["diag"] = {label: _spans(lambda lib=lib: variant(lib), lib,
                                     setter, n_ctas, device)
                       for label, lib in libs.items()
                       if hasattr(lib, setter)}


def profile_serving(tag, inputs, args, device):
    """Kernel 1 at the learned view 0."""
    stream, starts, order, nt, gx, channels, config = inputs
    rec = {"kernel": 1, "shape": tag, "entries": int(stream.shape[0]),
           "channels": channels, "chunk": config.chunk_size}
    c1 = config._replace(downscale=1)
    _, _, cnt = RS.blend_tiles(stream, starts, order, nt, gx, channels, c1,
                               with_contrib=True)
    rec["work"] = tile_work(starts, order, cnt, config.chunk_size, True)

    def call(order=order):
        return RS.blend_tiles(stream, starts, order, nt, gx, channels, config)

    def variant(lib):
        return _serving(lib, stream, starts, order, nt, gx, channels, config)
    ids = torch.arange(nt, dtype=torch.int32, device=device)
    runs = {"current": call, "ascending tile ids": lambda: call(ids)}
    for label, lib in _baselines(args.baseline, "stream_blend").items():
        runs[label] = lambda lib=lib: variant(lib)
    _measure(rec, "stream_blend", call, variant, runs, args, device,
             "gpcr_stream_blend_set_diag", order.numel())
    print(json.dumps({"profile_blend": "serving", **rec}), flush=True)
    return rec


def profile_count(tag, inputs, args, device):
    """Kernel 2 (the contributor-count forward) at a training shape."""
    stream, starts, order, nt, gx, channels, config = inputs
    c1 = config._replace(downscale=1)
    rec = {"kernel": 2, "shape": tag, "entries": int(stream.shape[0]),
           "channels": channels, "chunk": config.chunk_size}

    def call(order=order):
        return RS.blend_tiles(stream, starts, order, nt, gx, channels, c1,
                              with_contrib=True)
    rec["work"] = tile_work(starts, order, call()[2], config.chunk_size, True)

    def variant(lib):
        with cuda_build.use_library("stream_blend", lib):
            return call()
    ids = torch.arange(nt, dtype=torch.int32, device=device)
    runs = {"current": call, "ascending tile ids": lambda: call(ids)}
    for label, lib in _baselines(args.baseline, "stream_blend").items():
        runs[label] = lambda lib=lib: variant(lib)
    _measure(rec, "stream_blend", call, variant, runs, args, device,
             "gpcr_stream_blend_set_diag", order.numel())
    print(json.dumps({"profile_blend": "count", **rec}), flush=True)
    return rec


def profile_backward(tag, inputs, args, device):
    """Kernel 3 (the replay backward) at a training shape."""
    stream, starts, order, nt, gx, channels, config = inputs
    c1 = config._replace(downscale=1)
    rec = {"kernel": 3, "shape": tag, "entries": int(stream.shape[0]),
           "channels": channels, "chunk": config.chunk_size}
    _, t, cnt = RS.blend_tiles(stream, starts, order, nt, gx, channels, c1,
                               with_contrib=True)
    rec["work"] = tile_work(starts, order, cnt, config.chunk_size, False)
    dl_dout, dt_tot = _upstream(nt, channels, 11, device)
    bargs = (stream, starts, order, dl_dout, cnt, dt_tot, t, gx, channels,
             config)

    def call():
        return (RV.blend_tiles_bwd(*bargs),)

    def variant(lib):
        if not hasattr(lib, "gpcr_bwd_segment_length"):
            return (_parent_bwd(lib, *bargs),)
        with cuda_build.use_library("stream_blend_bwd", lib):
            return call()
    runs = {"current": call}
    for label, lib in _baselines(args.baseline, "stream_blend_bwd").items():
        runs[label] = lambda lib=lib: variant(lib)
    _measure(rec, "stream_blend_bwd", call, variant, runs, args, device,
             "gpcr_stream_blend_bwd_set_diag",
             stream.shape[0] // 16 + order.numel() + 1)
    print(json.dumps({"profile_blend": "backward", **rec}), flush=True)
    return rec


def profile_aligned(tag, inputs, args, device):
    """Kernel 4 on the chunk-aligned layout of the learned view 0."""
    (cstarts, scal, feat, nt, gx, channels, config), n_contrib, counts = \
        inputs
    rec = {"kernel": 4, "shape": tag, "slots": int(scal.shape[0]
                                                   * scal.shape[2]),
           "chunks": int(scal.shape[0]), "tiles": nt, "channels": channels,
           "chunk": config.chunk_size}
    rec["work"] = aligned_work(cstarts, n_contrib, counts, config.chunk_size)
    order = RA.aligned_order(cstarts)
    ids = torch.arange(nt, dtype=torch.int32, device=device)
    args4 = (cstarts, scal, feat, nt, gx, channels, config)

    def call(order=order):
        if device.type != "cuda":
            return RA.blend_aligned_tiles(*args4)
        return RA._blend_aligned_cuda(*args4, order=order)

    def variant(other):
        return _aligned(other, *args4, order)
    runs = {"current": call, "ascending tile ids": lambda: call(ids)}
    for label, other in _baselines(args.baseline, "aligned_blend").items():
        runs[label] = lambda other=other: variant(other)
    _measure(rec, "aligned_blend", call, variant, runs, args, device,
             "gpcr_aligned_blend_set_diag", nt)
    print(json.dumps({"profile_blend": "aligned", **rec}), flush=True)
    return rec


def _prebuild(args) -> None:
    """Build every library the run loads, one nvcc each, all at once."""
    jobs = [(cuda_build.CSRC_DIR, n, ()) for n in SOURCES]
    if args.diag:
        jobs += [(cuda_build.CSRC_DIR, n, ("GPCR_DIAG",)) for n in SOURCES]
    for d in args.baseline:
        for n in SOURCES:
            if os.path.isfile(os.path.join(d, n + ".cu")):
                jobs.append((d, n, ()))
                if args.diag:
                    jobs.append((d, n, ("GPCR_DIAG",)))
    with ThreadPoolExecutor(len(jobs)) as pool:
        for job in [pool.submit(cuda_build.load, n, csrc_dir=d, defines=df)
                    for d, n, df in jobs]:
            job.result()


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_points", type=int, default=800_000)
    ap.add_argument("--train_points", type=int, default=200_000)
    ap.add_argument("--analytic_points", type=int, default=800_000)
    ap.add_argument("--channels", type=str, default="9 32 64 128 256 128")
    ap.add_argument("--hw", type=int, default=512,
                    help="training view side")
    ap.add_argument("--kernels", type=str, default="1,2,3,4",
                    help="which kernels to profile (comma-separated 1-4)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--baseline", type=str, action="append", default=[],
                    help="directory with another version's kernel sources "
                         "(repeatable)")
    ap.add_argument("--diag", action="store_true",
                    help="per-CTA spans and per-warp records from "
                         "-DGPCR_DIAG builds")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    kernels = {int(k) for k in args.kernels.split(",")}
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but no CUDA device is available")
    if device.type != "cuda" and (args.baseline or args.diag):
        raise ValueError("--baseline and --diag build CUDA kernels")
    RD.pin_fp32()
    if device.type == "cuda":
        _prebuild(args)
    from ..train.trainer import Trainer

    info = dict(LEARNED_INFO, clr_encoder_channels=args.channels)
    out = []
    if kernels & {1, 4}:
        rdr = RD.PCMLRender(info=info, voxelized=True, scale_factor=448,
                            device=device)
        xyz, rgb = synthetic_cloud(args.n_points, 448)
        sp = learned_splats(rdr, PointCloud.from_numpy(xyz, rgb,
                                                       device=device))
        serve = view0_stream(sp)
        if 1 in kernels:
            out.append(profile_serving("learned view 0", serve, args, device))
        if 4 in kernels:
            stream, starts, order, nt, gx, channels, config = serve
            _, _, cnt = RS.blend_tiles(stream, starts, order, nt, gx,
                                       channels,
                                       config._replace(downscale=1),
                                       with_contrib=True)
            out.append(profile_aligned(
                "learned view 0",
                (aligned_view0(sp), cnt, starts[1:] - starts[:-1]), args,
                device))
        del sp, serve
    if kernels & {2, 3}:
        trainer = Trainer(info=info, render_hw=(args.hw, args.hw),
                          device=device,
                          generator=torch.Generator().manual_seed(0))
        shapes = [("training view 0",
                   train_view0(trainer, args.train_points, args.hw)[:7]),
                  ("800K analytic",
                   analytic_view0(args.analytic_points, device))]
        for tag, inputs in shapes:
            if 2 in kernels:
                out.append(profile_count(tag, inputs, args, device))
            if 3 in kernels:
                out.append(profile_backward(tag, inputs, args, device))
    return out


if __name__ == "__main__":
    main()
