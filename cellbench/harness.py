"""One run of one cell: set-up, the measured window, the traced extras,
the reference check, the metrics and the result line.

A cell is ``workloads/<cell>.json`` (its configuration, traffic mix,
request counts and check limits); it names ``configs/<config>.json`` and
``traffic/<mix>.json``; the metrics it reports are the ``BENCHMARK.json``
entries that list it (or list no cells), each read by
``metrics/<metric>.py``. Nothing here names a cell, a configuration or a
metric.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
import typing as T

import numpy as np

from . import measure, scene, systems
from .reference import raster

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
PROGRAM = "gpcr_tpu_torch"
SPAN = "cellbench.request"
HIT = slice(6, 9)  # output channels: rgb, xyz_w, hitmap (, normal)
FORBIDDEN = ("jax", "jaxlib", "flax", "gpcr_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = HERE, manifest: T.Optional[dict] = None):
    """The cell's workload, configuration and traffic files, and the
    manifest's metrics that this cell reports."""
    work = load_json(os.path.join(root, "workloads", name + ".json"))
    cfg = load_json(os.path.join(root, "configs", work["config"] + ".json"))
    traffic = load_json(os.path.join(root, "traffic", work["traffic"] + ".json"))
    if manifest is None:
        manifest = load_json(os.path.join(os.path.dirname(root),
                                          "BENCHMARK.json"))

    def listed(kind):
        return [m for m in manifest[kind]
                if "workloads" not in m or name in m["workloads"]]

    return {"name": name, "workload": work, "config": cfg,
            "traffic": traffic, "end_to_end": listed("end_to_end"),
            "per_layer": listed("per_layer"), "root": root}


def load_reader(metric: str, root: str = HERE):
    """``read(ctx)`` of ``metrics/<base>.py``, base being the metric's name
    up to its first dot: ``rgb_ms`` and ``rgb_ms.splat`` are one quantity
    reported in cells that move different end-to-end metrics."""
    base = metric.split(".")[0]
    path = os.path.join(root, "metrics", base + ".py")
    spec = importlib.util.spec_from_file_location(
        "cellbench_metric_" + base.replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def forbidden_modules() -> T.List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``gpcr_tpu_torch`` is not ``gpcr_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Ctx:
    """What the metric readers read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = dataclasses.field(default_factory=list)
    timings: list = dataclasses.field(default_factory=list)
    completed: int = 0
    syncs_per_request: T.Optional[float] = None
    trace: T.Optional[dict] = None
    traced_work: list = dataclasses.field(default_factory=list)
    network_flops: T.Optional[int] = None
    peaks: T.Optional[dict] = None

    @property
    def request_ms(self) -> T.Optional[float]:
        if not self.completed:
            return None
        return self.window_s * 1e3 / self.completed


@contextlib.contextmanager
def quiet():
    """The renderer prints a timing line per call; keep stdout for the
    result."""
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        yield


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _profile(torch, call, poses_list, device, host: bool):
    """Run the requests of ``poses_list`` under ``torch.profiler``, device
    activity only unless ``host`` (recording host ops slows the host-paced
    loop, so busy and window are read without them): (outputs, device
    intervals (name, start, end) in us, host spans (name, start, end) in
    us, window seconds on the host clock)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else []
    if host or not cuda:
        acts.append(ProfilerActivity.CPU)
    outs = []
    _sync(torch, device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for poses in poses_list:
            with record_function(SPAN):
                outs.append(call(poses, {}))
                _sync(torch, device)
        window = time.perf_counter() - t0
    dev, hosts = [], []
    for e in prof.events():
        span = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type.name != "CUDA":
            hosts.append(span)
        elif not (getattr(e, "is_user_annotation", False) or e.name == SPAN):
            dev.append(span)  # not the device copy of a record_function
    return outs, dev, hosts, window


def _traced(torch, call, poses_list, extra_poses, device):
    """Busy and window seconds and device time by op name over the
    requests of ``poses_list`` (device activity only), and the longest idle
    gaps named by what the host was doing, from one more request traced
    with host ops: (outputs of ``poses_list``, trace dict, or None where
    the profiler recorded no device activity: the trace metrics are then
    left out)."""
    outs, dev, _, window = _profile(torch, call, poses_list, device, False)
    if not dev:
        log("# trace: the profiler recorded no device activity; the "
            "trace metrics are left out")
        return outs, None
    by_name: dict = {}
    for name, s, t in dev:
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [[k if len(k) <= 160 else k[:157] + "...", v] for k, v in top]
    _, dev2, hosts, _ = _profile(torch, call, [extra_poses], device, True)
    spans = [(s, t) for name, s, t in hosts if name == SPAN]
    idle = measure.gaps([(s, t) for _, s, t in dev2],
                        min(s for s, _ in spans), max(t for _, t in spans))
    return outs, {
        "busy_s": measure.union_length([(s, t) for _, s, t in dev]) / 1e6,
        "window_s": window, "requests": len(poses_list),
        "by_name": by_name, "device_ops": top,
        "idle_gaps": measure.label_gaps(idle, hosts),
    }


def port_views(out: dict, with_normal: bool):
    """(views, h, w, C) of a program output, channels as the reference's."""
    import torch

    keys = systems.OUTPUTS if with_normal else systems.OUTPUTS[:3]
    return torch.cat([out[k][0] for k in keys], dim=-1)


def compare(port, ref) -> dict:
    """Numbers of one view: (h, w, C) program image against the reference's
    (C, h, w): mean |d| over every value (``image_mae``) and over the hit
    map (``hit_mae``: coverage 1 - T, which no depth-order or normal-sign
    flip between overlapping splats changes), the share of pixels off by
    more than 0.01 somewhere and the widest gap."""
    import torch

    d = (port - ref.permute(1, 2, 0)).abs()
    if not bool(torch.isfinite(port).all()):
        return {"image_mae": float("inf"), "hit_mae": float("inf"),
                "px_off_share": 1.0, "max_abs": float("inf")}
    return {"image_mae": float(d.mean()),
            "hit_mae": float(d[..., HIT].mean()),
            "px_off_share": float((d.amax(-1) > 1e-2).float().mean()),
            "max_abs": float(d.max())}


def check(cell: dict, kept: list, ref: dict, system, device):
    """Compare every kept request's views with the reference: (numbers
    (worst view of each), per-request work dicts keyed by request)."""
    import torch

    traffic, cfg = cell["traffic"], cell["config"]
    ss = traffic["supersample"]
    h, w = traffic["height"] * ss, traffic["width"] * ss
    bg3 = torch.full((3,), float(cfg["background"]), device=device)
    worst = {"image_mae": 0.0, "hit_mae": 0.0, "px_off_share": 0.0,
             "max_abs": 0.0, "views_missing": 0}
    work = {}
    for tag, poses, out in kept:
        views = poses.shape[0]
        port = None
        if out is not None:
            port = port_views(out, system.WITH_NORMAL)
            if tuple(port.shape) != (views, traffic["height"],
                                     traffic["width"],
                                     12 if system.WITH_NORMAL else 9):
                log(f"# request {tag}: output shape {tuple(port.shape)}")
                port = None
        if port is None:
            worst["views_missing"] += views
            continue
        per = []
        for v in range(views):
            img, wk = raster.render_view(
                ref, poses[v], traffic["fov_deg"], h, w, cfg["raster"], bg3,
                system.WITH_NORMAL)
            wk["pixels_per_tile"] = (16 // ss) ** 2
            per.append(wk)
            nums = compare(port[v], img)
            for k, val in nums.items():
                worst[k] = max(worst[k], val)
        work[tag] = per
    return worst, work


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: str = HERE,
        manifest: T.Optional[dict] = None,
        wrap: T.Optional[T.Callable] = None) -> dict:
    """Run one cell; returns the result dict (``print_result`` prints it)
    or raises. ``wrap`` (tests) wraps the program's call."""
    t_proc = measure.process_start_time()
    import torch

    cell = load_cell(workload, root, manifest)
    work, cfg, traffic = cell["workload"], cell["config"], cell["traffic"]
    system = systems.load(cfg["renderer"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- set-up: inputs from the seed, the program, warm requests ------
    inputs = system.make_inputs(cfg, seed, device)
    prog = system.Program(cfg, traffic, inputs, device)
    call = wrap(prog) if wrap else prog
    cams = scene.Cameras(traffic, seed, device)
    with quiet():
        for i in range(work["warm_requests"]):
            call(cams.warm(i), {})
            _sync(torch, device)
    ctx = Ctx(setup_s=time.time() - t_proc)

    # ---- the window: closed loop, one client ---------------------------
    rng = np.random.default_rng([int(seed), scene.STREAM_SAMPLE])
    k = work["sample_requests"]
    sample: list = []  # reservoir of (request, poses, output)
    failed, i = 0, 0
    t0 = time.perf_counter()
    with quiet():
        while time.perf_counter() - t0 < seconds:
            poses, tm = cams.request(i), {}
            ts = time.perf_counter()
            try:
                out = call(poses, tm)
                _sync(torch, device)
            except Exception as e:  # a failed request is counted, not hidden
                failed += 1
                out = None
                log(f"# request {i} failed: {type(e).__name__}: {e}")
            ctx.latencies_s.append(time.perf_counter() - ts)
            ctx.timings.append(tm)
            j = i if i < k else int(rng.integers(0, i + 1))
            if j < k:
                item = (i, poses, out)
                sample[j:j + 1] = [item]
            i += 1
            out = None
    ctx.window_s = time.perf_counter() - t0
    ctx.completed = i - failed
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    name = torch.cuda.get_device_name() if cuda else "cpu"
    ctx.peaks = measure.peaks_for(name) if cuda else None

    # ---- traced extras: host syncs, then a profiled stretch -----------
    kept = list(sample)
    if trace:
        nxt = i
        if cuda:
            n_sync = work["sync_requests"]
            with quiet():
                total, by_line = measure.count_host_syncs(
                    torch, lambda: [call(cams.request(nxt + s), {})
                                    for s in range(n_sync)],
                    os.path.join(REPO, PROGRAM))
            ctx.syncs_per_request = total / n_sync
            log("# host syncs by line over %d request(s): %s"
                % (n_sync, json.dumps(dict(by_line.most_common(12)))))
            nxt += n_sync
        n_trace = work["trace_requests"]
        traced_poses = [cams.request(nxt + s) for s in range(n_trace)]
        with quiet():
            outs, ctx.trace = _traced(torch, call, traced_poses,
                                      cams.request(nxt + n_trace), device)
        kept += [(("trace", s), p, o)
                 for s, (p, o) in enumerate(zip(traced_poses, outs))]
    del prog, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the reference check -------------------------------------------
    t_ref = time.perf_counter()
    with torch.no_grad():
        ref = system.reference_splats(cfg, inputs)
        worst, per_request = check(cell, kept, ref, system, device)
    ctx.network_flops = ref["flops"]
    ctx.traced_work = [v for tag, v in per_request.items()
                       if isinstance(tag, tuple)]
    limits = work["limits"]
    checks = {"views_missing": {"value": worst["views_missing"], "limit": 0}}
    for key, lim in limits.items():
        checks[key] = {"value": worst[key], "limit": lim}
    correct = (failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in checks.values()))
    dropped = sum(wk["dropped"] for per in per_request.values() for wk in per)
    log(f"# window: {i} requests in {ctx.window_s:.3f} s, {failed} failed; "
        f"latency p50 {measure.percentile(ctx.latencies_s, 50) * 1e3:.3f} ms, "
        f"p95 {measure.percentile(ctx.latencies_s, 95) * 1e3:.3f} ms; "
        f"set-up {ctx.setup_s:.3f} s; peak {peak / 2**30:.3f} GiB; "
        f"program dropped entries "
        f"{sum(t.get('dup_overflow', 0) for t in ctx.timings)}")
    log(f"# reference: {len(kept)} requests checked in "
        f"{time.perf_counter() - t_ref:.3f} s; voxels {ref['voxels']}, "
        f"network flops per pass {ref['flops']}, entries dropped by the "
        f"configuration's caps {dropped}; worst view: max|d| "
        f"{worst['max_abs']:.6g}, share of pixels off by > 0.01 "
        f"{worst['px_off_share']:.6g}")

    # ---- metrics ---------------------------------------------------------
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        value = load_reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct, "attempted": i, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": 1, "memory_peak_bytes": int(peak)},
    }
    if trace and ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace["busy_s"]
        result["device"]["window_s"] = ctx.trace["window_s"]
        result["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                               "idle_gaps": ctx.trace["idle_gaps"]}
    result["checks"] = checks
    return result


def print_result(result: dict, out=None, err=None) -> int:
    """Print the compared numbers (last on stderr) and the result line
    (last on stdout); refuse (exit 3, no result) if JAX or the JAX
    package was loaded."""
    out, err = out or sys.stdout, err or sys.stderr
    forbidden = forbidden_modules()
    if forbidden:
        print(f"refused: loaded {forbidden} (JAX or the JAX package)",
              file=err, flush=True)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
