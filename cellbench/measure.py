"""The benchmark's arithmetic: percentiles, the device-busy union and idle
gaps of a profiler trace, host syncs under the sync debug mode, the
blend's roofline bound and the whole step's share of the peak, and the
table of peaks. Nothing here imports the program."""

from __future__ import annotations

import collections
import math
import os
import time
import traceback
import warnings

# Published peaks (NVIDIA data sheet, dense, at the full power limit):
# float32 outside the tensor cores, and HBM bandwidth. The renderer pins
# TF32 off, so float32 is its arithmetic.
PEAKS = {
    "H100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}

# float32 operations per (entry, pixel) pair the blend walks: dx, dy (2),
# power (9), the power > 0 test, exp (1), opacity * exp, min 0.99, the
# 1/255 test (16); and per live pair: 1 - a, T (1 - a), the stop test,
# the weight a T (4), and C multiply-adds (2 C)
OPS_PER_WALKED = 16
OPS_PER_LIVE_BASE = 4


def peaks_for(device_name: str):
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None


def process_start_time() -> float:
    """Wall-clock time at which this process started (Linux /proc), else
    now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + ticks / hz
    except (OSError, ValueError, IndexError):
        return time.time()


def percentile(values, q: float) -> float:
    """Linear interpolation between the closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def gaps(intervals, start: float, stop: float):
    """The idle (start, end) gaps of [start, stop] not covered by any
    interval."""
    out, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, stop)))
        at = max(at, e)
        if at >= stop:
            break
    if at < stop:
        out.append((at, stop))
    return [g for g in out if g[1] > g[0]]


def label_gaps(idle, host_spans, top: int = 10):
    """The ``top`` longest idle gaps, each named by the innermost host span
    running at its midpoint: [[name, seconds], ...] (times in us)."""
    named = []
    for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        inner = [h for h in host_spans if h[1] <= mid <= h[2]]
        name = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                else "(no host span)")
        named.append([name, (e - s) / 1e6])
    return named


def blend_bound_s(work: dict, peaks: dict) -> float:
    """Least time the blend of one view's inputs can take on the chip:
    max(operations / peak FLOP/s, bytes / peak bytes/s). Bytes: every
    stream row (8 + C floats) read once, every output pixel (C + T)
    written once."""
    return max(blend_ops(work) / peaks["fp32_flops"],
               blend_bytes(work) / peaks["hbm_bytes_per_s"])


def blend_ops(work: dict) -> int:
    return (work["walked"] * OPS_PER_WALKED
            + work["live"] * (OPS_PER_LIVE_BASE + 2 * work["channels"]))


def blend_bytes(work: dict) -> int:
    rows = work["entries"] * (8 + work["channels"]) * 4
    pixels = work["tiles"] * work["pixels_per_tile"] * (work["channels"] + 1)
    return rows + pixels * 4


def count_host_syncs(torch, fn, package_dir: str):
    """Run ``fn`` with ``torch.cuda.set_sync_debug_mode("warn")`` and count
    the host syncs, by the innermost line of ``package_dir`` on the Python
    stack where each was made: (total, Counter)."""
    waits = collections.Counter()
    pkg = os.path.abspath(package_dir) + os.sep
    root = os.path.dirname(os.path.abspath(package_dir))

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        ours = [f for f in traceback.extract_stack()
                if f.filename.startswith(pkg)]
        where = ((os.path.relpath(ours[-1].filename, root), ours[-1].lineno)
                 if ours else (filename, lineno))
        waits["%s:%d" % where] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():  # restores showwarning on exit
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(waits.values()), waits
