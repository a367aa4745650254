"""rgb_ms: the renderer's own ``rgb_time`` (host clock around the
rasterizer pass of all views, ending in a synchronise), median over the
window's requests."""

from cellbench.measure import percentile


def read(ctx):
    vals = [t["rgb_time"] for t in ctx.timings if "rgb_time" in t]
    return percentile(vals, 50) * 1e3 if vals else None
