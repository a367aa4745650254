"""model_ms: the renderer's own ``model_time`` (host clock around its
timed encode, which ends in a synchronise), median over the window's
requests; only where the renderer runs a network."""

from cellbench.measure import percentile


def read(ctx):
    vals = [t["model_time"] for t in ctx.timings if "model_time" in t]
    if ctx.network_flops is None or not vals:
        return None
    return percentile(vals, 50) * 1e3
