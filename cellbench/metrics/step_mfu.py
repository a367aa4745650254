"""step_mfu: a request's useful float32 operations over request_ms times
the float32 peak, in %. Useful: one network pass (2 Cin Cout per existing
kernel-map pair, counted by the reference) and the blends of its views
(``measure.blend_ops``, the reference's walk), averaged over the profiled
requests."""

from cellbench.measure import blend_ops


def read(ctx):
    if not ctx.peaks or not ctx.traced_work or not ctx.request_ms:
        return None
    blend = sum(blend_ops(w) for views in ctx.traced_work
                for w in views) / len(ctx.traced_work)
    flops = (ctx.network_flops or 0) + blend
    return flops / (ctx.request_ms / 1e3 * ctx.peaks["fp32_flops"]) * 100.0
