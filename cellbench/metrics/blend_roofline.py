"""blend_roofline: the serving blend kernel's share of its roofline, in %:
the least time the chip needs for the blends of the profiled requests
(work counted by the reference's own binning and walk of the same inputs,
``measure.blend_bound_s``) over the kernel's device time in the trace,
found by name."""

from cellbench.measure import blend_bound_s

KERNEL = "stream_blend_kernel"


def read(ctx):
    if not ctx.trace or not ctx.peaks or not ctx.traced_work:
        return None
    kernel_s = sum(v for k, v in ctx.trace["by_name"].items() if KERNEL in k)
    if kernel_s <= 0:
        return None
    bound = sum(blend_bound_s(w, ctx.peaks)
                for views in ctx.traced_work for w in views)
    return bound / kernel_s * 100.0
