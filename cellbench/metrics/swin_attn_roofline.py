"""swin_attn_roofline: the window attention kernel's share of its
roofline, in %: the least time the chip needs for the window attention of
the profiled requests over the device time of the kernels whose name holds
``swin_attn_kernel`` in the trace. Per launch the bound is max(ops / peak
FLOP/s, bytes / peak bytes/s), with the least work of the function
whatever form the kernel computes (``reference/swin3d.py``'s
``attn_least_ops`` and ``attn_least_bytes``, so that no kernel can read
above 100%). The work is counted by the benchmark (the system's set-up
counts it from the reference's own levels and windows of the cloud and
puts it in each request's ``timing["swin_attn_work"]``); where the
program launches no such kernel, or no request carries the work, there is
nothing to read."""

KERNEL = "swin_attn_kernel"


def bound_s(work, peaks) -> float:
    """Least seconds for [[ops, bytes], ...] of one request's launches."""
    return sum(max(ops / peaks["fp32_flops"],
                   nbytes / peaks["hbm_bytes_per_s"]) for ops, nbytes in work)


def read(ctx):
    if not ctx.trace or not ctx.peaks or not ctx.trace.get("requests"):
        return None
    work = next((t["swin_attn_work"] for t in ctx.timings
                 if "swin_attn_work" in t), None)
    kernel_s = sum(v for k, v in ctx.trace["by_name"].items() if KERNEL in k)
    if not work or kernel_s <= 0:
        return None
    return bound_s(work, ctx.peaks) * ctx.trace["requests"] / kernel_s * 100.0
