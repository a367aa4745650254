"""attn_roofline: the patch attention kernel's share of its roofline, in %:
the least time the chip needs for the attention of the profiled requests
over the device time of the kernels whose name holds ``patch_attn_kernel``
in the trace. Per attention launch the bound is max(ops / peak FLOP/s,
bytes / peak bytes/s): ops (4 d + 1) K per query and head (the two
products over its patch's K keys and the exponentials; the N queries the
function needs, not the last patch's shared rows that the kernel computes
again), bytes the queries read and the outputs written once, each patch's
k and v read once, in float32. The work is counted by the benchmark (the
system's set-up counts it from the reference's own hierarchy of the
cloud and puts it in each request's ``timing["attn_work"]``); where the
program launches no such kernel, or no request carries the work, there is
nothing to read."""

KERNEL = "patch_attn_kernel"


def bound_s(work, peaks) -> float:
    """Least seconds for [[ops, bytes], ...] of one request's launches."""
    return sum(max(ops / peaks["fp32_flops"],
                   nbytes / peaks["hbm_bytes_per_s"]) for ops, nbytes in work)


def read(ctx):
    if not ctx.trace or not ctx.peaks or not ctx.trace.get("requests"):
        return None
    work = next((t["attn_work"] for t in ctx.timings if "attn_work" in t),
                None)
    kernel_s = sum(v for k, v in ctx.trace["by_name"].items() if KERNEL in k)
    if not work or kernel_s <= 0:
        return None
    return bound_s(work, ctx.peaks) * ctx.trace["requests"] / kernel_s * 100.0
