"""host_syncs: host waits on the device per request, counted under
``torch.cuda.set_sync_debug_mode("warn")`` after the window."""


def read(ctx):
    return ctx.syncs_per_request
