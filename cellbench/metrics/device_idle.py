"""device_idle: the share of the measured window in which the device is
idle, in %: 1 - (device-busy union per profiled request) / (the window's
own time per request, ``request_ms``). The busy union comes from the
device-only profile after the window; the time per request from the
untraced window of the same run, so the profiler's own slowing of the
host-paced loop is not read as idle time."""


def read(ctx):
    t = ctx.trace
    if not t or not t["requests"] or t["busy_s"] <= 0 or not ctx.request_ms:
        return None
    busy_ms = t["busy_s"] * 1e3 / t["requests"]
    return (1.0 - busy_ms / ctx.request_ms) * 100.0
