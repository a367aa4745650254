"""request_ms: the window's length over the requests it completed (host
clock; a stall counts)."""


def read(ctx):
    return ctx.request_ms
