"""setup_s: process start to the first timed request: imports, the card,
the seeded inputs, the program, kernel builds and the warm requests."""


def read(ctx):
    return ctx.setup_s
