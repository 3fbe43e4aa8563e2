"""Process start to the first timed request: imports, the kernel library
loaded from the checkout's build cache, the table and pool made on the
card, the warm-up of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
