"""Device kernels launched per spectrum in the traced requests (copies
and sets not counted)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_items:
        return None
    return len(ctx.trace.kernels) / len(ctx.traced_items)
