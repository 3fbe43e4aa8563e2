"""Device milliseconds per spectrum of every kernel that is none of the
port's csrc/ kernels (the glue layer's fallback in layers/)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels or not ctx.traced_items:
        return None
    return ctx.kernel_s('glue') / len(ctx.traced_items) * 1e3
