"""The share of the traced window in which no kernel, copy or set ran
on the card (the union of the profiler's device intervals)."""

from benchmark.harness import trace


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    lo, hi = ctx.trace.window
    busy = sum(e - s for s, e in trace.busy_intervals(ctx.trace.device,
                                                      ctx.trace.window))
    return 100.0 * (1.0 - busy / (hi - lo))
