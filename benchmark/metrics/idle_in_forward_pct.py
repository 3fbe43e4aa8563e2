"""The share of the traced window in which the card is idle (no kernel,
copy or set; the union of the profiler's device intervals, as
``device_idle_pct``) while the host is inside a ``picaso.forward_batch``
span.  The rest of ``device_idle_pct`` is idle outside the program: the
copy of the spectra to the host and between requests."""

from benchmark.harness import trace

SPAN = 'picaso.forward_batch'


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    batches = [ev for ev in ctx.trace.host if ev.name == SPAN]
    if not batches:
        return None
    lo, hi = ctx.trace.window
    idle = trace.gaps(trace.busy_intervals(ctx.trace.device,
                                           ctx.trace.window),
                      ctx.trace.window)
    inside = sum(max(0.0, min(e, b.end) - max(s, b.start))
                 for s, e in idle for b in batches)
    return 100.0 * inside / (hi - lo)
