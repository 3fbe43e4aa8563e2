"""Host milliseconds per spectrum in the program's ``picaso.gather``
spans (the gather's bracketing, its column weights and the K1/K8
launch) over the traced requests; read on the card only (on the CPU the
span times the gather's arithmetic, not its enqueue)."""

SPAN = 'picaso.gather'


def read(ctx):
    if (ctx.device.type != 'cuda' or ctx.trace is None
            or not ctx.traced_items):
        return None
    spans = [ev for ev in ctx.trace.host if ev.name == SPAN]
    if not spans:
        return None
    return sum(ev.end - ev.start for ev in spans) / len(
        ctx.traced_items) * 1e-3
