"""Host milliseconds per spectrum in the program's ``picaso.rt`` spans
(the Planck arguments, the argument checks, the scratch and the RT
kernels' launches) over the traced requests; read on the card only (on
the CPU the span times the RT twins' arithmetic, not their enqueue)."""

SPAN = 'picaso.rt'


def read(ctx):
    if (ctx.device.type != 'cuda' or ctx.trace is None
            or not ctx.traced_items):
        return None
    spans = [ev for ev in ctx.trace.host if ev.name == SPAN]
    if not spans:
        return None
    return sum(ev.end - ev.start for ev in spans) / len(
        ctx.traced_items) * 1e-3
