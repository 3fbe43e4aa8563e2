"""Host milliseconds per spectrum of the glue over the traced requests:
the program's ``picaso.sources``, ``picaso.disco``, ``picaso.transit``
(absent where there is no transit) and ``picaso.outputs`` spans, plus
the self time of each ``picaso.forward`` (its duration less the stage
spans inside it: the unstacking of the scene and the config check).
Read on the card only (on the CPU the spans time the arithmetic)."""

FORWARD = 'picaso.forward'
STAGES = ('picaso.gather', 'picaso.sources', 'picaso.rt', 'picaso.disco',
          'picaso.transit')
GLUE = ('picaso.sources', 'picaso.disco', 'picaso.transit',
        'picaso.outputs')


def read(ctx):
    if (ctx.device.type != 'cuda' or ctx.trace is None
            or not ctx.traced_items):
        return None
    forwards = [ev for ev in ctx.trace.host if ev.name == FORWARD]
    if not forwards:
        return None
    glue = sum(ev.end - ev.start for ev in ctx.trace.host
               if ev.name in GLUE)
    stages = [ev for ev in ctx.trace.host if ev.name in STAGES]
    # each forward's self time: less the stage spans that start inside it
    for f in forwards:
        glue += (f.end - f.start) - sum(
            ev.end - ev.start for ev in stages
            if f.start <= ev.start <= f.end)
    return glue / len(ctx.traced_items) * 1e-3
