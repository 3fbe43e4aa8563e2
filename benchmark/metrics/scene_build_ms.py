"""Host milliseconds per call of the program's ``scene_from_arrays``
(the set-up's scene builds), from its counter
(``picaso_tpu_torch.profiling.counters()``); read on the card only (on
the CPU the scene's tensors are made where they stay)."""


def read(ctx):
    if ctx.device.type != 'cuda':
        return None
    from picaso_tpu_torch import profiling
    counters = getattr(profiling, 'counters', None)
    c = counters().get('scene_from_arrays') if counters else None
    if not c or not c['calls']:
        return None
    return c['seconds'] / c['calls'] * 1e3
