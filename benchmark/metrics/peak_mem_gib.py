"""The card's peak allocated memory over the window (after a reset of
the peak at its start), in GiB."""


def read(ctx):
    if ctx.device.type != 'cuda':
        return None
    return ctx.window_peak / 2 ** 30
