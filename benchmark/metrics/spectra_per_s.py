"""Spectra completed in the window over the window's seconds; a phase
point counts as one spectrum."""


def read(ctx):
    if ctx.window.seconds <= 0:
        return None
    return ctx.window.spectra / ctx.window.seconds
