"""Host milliseconds inside ``forward_batch`` per spectrum, over the
window's untraced requests (the benchmark's own spans): the enqueue of
every launch plus any wait inside the call."""


def read(ctx):
    spans = [(s, n) for s, n, traced in ctx.window.host_spans
             if not traced] or [(s, n) for s, n, _ in ctx.window.host_spans]
    spectra = sum(n for _, n in spans)
    if not spectra:
        return None
    return sum(s for s, _ in spans) / spectra * 1e3
