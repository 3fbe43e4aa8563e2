"""Host syncs per spectrum inside the program: the CUDA runtime's
synchronising calls that start inside a ``picaso.forward_batch`` span
of the traced requests.  Each drains the card's queue and breaks a CUDA
graph capture."""

SPAN = 'picaso.forward_batch'
SYNCS = ('cudaStreamSynchronize', 'cudaDeviceSynchronize',
         'cudaEventSynchronize', 'cudaMemcpy')


def read(ctx):
    if (ctx.device.type != 'cuda' or ctx.trace is None
            or not ctx.traced_items):
        return None
    batches = [ev for ev in ctx.trace.host if ev.name == SPAN]
    if not batches:
        return None
    syncs = sum(1 for ev in ctx.trace.host if ev.name in SYNCS
                and any(b.start <= ev.start <= b.end for b in batches))
    return syncs / len(ctx.traced_items)
