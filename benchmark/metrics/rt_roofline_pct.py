"""The RT kernels' share of their roofline (both stages of every RT
kernel): the larger of the reference RT's operations over the card's
float32 rate and the bytes in and out over its memory rate, over the
traced device time of the RT kernels."""

from benchmark.reference import counts
from benchmark.reference.spectrum import geometry


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.kernel_s('RT')
    if seconds <= 0:
        return None
    refl = 'albedo' in ctx.outputs
    therm = 'thermal' in ctx.outputs
    nlayer = ctx.cfg['levels'] - 1
    nwno = ctx.cfg['nwno']
    ops = nbytes = 0
    for _, p in ctx.traced_items:
        nang = geometry(*ctx.geom_args[p]).ubar0.size
        ops += counts.rt_ops(ctx.opts.method, ctx.opts.stream, refl, therm,
                             nlayer, nang, nwno, ctx.opts.controls,
                             ctx.opts.sh)
        nbytes += counts.rt_bytes(nlayer, nwno, nang, refl, therm)
    bound, _ = counts.bound_s(ops, nbytes, ctx.peaks)
    return 100.0 * bound / seconds
