"""The gather's share of its roofline: the bytes it must move over the
card's memory rate, over the traced device time of the gather kernels.
The bytes count each distinct table row that a profile's layers bracket
(the reference's own bracketing) once, for every molecule and
wavenumber, at the element size of the table the program gathers from
(4 B float32 for K1; 2 B int16 and its 8 B of qparams for K8), plus the
per-layer inputs and the optical depth written."""

from benchmark.reference import counts, opacity
from benchmark.reference.constants import PCONV


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = ctx.kernel_s('gather')
    if seconds <= 0:
        return None
    grid = opacity.ragged_grid(ctx.table.temps_flat, ctx.table.press_flat)
    nmol, _, nwno = ctx.table.log_kappa.shape
    nbytes = 0
    for a, _ in ctx.traced_items:
        s = ctx.derived(a)
        _, _, idx = opacity.bracket(grid, s.tlayer, s.player / PCONV)
        nbytes += counts.gather_bytes(counts.distinct_rows(idx), nmol, nwno,
                                      len(s.tlayer), ctx.program_table)
    return 100.0 * nbytes / ctx.peaks['bytes_per_s'] / seconds
