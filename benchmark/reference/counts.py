"""What the rooflines divide: the operations of the reference RT and the
bytes the gather and the RT kernels must move, from the shapes of a cell
and the benchmark's own bracketing of each profile.

The operation count follows the rules of the port's ``chip_smoke.py``
``OpCounter`` at commit d22d65a: one operation per output element of an
elementwise float op, one per input element of a reduction or scan, two
per multiply-add of a matrix product.  It counts this package's frozen RT
(``optics.combine_optics`` and the Toon or SH solves), so a kernel's
roofline reads the same work whatever implements it.  Every op of that RT
acts on a fixed shape, so the count is linear in the number of
wavenumbers: it is taken at two small widths on the CPU and extended.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import optics, sh, toon

F32 = 4
_ELEMENTWISE = {'add', 'sub', 'rsub', 'mul', 'div', 'neg', 'reciprocal',
                'exp', 'expm1', 'exp2', 'log', 'log10', 'log1p', 'log2',
                'pow', 'sqrt', 'rsqrt', 'maximum', 'minimum', 'clamp',
                'clamp_min', 'clamp_max', 'abs', 'sign', 'sin', 'cos',
                'tanh', 'sigmoid', 'lerp', 'addcmul', 'addcdiv'}
_REDUCING = {'sum', 'cumsum', 'cumprod', 'prod', 'mean', 'amax', 'amin'}


class OpCounter(TorchDispatchMode):
    """Counts the floating-point operations of the aten calls made inside
    it."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__.rstrip('_')
        if isinstance(out, torch.Tensor) and out.is_floating_point():
            if name in _ELEMENTWISE:
                self.ops += out.numel()
            elif name in _REDUCING and isinstance(args[0], torch.Tensor):
                self.ops += args[0].numel()
            elif name in ('mm', 'bmm', 'matmul'):
                self.ops += 2 * out.numel() * args[0].shape[-1]
        return out


def _rt_inputs(nlayer, nwno, seed=0):
    """Physical-looking RT inputs [nlayer, nwno] in float64 (the count
    depends on shapes only)."""
    g = torch.Generator().manual_seed(seed)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((nlayer, nwno), generator=g,
                                           dtype=torch.float64)
    taugas = 10 ** (4 * torch.rand((nlayer, nwno), generator=g,
                                   dtype=torch.float64) - 3)
    return taugas, u(1e-3, 1e-1), u(0.0, 1.0), u(0.9, 0.95), u(0.8, 0.85)


def _geometry(nang):
    """[1, nang] cosines in (0, 1)."""
    mu = torch.linspace(0.15, 0.95, nang, dtype=torch.float64)
    return mu[None, :], mu.flip(0)[None, :]


def _count_rt(method, stream, reflected, thermal, nlayer, nang, nwno,
              controls, sh_options):
    taugas, tauray, cld, w0, g0 = _rt_inputs(nlayer, nwno)
    rf = torch.full_like(taugas, 0.99999)
    u0, u1 = _geometry(nang)
    surf = torch.zeros(nwno, dtype=torch.float64)
    f0pi = torch.ones(nwno, dtype=torch.float64)
    cos_theta = torch.tensor(0.5, dtype=torch.float64)
    tlevel = torch.linspace(300.0, 2000.0, nlayer + 1, dtype=torch.float64)
    plevel = torch.logspace(0, 8.5, nlayer + 1, dtype=torch.float64)
    wno = torch.linspace(700.0, 33000.0, nwno, dtype=torch.float64)
    all_b = toon.blackbody(tlevel, 1.0 / wno)
    with OpCounter() as counter:
        props = optics.combine_optics(taugas, tauray, cld, w0, g0, rf,
                                      stream=stream)
        if method == 'sh':
            if reflected:
                sh.reflected_sh(props, surf, u0, u1, cos_theta, f0pi,
                                stream=stream, controls=controls,
                                **dict(sh_options))
            if thermal:
                sh.thermal_sh(tlevel, props, plevel, u1, surf, wno,
                              stream=stream)
        else:
            if reflected:
                toon.reflected_1d(
                    props.dtau, props.tau, props.w0, props.cosb, props.gcos2,
                    props.ftau_cld, props.ftau_ray, props.dtau_og,
                    props.tau_og, props.w0_og, props.cosb_og, surf, u0, u1,
                    cos_theta, f0pi, controls=controls)
            if thermal:
                tau_top = props.dtau_og[0] * plevel[0] / (plevel[1]
                                                          - plevel[0])
                toon.thermal_toa(all_b, props.dtau_og, props.w0_no_raman,
                                 props.cosb_og, tau_top, surf, u1)
    return counter.ops


@functools.lru_cache(maxsize=64)
def rt_ops(method, stream, reflected, thermal, nlayer, nang, nwno,
           controls=toon.ScatteringControls(), sh_options=()):
    """Floating-point operations of the reference RT of one spectrum:
    the optics and the reflected and/or thermal solve at ``nang`` disk
    angles (the blackbody of the Toon thermal solve is an input there, as
    in the kernels; the SH thermal solve works its own out)."""
    a = _count_rt(method, stream, reflected, thermal, nlayer, nang, 16,
                  controls, sh_options)
    b = _count_rt(method, stream, reflected, thermal, nlayer, nang, 32,
                  controls, sh_options)
    per_col = (b - a) // 16
    return a + per_col * (nwno - 16)


def distinct_rows(idx):
    """Distinct flat table rows among a profile's corner rows."""
    return int(np.unique(np.asarray(idx)).size)


# (bytes a table element, bytes of the table's parameters) of each table
# the program can gather from: int16 codes with their float32 scale and
# offset (``qparams``), or float32 log cross sections
TABLE_BYTES = {'float32': (F32, 0), 'int16': (2, 2 * F32)}


def gather_bytes(rows, nmol, nwno, nlayer, table='float32'):
    """What one gather must move: each distinct table row of every
    molecule once, at the element size of the ``table`` it gathers from,
    with that table's parameters, the per-layer inputs (corner rows,
    weights, column weights) and the optical depth it writes."""
    element, params = TABLE_BYTES[table]
    return (rows * nmol * nwno * element + params + 4 * nlayer * (4 + F32)
            + nmol * nlayer * F32 + nlayer * nwno * F32)


def rt_bytes(nlayer, nwno, nang, reflected, thermal):
    """What one spectrum's RT kernels must move: the six per-layer inputs
    (gas, Rayleigh, cloud depth, w0, g0, Raman factor) once, the level
    Planck function for a thermal solve, the surface and stellar rows,
    the per-angle outputs once."""
    nbytes = 6 * nlayer * nwno * F32 + nwno * F32
    if reflected:
        nbytes += nwno * F32 + nang * nwno * F32
    if thermal:
        nbytes += (nlayer + 1) * nwno * F32 + nang * nwno * F32
    return nbytes


def bound_s(ops, nbytes, peaks):
    """(seconds, 'operations' | 'bytes'): the least time the card could
    take, the larger of operations over its float32 rate and bytes over
    its memory rate."""
    t_ops = ops / peaks['f32_ops_per_s']
    t_bytes = nbytes / peaks['bytes_per_s']
    return (t_ops, 'operations') if t_ops >= t_bytes else (t_bytes, 'bytes')

