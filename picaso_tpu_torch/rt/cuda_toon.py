"""Toon89 reflected and thermal spectra as CUDA kernels, with plain twins.

Counterpart of ``picaso_tpu/rt/pallas_toon.py``.  ``csrc/toon_spectrum.cu``
replaces its five TPU kernels, one wrapper each here:

* :func:`spectrum_toon` <- ``spectrum_pallas_fused`` (K2): reflected and
  thermal from the six per-source strips, one pass;
* :func:`reflected_toon` <- ``reflected_pallas_fused`` (K3): the reflected
  half alone;
* :func:`thermal_toon` <- ``thermal_pallas_fused`` (K4): the thermal half
  alone (OG optics with the no-Raman albedo);
* :func:`reflected_toon_props` <- ``reflected_pallas`` (K5): the reflected
  solve from a precomputed ``RTProps`` (``fuse_optics=False``, test modes);
* :func:`thermal_toon_props` <- ``thermal_pallas`` (K6): the thermal solve
  from precomputed OG ``dtau``, ``w0``, ``cosb`` and ``tau_top``.

Each builds (or reads) the per-layer optics, solves the Toon89 eqn-44
system (one factorisation shared by every disk angle, one right-hand side
per angle) and runs the TOA intensity recursion or the per-angle thermal
source-function up-sweep.  Every kernel is two launches on the current
stream: stage A, one thread per wavenumber column, builds the optics and
the shared factorisation (reflected; in K2 it also runs the whole thermal
pass) or the layer values and the thermal solve (K4, K6); stage B, one
thread per (column, disk angle), solves each angle's right-hand side and
intensity sweep (reflected) or runs its source-function up-sweep
(thermal).

Each ``*_plain`` function is the kernel's plain PyTorch twin with the TPU
kernel's arithmetic (stable ``gama = g2/(g1+lamda)``, ``exptrm_minus =
1/exptrm_positive``, the ``e_u0dt``/``e_u1`` products in place of extra
exps, product-form resonant limits, exp clip 10 in f32, beam dither 1e-3
in f32).  Each wrapper runs its twin for CPU tensors and launches its
kernel for CUDA tensors, or raises; ``wrapper.launches`` counts the
wrapper's launches (one per call, both stages).  Every wrapper takes
``split_event``, a ``torch.cuda.Event`` recorded between the stages, so a
caller can time them apart (ignored on the CPU).
"""

from __future__ import annotations

import math

import torch

from .. import _exp_clip
from ..optics import combine_optics
from .toon import (ScatteringControls, _dither_u0, _resonant_ratio,
                   thermal_toa)

__all__ = ['REFLECTED_FIELDS', 'spectrum_toon', 'spectrum_toon_plain', 'reflected_toon',
           'reflected_toon_plain', 'thermal_toon', 'thermal_toon_plain',
           'reflected_toon_props', 'reflected_toon_props_plain',
           'thermal_toon_props', 'thermal_toon_props_plain']

PI = math.pi


def _ipow(x, n):
    """x**n for an integer n, as repeated products (the TPU kernel's
    integer pow; Mosaic has no powf)."""
    if n < 0:
        return 1.0 / _ipow(x, -n)
    out = torch.ones_like(x) if n == 0 else x
    for _ in range(1, n):
        out = out * x
    return out


def _erows(gama, ep):
    em = 1.0 / ep
    return (em, ep + gama * em, ep - gama * em, gama * ep + em,
            gama * ep - em)


def _reflected_plain(u0, u1, cos_theta, dtau, tau, w0, cosb, gcos2,
                     ftau_cld, ftau_ray, dtau_og, tau_og, w0_og, cosb_og,
                     surf_reflect, F0PI, controls, b_top):
    """pallas_toon.py:_reflected_core; u0/u1 are [nang, 1] so every
    per-angle quantity is [nang, nwno] (the angle-stacked scratch)."""
    nlayer = dtau.shape[0]
    sq3 = math.sqrt(3.0)
    if controls.toon_coefficients == 1:
        g1 = (7.0 - w0 * (4.0 + 3.0 * ftau_cld * cosb)) / 4.0
        g2 = -(1.0 - w0 * (4.0 - 3.0 * ftau_cld * cosb)) / 4.0
    else:
        g1 = (sq3 * 0.5) * (2.0 - w0 * (1.0 + ftau_cld * cosb))
        g2 = (sq3 * w0 * 0.5) * (1.0 - ftau_cld * cosb)
    lamda = torch.sqrt(g1 ** 2 - g2 ** 2)
    gama = g2 / (g1 + lamda)
    exptrm = torch.clamp(lamda * dtau, max=_exp_clip(dtau.dtype))
    exptrm_positive = torch.exp(exptrm)
    exptrm_minus, e1, e2, e3, e4 = _erows(gama, exptrm_positive)

    sp = controls.single_phase
    if sp != 1:
        g_forward = controls.constant_forward * cosb_og
        g_back = controls.constant_back * cosb_og
        fc = float(controls.frac_c)
        if fc.is_integer():
            g_back_pow = _ipow(g_back, int(fc))
        else:
            g_back_pow = torch.exp(fc * torch.log(torch.abs(g_back)))
        f = controls.frac_a + controls.frac_b * g_back_pow
        HG_fwd = (1 - g_forward ** 2) / torch.sqrt(
            (1 + g_forward ** 2 + 2 * g_forward * cos_theta) ** 3)
        HG_back = (1 - g_back ** 2) / torch.sqrt(
            (1 + g_back ** 2 + 2 * g_back * cos_theta) ** 3)
    if sp == 0:
        p_single = f * HG_fwd + (1 - f) * HG_back + gcos2
    elif sp == 1:
        p_single = (1 - cosb_og ** 2) / torch.sqrt(
            (1 + cosb_og ** 2 + 2 * cosb_og * cos_theta) ** 3)
    elif sp == 2:
        p_single = f * HG_fwd + (1 - f) * HG_back
    else:
        p_single = (ftau_cld * (f * HG_fwd + (1 - f) * HG_back)
                    + ftau_ray * (0.75 * (1 + cos_theta * cos_theta)))

    # angle-independent coefficients (the Toon89 matrix does not see the
    # incidence angle) and the bottom pair of the reverse elimination
    zrow = torch.zeros_like(dtau[:1])
    ao = torch.cat([zrow, 2.0 * (1.0 - gama[:-1] ** 2)], 0)
    bo = torch.cat([gama[:1] + 1.0, (e1[:-1] - e3[:-1]) * (gama[1:] + 1.0)])
    co = torch.cat([gama[:1] - 1.0, (e1[:-1] + e3[:-1]) * (gama[1:] - 1.0)])
    A_even_l = e1[-1] - surf_reflect * e3[-1]
    B_even_l = e2[-1] - surf_reflect * e4[-1]
    ae = torch.cat([(e1[:-1] + e3[:-1]) * (gama[1:] - 1.0), A_even_l[None]])
    be = torch.cat([(e2[:-1] + e4[:-1]) * (gama[1:] - 1.0), B_even_l[None]])
    ce = torch.cat([2.0 * (1.0 - gama[1:] ** 2), zrow], 0)
    as_last = A_even_l / B_even_l
    C_odd_l = co[-1]
    xo_l = 1.0 / (bo[-1] - C_odd_l * as_last)
    as_ol = ao[-1] * xo_l

    # per-angle beam sources: [nlayer, nang, nwno]
    if controls.toon_coefficients == 1:
        g3 = (2.0 - 3.0 * ftau_cld[:, None] * cosb[:, None] * u0) / 4.0
    else:
        g3 = 0.5 * (1.0 - sq3 * ftau_cld[:, None] * cosb[:, None] * u0)
    g4 = 1.0 - g3
    lam = lamda[:, None]
    u0b = _dither_u0(lam, u0)
    denominator = lam ** 2 - 1.0 / (u0b * u0b)
    a_minus = (F0PI * w0[:, None] * (g4 * (g1[:, None] + 1.0 / u0b)
                                     + g2[:, None] * g3) / denominator)
    a_plus = (F0PI * w0[:, None] * (g3 * (g1[:, None] - 1.0 / u0b)
                                    + g2[:, None] * g4) / denominator)
    x_up = torch.exp(-tau[:-1, None] / u0b)
    c_minus_up = a_minus * x_up
    c_plus_up = a_plus * x_up
    e_u0dt = torch.exp(-dtau[:, None] / u0b)
    x_dn = x_up * e_u0dt
    c_minus_down = a_minus * x_dn
    c_plus_down = a_plus * x_dn
    b_surface = surf_reflect * u0 * F0PI * torch.exp(-tau[-1] / u0)

    gp = gama[1:, None]
    do = torch.cat([
        (b_top - c_minus_up[0])[None],
        e3[:-1, None] * (c_plus_up[1:] - c_plus_down[:-1])
        + e1[:-1, None] * (c_minus_down[:-1] - c_minus_up[1:])], 0)
    D_even_l = (b_surface - c_plus_down[-1]
                + surf_reflect * c_minus_down[-1])
    de = torch.cat([
        (gp - 1.0) * (c_plus_up[1:] - c_plus_down[:-1])
        + (1.0 - gp) * (c_minus_down[:-1] - c_minus_up[1:]),
        D_even_l[None]], 0)
    ds_last = D_even_l / B_even_l
    ds_ol = (do[-1] - C_odd_l * ds_last) * xo_l

    aso = [None] * nlayer
    ase = [None] * nlayer
    dso = [None] * nlayer
    dse = [None] * nlayer
    aso[-1], ase[-1], dso[-1], dse[-1] = as_ol, as_last, ds_ol, ds_last
    as_n, ds_n = as_ol, ds_ol
    for n in range(nlayer - 2, -1, -1):
        xe_ = 1.0 / (be[n] - ce[n] * as_n)
        as_e = ae[n] * xe_
        xo_ = 1.0 / (bo[n] - co[n] * as_e)
        as_o = ao[n] * xo_
        ce_x = ce[n] * xe_
        co_x = co[n] * xo_
        ds_e = de[n] * xe_ - ce_x * ds_n
        ds_o = do[n] * xo_ - co_x * ds_e
        aso[n], ase[n], dso[n], dse[n] = as_o, as_e, ds_o, ds_e
        as_n, ds_n = as_o, ds_o

    x_o = dso[0]
    x_e = dse[0] - ase[0] * x_o
    Xo, Xe = [x_o], [x_e]
    for k in range(1, nlayer):
        x_o = dso[k] - aso[k] * x_e
        x_e = dse[k] - ase[k] * x_o
        Xo.append(x_o)
        Xe.append(x_e)
    Xo = torch.stack(Xo)
    Xe = torch.stack(Xe)
    positive = Xo + Xe
    negative = Xo - Xe

    flux_zero = (positive[-1] * exptrm_positive[-1]
                 + gama[-1] * negative[-1] * exptrm_minus[-1]
                 + c_plus_down[-1])
    xint = flux_zero / PI

    ftc = ftau_cld[:, None]
    cb = cosb[:, None]
    if controls.multi_phase == 0:
        ubar2 = 0.767
        multi_plus = (1.0 + 1.5 * ftc * cb * u1
                      + gcos2[:, None] * (3.0 * ubar2 * ubar2 * u1 * u1 - 1.0)
                      / 2.0)
        multi_minus = (1.0 - 1.5 * ftc * cb * u1
                       + gcos2[:, None] * (3.0 * ubar2 * ubar2 * u1 * u1
                                           - 1.0) / 2.0)
    elif controls.multi_phase == 1:
        multi_plus = 1.0 + 1.5 * ftc * cb * u1
        multi_minus = 1.0 - 1.5 * ftc * cb * u1
    else:  # isotropic: unit Legendre terms (picaso_tpu/rt/toon.py:276-282)
        multi_plus = torch.ones_like(ftc * cb * u1)
        multi_minus = multi_plus
    gm = gama[:, None]
    G = positive * (multi_plus + gm * multi_minus) * w0[:, None] * (0.5 / PI)
    H = negative * (gm * multi_plus + multi_minus) * w0[:, None] * (0.5 / PI)
    A_ = ((multi_plus * c_plus_up + multi_minus * c_minus_up) * w0[:, None]
          * (0.5 / PI))
    e_u1 = torch.exp(-dtau[:, None] / u1)
    ssterm = ((w0_og[:, None] * F0PI / (4.0 * PI)) * p_single[:, None]
              * torch.exp(-tau_og[:-1, None] / u0)
              * (1.0 - torch.exp(-dtau_og[:, None] * (u0 + u1) / (u0 * u1)))
              * (u0 / (u0 + u1)))
    den_u1 = lam * u1 - 1.0
    hdt1 = dtau[:, None] / u1
    x1 = hdt1 * den_u1
    msterm = (A_ * (1.0 - e_u0dt * e_u1) * (u0 / (u0 + u1))
              + G * _resonant_ratio(
                  exptrm_positive[:, None] * e_u1 - 1.0, den_u1,
                  hdt1 * (1.0 + x1 * (0.5 + x1 / 6.0)))
              + H * (1.0 - exptrm_minus[:, None] * e_u1) / (lam * u1 + 1.0))
    sc = ssterm + msterm
    for i in range(nlayer - 1, -1, -1):
        xint = xint * e_u1[i] + sc[i]
    return xint


def _check_controls(controls, stream=2):
    if controls.single_phase not in (0, 1, 2, 3):
        raise ValueError(f'unknown single_phase {controls.single_phase}')
    if controls.multi_phase not in (0, 1, 2):
        raise ValueError(f'unknown multi_phase {controls.multi_phase}')
    if controls.toon_coefficients not in (0, 1):
        raise ValueError(
            f'unknown toon_coefficients {controls.toon_coefficients}')
    if int(stream) != stream or stream < 1:
        raise ValueError(f'stream must be a positive integer, got {stream}')


# RTProps fields in reflected_pallas' argument order
REFLECTED_FIELDS = ('dtau', 'tau', 'w0', 'cosb', 'gcos2', 'ftau_cld', 'ftau_ray',
               'dtau_og', 'tau_og', 'w0_og', 'cosb_og')


def reflected_toon_props_plain(dtau, tau, w0, cosb, gcos2, ftau_cld,
                               ftau_ray, dtau_og, tau_og, w0_og, cosb_og,
                               surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                               controls: ScatteringControls =
                               ScatteringControls(),
                               b_top: float = 0.0):
    """Plain twin of K5 (``reflected_pallas``): reflected TOA intensity
    [ng, nt, nwno] from the 11 RTProps fields it reads."""
    _check_controls(controls)
    dtype = dtau.dtype
    ng, nt = ubar0.shape
    u0 = ubar0.reshape(-1, 1).to(dtype)
    u1 = ubar1.reshape(-1, 1).to(dtype)
    ct = torch.as_tensor(cos_theta, dtype=dtype, device=dtau.device)
    xint = _reflected_plain(u0, u1, ct, dtau, tau, w0, cosb, gcos2,
                            ftau_cld, ftau_ray, dtau_og, tau_og, w0_og,
                            cosb_og, surf_reflect, F0PI, controls, b_top)
    return xint.reshape(ng, nt, dtau.shape[1])


def reflected_toon_plain(taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                         surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                         controls: ScatteringControls = ScatteringControls(),
                         b_top: float = 0.0, stream: int = 2,
                         delta_eddington: bool = True):
    """Plain twin of K3 (``reflected_pallas_fused``): the TPU kernel's
    ``_optics_block`` is ``combine_optics``' default branch (cumulative tau
    by ``torch.cumsum`` instead of the triangular matmul), then K5's
    twin."""
    _check_controls(controls, stream)
    props = combine_optics(taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                           delta_eddington=delta_eddington, stream=stream)
    return reflected_toon_props_plain(
        *(getattr(props, f) for f in REFLECTED_FIELDS), surf_reflect, ubar0,
        ubar1, cos_theta, F0PI, controls=controls, b_top=b_top)


def thermal_toon_props_plain(all_b, dtau, w0, cosb, tau_top, surf_reflect,
                             ubar1, hard_surface: bool = False):
    """Plain twin of K6 (``thermal_pallas``): thermal TOA flux
    [ng, nt, nwno] from the OG dtau, the no-Raman w0, cosb and the
    above-model optical depth tau_top [nwno]."""
    return thermal_toa(all_b, dtau, w0, cosb, tau_top, surf_reflect, ubar1,
                       hard_surface)


def thermal_toon_plain(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0,
                       ptfac, surf_reflect, ubar1,
                       hard_surface: bool = False):
    """Plain twin of K4 (``thermal_pallas_fused``): the OG fields with the
    fixed 0.99999 no-Raman albedo (justdoit.py:330-342), tau_top from the
    first layer and ptfac = p0/(p1-p0), then K6's twin."""
    dtau = taugas + tauray + cld_opd
    w0 = (tauray * 0.99999 + cld_opd * cld_w0) / dtau
    pt = torch.as_tensor(ptfac, dtype=dtau.dtype, device=dtau.device)
    return thermal_toon_props_plain(all_b, dtau, w0, cld_g0, dtau[0] * pt,
                                    surf_reflect, ubar1, hard_surface)


def spectrum_toon_plain(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                        ptfac, surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                        controls: ScatteringControls = ScatteringControls(),
                        b_top: float = 0.0, stream: int = 2,
                        delta_eddington: bool = True,
                        hard_surface: bool = False):
    """Plain twin of K2 (``spectrum_pallas_fused``): K3's and K4's twins on
    the same strips.  Returns (xint, thermal), each [ng, nt, nwno]."""
    xint = reflected_toon_plain(taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                                surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                                controls=controls, b_top=b_top,
                                stream=stream,
                                delta_eddington=delta_eddington)
    therm = thermal_toon_plain(all_b, taugas, tauray, cld_opd, cld_w0,
                               cld_g0, ptfac, surf_reflect, ubar1,
                               hard_surface)
    return xint, therm


# ---------------------------------------------------------------------------
# the CUDA wrappers
# ---------------------------------------------------------------------------

def _on_cpu(fn, t):
    """True for a CPU tensor (the twin runs); raises for a device that is
    neither CPU nor CUDA."""
    if t.device.type == 'cpu':
        return True
    if t.device.type != 'cuda':
        raise ValueError(f'{fn}: unsupported device {t.device}')
    return False


def _check_cuda(fn, tensors, shapes, scalars=()):
    """Check a kernel's inputs: every tensor on the first one's device,
    float32, contiguous, of the shape ``shapes`` names; each of ``scalars``
    (name, value) one value.  Returns the device and the scalars as
    one-element float32 tensors on it."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f'{fn}: {name} on {t.device}, expected {dev}')
        if t.dtype != torch.float32:
            raise TypeError(f'{fn}: {name} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{fn}: {name} must be contiguous')
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f'{fn}: {name} {tuple(t.shape)} != '
                             f'{shapes[name]}')
    out = []
    for name, v in scalars:
        if isinstance(v, torch.Tensor) and (v.device != dev or v.numel() != 1):
            raise ValueError(f'{fn}: {name} must be one value on {dev}')
        out.append(torch.as_tensor(v, dtype=torch.float32,
                                   device=dev).reshape(1))
    return dev, out


def _geometry_shapes(fn, nlayer, nwno, ubar0, ubar1, layer_names,
                     level_names=()):
    """Expected shapes by argument name."""
    if ubar0 is not None and ubar1.shape != ubar0.shape:
        raise ValueError(f'{fn}: ubar0 and ubar1 differ in shape')
    shapes = {n: (nlayer, nwno) for n in layer_names}
    shapes.update({n: (nlayer + 1, nwno) for n in level_names})
    shapes.update(surf_reflect=(nwno,), F0PI=(nwno,), tau_top=(nwno,))
    return shapes


def _controls_args(c, b_top):
    return (c.single_phase, c.multi_phase, c.toon_coefficients, c.frac_a,
            c.frac_b, c.frac_c, c.constant_back, c.constant_forward,
            float(b_top))


def _launch(fn, entry, dev, slots_entry, nlayer, nwno, nouts, nang, args,
            split_event=None):
    """Allocate the outputs ([nang, nwno] each) and the scratch (its slot
    count at ``nang`` angles from ``slots_entry``), then call ``entry`` on
    the current stream with ``args(outs, scratch)`` for stage 0 (A), then
    stage 1 (B), each launch checked before the next (a refused one raises
    and names the stage); ``split_event`` is recorded between them."""
    from .._build import check, library
    lib = library()
    f32 = torch.float32
    outs = [torch.empty((nang, nwno), dtype=f32, device=dev)
            for _ in range(nouts)]
    scratch = torch.empty((getattr(lib, slots_entry)(nang), nlayer + 1, nwno),
                          dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        for stage in (0, 1):
            if stage == 1 and split_event is not None:
                split_event.record(stream)
            check(getattr(lib, entry)(*args(outs, scratch), stage,
                                      stream.cuda_stream),
                  f'{fn} stage {"AB"[stage]}')
    return outs


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _min_layers(fn, nlayer):
    if nlayer < 2:
        raise ValueError(f'{fn}: needs at least 2 layers')


_STRIPS = ('taugas', 'tauray', 'cld_opd', 'cld_w0', 'cld_g0', 'rf')


def spectrum_toon(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, ptfac,
                  surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                  controls: ScatteringControls = ScatteringControls(),
                  b_top: float = 0.0, stream: int = 2,
                  delta_eddington: bool = True, hard_surface: bool = False,
                  split_event=None):
    """Reflected TOA intensity and thermal TOA flux, each [ng, nt, nwno]
    (K2).

    Same contract as ``spectrum_pallas_fused``.  CPU tensors take the plain
    twin; CUDA tensors launch ``csrc/toon_spectrum.cu`` (float32,
    contiguous) and raise on anything the kernel does not take.

    Left out of the TPU kernels (this one and the four below), with the
    reason:
    - the wavelength blocks and VMEM scratch: one thread owns one
      wavelength column and keeps its intermediates in global scratch laid
      out [slot, row, nwno], so a warp's accesses coalesce;
    - ``_cumtau_mxu`` (the triangular matmul for the level optical
      depths): a running sum in the thread;
    - the SMEM/VMEM operand split (angles and scalars in SMEM): angles,
      cos_theta and ptfac are small device arrays read by every thread;
    - the angle-stacked RHS buffers and per-angle sources: stage B gives
      each (column, angle) its own thread, which reads the shared
      factorisation (reflected) or the solved layer rows (thermal) from
      scratch.
    """
    fn = 'spectrum_toon'
    if _on_cpu(fn, taugas):
        return spectrum_toon_plain(
            all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, ptfac,
            surf_reflect, ubar0, ubar1, cos_theta, F0PI, controls=controls,
            b_top=b_top, stream=stream, delta_eddington=delta_eddington,
            hard_surface=hard_surface)
    _check_controls(controls, stream)
    nlayer, nwno = taugas.shape
    _min_layers(fn, nlayer)
    named = dict(zip(_STRIPS, (taugas, tauray, cld_opd, cld_w0, cld_g0, rf)),
                 all_b=all_b, surf_reflect=surf_reflect, F0PI=F0PI,
                 ubar0=ubar0, ubar1=ubar1)
    shapes = _geometry_shapes(fn, nlayer, nwno, ubar0, ubar1, _STRIPS,
                              ('all_b',))
    dev, (ct, pt) = _check_cuda(fn, named, shapes,
                                (('cos_theta', cos_theta), ('ptfac', ptfac)))
    ng, nt = ubar0.shape
    u0, u1 = ubar0.reshape(-1), ubar1.reshape(-1)
    xint, therm = _launch(
        fn, 'toon_spectrum_launch', dev, 'toon_spectrum_scratch_slots',
        nlayer, nwno, 2, ng * nt, lambda o, scr: (
            *_ptrs(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                   surf_reflect, F0PI, u0, u1, ct, pt, o[0], o[1], scr),
            nlayer, nwno, ng * nt, *_controls_args(controls, b_top),
            int(stream), int(bool(delta_eddington)),
            int(bool(hard_surface))), split_event=split_event)
    spectrum_toon.launches += 1
    return xint.reshape(ng, nt, nwno), therm.reshape(ng, nt, nwno)


def reflected_toon(taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                   surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                   controls: ScatteringControls = ScatteringControls(),
                   b_top: float = 0.0, stream: int = 2,
                   delta_eddington: bool = True, split_event=None):
    """Reflected TOA intensity [ng, nt, nwno] from the six strips (K3).
    Same contract as ``reflected_pallas_fused``; CPU tensors take the twin,
    CUDA tensors launch the kernel or raise."""
    fn = 'reflected_toon'
    if _on_cpu(fn, taugas):
        return reflected_toon_plain(
            taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect,
            ubar0, ubar1, cos_theta, F0PI, controls=controls, b_top=b_top,
            stream=stream, delta_eddington=delta_eddington)
    _check_controls(controls, stream)
    nlayer, nwno = taugas.shape
    _min_layers(fn, nlayer)
    named = dict(zip(_STRIPS, (taugas, tauray, cld_opd, cld_w0, cld_g0, rf)),
                 surf_reflect=surf_reflect, F0PI=F0PI, ubar0=ubar0,
                 ubar1=ubar1)
    shapes = _geometry_shapes(fn, nlayer, nwno, ubar0, ubar1, _STRIPS)
    dev, (ct,) = _check_cuda(fn, named, shapes, (('cos_theta', cos_theta),))
    ng, nt = ubar0.shape
    u0, u1 = ubar0.reshape(-1), ubar1.reshape(-1)
    (xint,) = _launch(
        fn, 'toon_reflected_launch', dev, 'toon_reflected_scratch_slots',
        nlayer, nwno, 1, ng * nt, lambda o, scr: (
            *_ptrs(taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                   surf_reflect, F0PI, u0, u1, ct, o[0], scr),
            nlayer, nwno, ng * nt, *_controls_args(controls, b_top),
            int(stream), int(bool(delta_eddington))),
        split_event=split_event)
    reflected_toon.launches += 1
    return xint.reshape(ng, nt, nwno)


_THERM_STRIPS = ('taugas', 'tauray', 'cld_opd', 'cld_w0', 'cld_g0')


def thermal_toon(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, ptfac,
                 surf_reflect, ubar1, hard_surface: bool = False,
                 split_event=None):
    """Thermal TOA flux [ng, nt, nwno] from the strips (K4).  Same contract
    as ``thermal_pallas_fused``; CPU tensors take the twin, CUDA tensors
    launch the kernel (stage A solves each column, stage B sweeps each
    angle) or raise."""
    fn = 'thermal_toon'
    if _on_cpu(fn, taugas):
        return thermal_toon_plain(all_b, taugas, tauray, cld_opd, cld_w0,
                                  cld_g0, ptfac, surf_reflect, ubar1,
                                  hard_surface)
    nlayer, nwno = taugas.shape
    _min_layers(fn, nlayer)
    named = dict(zip(_THERM_STRIPS, (taugas, tauray, cld_opd, cld_w0,
                                     cld_g0)),
                 all_b=all_b, surf_reflect=surf_reflect, ubar1=ubar1)
    shapes = _geometry_shapes(fn, nlayer, nwno, None, ubar1, _THERM_STRIPS,
                              ('all_b',))
    dev, (pt,) = _check_cuda(fn, named, shapes, (('ptfac', ptfac),))
    ng, nt = ubar1.shape
    u1 = ubar1.reshape(-1)
    (therm,) = _launch(
        fn, 'toon_thermal_launch', dev, 'toon_thermal_scratch_slots',
        nlayer, nwno, 1, ng * nt, lambda o, scr: (
            *_ptrs(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, pt,
                   surf_reflect, u1, o[0], scr),
            nlayer, nwno, ng * nt, int(bool(hard_surface))),
        split_event=split_event)
    thermal_toon.launches += 1
    return therm.reshape(ng, nt, nwno)


def reflected_toon_props(dtau, tau, w0, cosb, gcos2, ftau_cld, ftau_ray,
                         dtau_og, tau_og, w0_og, cosb_og, surf_reflect,
                         ubar0, ubar1, cos_theta, F0PI,
                         controls: ScatteringControls = ScatteringControls(),
                         b_top: float = 0.0, split_event=None):
    """Reflected TOA intensity [ng, nt, nwno] from a precomputed RTProps
    (K5).  Same contract as ``reflected_pallas``: tau and tau_og are taken
    as given (under ``test_mode`` they come from the overridden optical
    depths), as are ftau_cld, ftau_ray and gcos2.  CPU tensors take the
    twin, CUDA tensors launch the kernel or raise."""
    fn = 'reflected_toon_props'
    fields = (dtau, tau, w0, cosb, gcos2, ftau_cld, ftau_ray, dtau_og,
              tau_og, w0_og, cosb_og)
    if _on_cpu(fn, dtau):
        return reflected_toon_props_plain(
            *fields, surf_reflect, ubar0, ubar1, cos_theta, F0PI,
            controls=controls, b_top=b_top)
    _check_controls(controls)
    nlayer, nwno = dtau.shape
    _min_layers(fn, nlayer)
    named = dict(zip(REFLECTED_FIELDS, fields), surf_reflect=surf_reflect,
                 F0PI=F0PI, ubar0=ubar0, ubar1=ubar1)
    layer = tuple(f for f in REFLECTED_FIELDS if f not in ('tau', 'tau_og'))
    shapes = _geometry_shapes(fn, nlayer, nwno, ubar0, ubar1, layer,
                              ('tau', 'tau_og'))
    dev, (ct,) = _check_cuda(fn, named, shapes, (('cos_theta', cos_theta),))
    ng, nt = ubar0.shape
    u0, u1 = ubar0.reshape(-1), ubar1.reshape(-1)
    (xint,) = _launch(
        fn, 'toon_reflected_props_launch', dev,
        'toon_reflected_scratch_slots', nlayer, nwno, 1, ng * nt,
        lambda o, scr: (
            *_ptrs(*fields, surf_reflect, F0PI, u0, u1, ct, o[0], scr),
            nlayer, nwno, ng * nt, *_controls_args(controls, b_top)),
        split_event=split_event)
    reflected_toon_props.launches += 1
    return xint.reshape(ng, nt, nwno)


def thermal_toon_props(all_b, dtau, w0, cosb, tau_top, surf_reflect, ubar1,
                       hard_surface: bool = False, split_event=None):
    """Thermal TOA flux [ng, nt, nwno] from the precomputed OG dtau, the
    no-Raman w0, cosb and tau_top [nwno] (K6).  Same contract as
    ``thermal_pallas``; CPU tensors take the twin, CUDA tensors launch the
    kernel (two stages, as K4) or raise."""
    fn = 'thermal_toon_props'
    if _on_cpu(fn, dtau):
        return thermal_toon_props_plain(all_b, dtau, w0, cosb, tau_top,
                                        surf_reflect, ubar1, hard_surface)
    nlayer, nwno = dtau.shape
    _min_layers(fn, nlayer)
    named = dict(all_b=all_b, dtau=dtau, w0=w0, cosb=cosb, tau_top=tau_top,
                 surf_reflect=surf_reflect, ubar1=ubar1)
    shapes = _geometry_shapes(fn, nlayer, nwno, None, ubar1,
                              ('dtau', 'w0', 'cosb'), ('all_b',))
    dev, _ = _check_cuda(fn, named, shapes)
    ng, nt = ubar1.shape
    u1 = ubar1.reshape(-1)
    (therm,) = _launch(
        fn, 'toon_thermal_props_launch', dev, 'toon_thermal_scratch_slots',
        nlayer, nwno, 1, ng * nt, lambda o, scr: (
            *_ptrs(all_b, dtau, w0, cosb, tau_top, surf_reflect, u1, o[0],
                   scr),
            nlayer, nwno, ng * nt, int(bool(hard_surface))),
        split_event=split_event)
    thermal_toon_props.launches += 1
    return therm.reshape(ng, nt, nwno)


for _wrapper in (spectrum_toon, reflected_toon, thermal_toon,
                 reflected_toon_props, thermal_toon_props):
    _wrapper.launches = 0
