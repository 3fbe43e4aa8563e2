"""Toon89 reflected + thermal spectrum in one kernel, with its plain twin.

Counterpart of ``picaso_tpu/rt/pallas_toon.py``: ``csrc/toon_spectrum.cu``
replaces the dual-pass TPU kernel ``spectrum_pallas_fused``
(``_spectrum_kernel_fused`` -> ``_optics_block``, ``_reflected_core``,
``_thermal_core``, ``_solve_two_stream_scratch``).  From the six per-source
strips it builds the delta-Eddington and OG optics, solves the Toon89
eqn-44 system (one factorisation shared by every disk angle, one
right-hand side per angle), runs the reflected TOA intensity recursion,
solves the thermal two-stream system and runs the per-angle thermal
source-function up-sweep.

:func:`spectrum_toon_plain` is the plain PyTorch twin with the TPU
kernel's arithmetic (stable ``gama = g2/(g1+lamda)``, ``exptrm_minus =
1/exptrm_positive``, the ``e_u0dt``/``e_u1`` products in place of extra
exps, product-form resonant limits, exp clip 10 in f32, beam dither
1e-3 in f32).  :func:`spectrum_toon` runs the twin for CPU tensors and
launches the kernel for CUDA tensors, or raises.
"""

from __future__ import annotations

import math

import torch

from .. import _exp_clip
from ..optics import combine_optics
from .toon import (ScatteringControls, _dither_u0, _resonant_ratio,
                   thermal_toa)

__all__ = ['spectrum_toon', 'spectrum_toon_plain']

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
    else:
        multi_plus = 1.0 + 1.5 * ftc * cb * u1
        multi_minus = 1.0 - 1.5 * ftc * cb * u1
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


def _check_controls(controls, stream):
    if controls.single_phase not in (0, 1, 2, 3):
        raise ValueError(f'unknown single_phase {controls.single_phase}')
    if controls.multi_phase not in (0, 1):
        raise NotImplementedError(
            f'multi_phase={controls.multi_phase} (isotropic) is not ported '
            'yet: ROADMAP Queue 1 item 14')
    if controls.toon_coefficients not in (0, 1):
        raise ValueError(
            f'unknown toon_coefficients {controls.toon_coefficients}')
    if int(stream) != stream or stream < 1:
        raise ValueError(f'stream must be a positive integer, got {stream}')


def spectrum_toon_plain(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                        ptfac, surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                        controls: ScatteringControls = ScatteringControls(),
                        b_top: float = 0.0, stream: int = 2,
                        delta_eddington: bool = True,
                        hard_surface: bool = False):
    """Plain PyTorch twin of the spectrum kernel (same arithmetic as
    ``spectrum_pallas_fused``; cumulative tau by ``torch.cumsum`` instead
    of the TPU's triangular matmul).  Returns (xint, thermal), each
    [ng, nt, nwno]."""
    _check_controls(controls, stream)
    dtype = taugas.dtype
    ng, nt = ubar0.shape
    nwno = taugas.shape[1]
    u0 = ubar0.reshape(-1, 1).to(dtype)
    u1 = ubar1.reshape(-1, 1).to(dtype)
    ct = torch.as_tensor(cos_theta, dtype=dtype, device=taugas.device)
    pt = torch.as_tensor(ptfac, dtype=dtype, device=taugas.device)
    # the TPU kernel's _optics_block is combine_optics' default branch
    props = combine_optics(taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
                           delta_eddington=delta_eddington, stream=stream)
    xint = _reflected_plain(u0, u1, ct, props.dtau, props.tau, props.w0,
                            props.cosb, props.gcos2, props.ftau_cld,
                            props.ftau_ray, props.dtau_og, props.tau_og,
                            props.w0_og, props.cosb_og, surf_reflect, F0PI,
                            controls, b_top)
    # thermal: OG fields with the fixed no-raman albedo
    therm = thermal_toa(all_b, props.dtau_og, props.w0_no_raman,
                        props.cosb_og, props.dtau_og[0] * pt, surf_reflect,
                        ubar1, hard_surface)
    return xint.reshape(ng, nt, nwno), therm.reshape(ng, nt, nwno)


_STRIPS = ('taugas', 'tauray', 'cld_opd', 'cld_w0', 'cld_g0', 'rf')


def spectrum_toon(all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, ptfac,
                  surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                  controls: ScatteringControls = ScatteringControls(),
                  b_top: float = 0.0, stream: int = 2,
                  delta_eddington: bool = True, hard_surface: bool = False):
    """Reflected TOA intensity and thermal TOA flux, each [ng, nt, nwno].

    Same contract as ``spectrum_pallas_fused``.  CPU tensors take the plain
    twin; CUDA tensors launch ``csrc/toon_spectrum.cu`` (float32,
    contiguous) and raise on anything the kernel does not take.

    Left out of the TPU kernel, with the reason:
    - the wavelength blocks and VMEM scratch: one thread owns one
      wavelength column and keeps its intermediates in global scratch laid
      out [slot, row, nwno], so a warp's accesses coalesce;
    - ``_cumtau_mxu`` (the triangular matmul for the level optical
      depths): a running sum in the thread;
    - the SMEM/VMEM operand split (angles and scalars in SMEM): angles,
      cos_theta and ptfac are small device arrays read by every thread;
    - the angle-stacked RHS buffers: each thread solves its angles one
      after another against the shared factorisation.
    """
    if taugas.device.type == 'cpu':
        return spectrum_toon_plain(
            all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, ptfac,
            surf_reflect, ubar0, ubar1, cos_theta, F0PI, controls=controls,
            b_top=b_top, stream=stream, delta_eddington=delta_eddington,
            hard_surface=hard_surface)
    if taugas.device.type != 'cuda':
        raise ValueError(f'spectrum_toon: unsupported device {taugas.device}')
    _check_controls(controls, stream)
    dev = taugas.device
    nlayer, nwno = taugas.shape
    if nlayer < 2:
        raise ValueError('spectrum_toon: needs at least 2 layers')
    ng, nt = ubar0.shape
    nang = ng * nt
    f32 = torch.float32
    strips = dict(zip(_STRIPS, (taugas, tauray, cld_opd, cld_w0, cld_g0, rf)))
    named = dict(strips, all_b=all_b, surf_reflect=surf_reflect, F0PI=F0PI,
                 ubar0=ubar0, ubar1=ubar1)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f'spectrum_toon: {name} on {t.device}, taugas '
                             f'on {dev}')
        if t.dtype != f32:
            raise TypeError(f'spectrum_toon: {name} must be float32, got '
                            f'{t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'spectrum_toon: {name} must be contiguous')
    for name, t in strips.items():
        if t.shape != (nlayer, nwno):
            raise ValueError(f'spectrum_toon: {name} {tuple(t.shape)} != '
                             f'{(nlayer, nwno)}')
    if all_b.shape != (nlayer + 1, nwno):
        raise ValueError(f'spectrum_toon: all_b {tuple(all_b.shape)} != '
                         f'{(nlayer + 1, nwno)}')
    if surf_reflect.shape != (nwno,) or F0PI.shape != (nwno,):
        raise ValueError('spectrum_toon: surf_reflect and F0PI must be '
                         f'[{nwno}]')
    if ubar1.shape != ubar0.shape:
        raise ValueError('spectrum_toon: ubar0 and ubar1 differ in shape')
    scalars = {}
    for name, v in (('cos_theta', cos_theta), ('ptfac', ptfac)):
        if isinstance(v, torch.Tensor) and (v.device != dev or v.numel() != 1):
            raise ValueError(f'spectrum_toon: {name} must be one value on '
                             f'{dev}')
        scalars[name] = torch.as_tensor(v, dtype=f32, device=dev).reshape(1)

    from .._build import check, library
    lib = library()
    u0 = ubar0.reshape(-1).contiguous()
    u1 = ubar1.reshape(-1).contiguous()
    xint = torch.empty((nang, nwno), dtype=f32, device=dev)
    therm = torch.empty((nang, nwno), dtype=f32, device=dev)
    scratch = torch.empty((lib.toon_spectrum_scratch_slots(), nlayer + 1,
                           nwno), dtype=f32, device=dev)
    c = controls
    with torch.cuda.device(dev):
        stream_handle = torch.cuda.current_stream(dev).cuda_stream
        code = lib.toon_spectrum_launch(
            all_b.data_ptr(), taugas.data_ptr(), tauray.data_ptr(),
            cld_opd.data_ptr(), cld_w0.data_ptr(), cld_g0.data_ptr(),
            rf.data_ptr(), surf_reflect.data_ptr(), F0PI.data_ptr(),
            u0.data_ptr(), u1.data_ptr(), scalars['cos_theta'].data_ptr(),
            scalars['ptfac'].data_ptr(), xint.data_ptr(), therm.data_ptr(),
            scratch.data_ptr(), nlayer, nwno, nang, c.single_phase,
            c.multi_phase, c.toon_coefficients, c.frac_a, c.frac_b,
            c.frac_c, c.constant_back, c.constant_forward, b_top,
            int(stream), int(bool(delta_eddington)), int(bool(hard_surface)),
            stream_handle)
    check(code, 'spectrum_toon')
    spectrum_toon.launches += 1
    return xint.reshape(ng, nt, nwno), therm.reshape(ng, nt, nwno)


spectrum_toon.launches = 0
