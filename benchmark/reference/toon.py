# Frozen copy of picaso_tpu_torch/rt/toon.py at commit d22d65a, with its
# imports made local to this package.  The benchmark's yardstick:
# edit only to fix a fault of the copy, never to follow the port.
"""Toon et al. (1989) two-stream radiative transfer, plain PyTorch.

Port of ``picaso_tpu/rt/toon.py`` (reference picaso fluxes.py):

* ``get_reflected_1d`` (fluxes.py:1010-1413) -> :func:`reflected_1d`, the
  top-of-atmosphere intensity or, with ``get_lvl_flux=True``, the level
  and midpoint fluxes (fluxes.py:1219-1257) the climate solve reads
* ``get_thermal_1d``   (fluxes.py:1683-1912) -> :func:`thermal_1d` and
  :func:`thermal_toa` (top-of-atmosphere flux), :func:`thermal_levels`
  (level and midpoint fluxes of both sweeps, for the climate solve)
* blackbody helpers    (fluxes.py:1609-1680) -> :func:`blackbody`,
  :func:`blackbody_integrated`

This is the plain reference path of the port (``use_kernels=False``), the
counterpart of the JAX scan path.  The disk angles are a batch axis
([nlayer, nang, ...] inside), the layer recursions Python loops.  The
columns (wavelength, and in the climate solve the CK gauss points and the
Jacobian's perturbations) are the trailing axes: every column's solve is
independent, so one call covers all of them.

Deliberate reference quirks preserved: exponent clipping (35 in f64, 10
in f32), the tau_top fake boundary (fluxes.py:1797-1800), mu1=0.5
hemispheric mean, ubar2=0.767 Rayleigh fit, reverse-order Thomas
elimination.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from . import _exp_clip
from .constants import PLANCK_C1, PLANCK_C2
from .tridiag import solve_two_stream

__all__ = ['ScatteringControls', 'FluxSet', 'reflected_1d', 'thermal_1d',
           'thermal_toa', 'thermal_levels', 'blackbody',
           'blackbody_integrated']

PI = math.pi


def _safe(den, eps=1e-6):
    """Sign-preserving clamp of the lamda*mu -> 1 resonance denominators
    (see picaso_tpu/rt/toon.py:_safe)."""
    return torch.where(torch.abs(den) < eps,
                       torch.where(den < 0, den.new_tensor(-eps),
                                   den.new_tensor(eps)), den)


def _resonant_ratio(num, den, limit, eps=1e-4):
    """``num / den`` with the analytic limit substituted near ``den = 0``.

    The |den|-only rule of picaso_tpu/rt/toon.py:67-98, which documents
    why the switch must NOT be widened (a wider series arm broke the
    climate solver; tests/test_resonant_clip.py pins the rule).
    """
    return torch.where(torch.abs(den) < eps, limit, num / _safe(den))


def _dither_u0(lamda, u0, delta=None):
    """Beam-angle dither off the lamda*u0 = 1 resonance (toon.py:101-119):
    delta = 1e-3 in f32, 1e-8 in f64."""
    if delta is None:
        delta = 1e-3 if lamda.dtype == torch.float32 else 1e-8
    resonant = torch.abs(lamda * u0 - 1.0) < delta
    return torch.where(resonant, 1.0 / (lamda * (1.0 + delta)), u0)


@dataclasses.dataclass(frozen=True)
class ScatteringControls:
    """Phase-function / scheme options (reference justdoit.py:5512-5658).

    single_phase: 0=cahoy 1=OTHG 2=TTHG 3=TTHG_ray
    multi_phase:  0=N=2   1=N=1   2=isotropic
    toon_coefficients: 0=quadrature 1=eddington
    """
    single_phase: int = 3
    multi_phase: int = 0
    toon_coefficients: int = 0
    frac_a: float = 1.0
    frac_b: float = -1.0
    frac_c: float = 2.0
    constant_back: float = -0.5
    constant_forward: float = 1.0


class FluxSet(NamedTuple):
    """Level and midpoint two-stream fluxes, each [ng, nt, nlevel, ...]
    (the midpoint arrays end in a row of zeros, as in the JAX package)."""
    minus: torch.Tensor
    plus: torch.Tensor
    minus_mdpt: torch.Tensor
    plus_mdpt: torch.Tensor


def blackbody(t, w):
    """Planck flux per unit wavelength (erg/cm^2/s/cm); t[K] x w[cm] grids
    (fluxes.py:1660-1680)."""
    t = torch.atleast_1d(t)
    w = torch.atleast_1d(w)
    return (PLANCK_C1 / w[None, :] ** 5
            / (torch.exp(PLANCK_C2 / (t[:, None] * w[None, :])) - 1.0))


def blackbody_integrated(T, wave, dwave):
    """Bin-integrated Planck energy per wavenumber bin (erg/cm^2/s/cm^-1),
    [nT, nwno]: the 3-point rectangle rule across each bin of
    fluxes.py:1609-1658 (nbb=1: the centre and one point on either side at
    +-dwave/2), as the JAX package's ``blackbody_integrated``."""
    T = torch.atleast_1d(T)
    offsets = torch.tensor([-0.5, 0.0, 0.5], dtype=wave.dtype,
                           device=wave.device)
    wavenum = wave[None, :] + offsets[:, None] * dwave[None, :]  # [3, nwno]
    planck = PLANCK_C1 * wavenum[None, :, :] ** 3 / (
        torch.exp(PLANCK_C2 * wavenum[None, :, :] / T[:, None, None]) - 1.0)
    return planck.sum(dim=1) / 3.0


def _single_phase(controls, cosb_og, gcos2, ftau_cld, ftau_ray, cos_theta):
    """Single-scattering phase function at the phase angle
    (fluxes.py:1298-1373)."""
    sp = controls.single_phase
    if sp != 1:
        g_forward = controls.constant_forward * cosb_og
        g_back = controls.constant_back * cosb_og
        f = controls.frac_a + controls.frac_b * g_back ** controls.frac_c
        HG_fwd = (1 - g_forward ** 2) / torch.sqrt(
            (1 + g_forward ** 2 + 2 * g_forward * cos_theta) ** 3)
        HG_back = (1 - g_back ** 2) / torch.sqrt(
            (1 + g_back ** 2 + 2 * g_back * cos_theta) ** 3)
    if sp == 0:  # cahoy
        return f * HG_fwd + (1 - f) * HG_back + gcos2
    if sp == 1:  # OTHG
        return (1 - cosb_og ** 2) / torch.sqrt(
            (1 + cosb_og ** 2 + 2 * cosb_og * cos_theta) ** 3)
    if sp == 2:  # TTHG
        return f * HG_fwd + (1 - f) * HG_back
    if sp == 3:  # TTHG_ray
        return (ftau_cld * (f * HG_fwd + (1 - f) * HG_back)
                + ftau_ray * (0.75 * (1 + cos_theta ** 2.0)))
    raise ValueError(f'unknown single_phase {sp}')


def reflected_1d(dtau, tau, w0, cosb, gcos2, ftau_cld, ftau_ray,
                 dtau_og, tau_og, w0_og, cosb_og,
                 surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                 controls: ScatteringControls = ScatteringControls(),
                 b_top=0.0, get_lvl_flux: bool = False):
    """Disk-resolved reflected light: TOA intensity [ng, nt, *cols].

    Array args are [nlayer(+1), *cols] (cols: [nwno], or any trailing
    column axes; F0PI and surf_reflect broadcast against them); ubar0/ubar1
    [ng, nt]; cos_theta a scalar.  Same arithmetic as
    toon.reflected_1d(get_toa_intensity=True, get_lvl_flux=False) of the
    JAX package.  With ``get_lvl_flux=True`` it returns the level and
    midpoint fluxes instead, a :class:`FluxSet` (the JAX call with
    ``get_toa_intensity=False, get_lvl_flux=True``, fluxes.py:1219-1257).
    """
    dtype = dtau.dtype
    sq3 = math.sqrt(3.0)
    if controls.toon_coefficients == 1:  # eddington (fluxes.py:1134)
        g1 = (7.0 - w0 * (4.0 + 3.0 * ftau_cld * cosb)) / 4.0
        g2 = -(1.0 - w0 * (4.0 - 3.0 * ftau_cld * cosb)) / 4.0
    else:  # quadrature (fluxes.py:1137)
        g1 = (sq3 * 0.5) * (2.0 - w0 * (1.0 + ftau_cld * cosb))
        g2 = (sq3 * w0 * 0.5) * (1.0 - ftau_cld * cosb)
    lamda = torch.sqrt(g1 ** 2 - g2 ** 2)
    # stable form of (g1 - lamda)/g2 (toon.py:344-348)
    gama = g2 / (g1 + lamda)
    exptrm = torch.clamp(lamda * dtau, max=_exp_clip(dtype))
    exptrm_positive = torch.exp(exptrm)
    exptrm_minus = 1.0 / exptrm_positive
    p_single = _single_phase(controls, cosb_og, gcos2, ftau_cld, ftau_ray,
                             cos_theta)

    ng, nt = ubar0.shape
    cols = dtau.shape[1:]
    # angles on axis 1: per-angle arrays are [nlayer, nang, *cols]
    u0 = ubar0.reshape((1, -1) + (1,) * len(cols)).to(dtype)
    u1 = ubar1.reshape((1, -1) + (1,) * len(cols)).to(dtype)
    L = lambda x: x.unsqueeze(1)  # noqa: E731  layer array -> angle-broadcast

    if controls.toon_coefficients == 1:
        g3 = (2.0 - 3.0 * L(ftau_cld) * L(cosb) * u0) / 4.0
    else:
        g3 = 0.5 * (1.0 - sq3 * L(ftau_cld) * L(cosb) * u0)
    g4 = 1.0 - g3
    u0b = _dither_u0(L(lamda), u0)
    denominator = L(lamda) ** 2 - 1.0 / u0b ** 2
    a_minus = (F0PI * L(w0) * (g4 * (L(g1) + 1.0 / u0b) + L(g2) * g3)
               / denominator)
    a_plus = (F0PI * L(w0) * (g3 * (L(g1) - 1.0 / u0b) + L(g2) * g4)
              / denominator)
    x_up = torch.exp(-L(tau[:-1]) / u0b)
    c_minus_up = a_minus * x_up
    c_plus_up = a_plus * x_up
    e_u0dt = torch.exp(-L(dtau) / u0b)
    x_dn = x_up * e_u0dt
    c_minus_down = a_minus * x_dn
    c_plus_down = a_plus * x_dn
    b_surface = 0.0 + surf_reflect * u0[0] * F0PI * torch.exp(
        -tau[-1] / u0[0])

    positive, negative = solve_two_stream(
        c_plus_up, c_minus_up, c_plus_down, c_minus_down, b_top, b_surface,
        surf_reflect, L(gama), L(dtau), L(exptrm_positive),
        L(exptrm_minus))

    if get_lvl_flux:
        # level fluxes (fluxes.py:1219-1257)
        f_minus_top = positive * L(gama) + negative + c_minus_up
        f_plus_top = positive + L(gama) * negative + c_plus_up
        flux_zero_minus = (gama[-1] * positive[-1] * exptrm_positive[-1]
                           + negative[-1] * exptrm_minus[-1]
                           + c_minus_down[-1])
        flux_zero_plus = (positive[-1] * exptrm_positive[-1]
                          + gama[-1] * negative[-1] * exptrm_minus[-1]
                          + c_plus_down[-1])
        flux_minus = torch.cat([f_minus_top, flux_zero_minus[None]], 0)
        flux_plus = torch.cat([f_plus_top, flux_zero_plus[None]], 0)
        flux_minus = flux_minus + u0 * F0PI * torch.exp(-L(tau) / u0)

        exptrm_positive_mid = torch.exp(0.5 * exptrm)
        exptrm_minus_mid = 1.0 / exptrm_positive_mid
        taumid = tau[:-1] + 0.5 * dtau
        x_mid = torch.exp(-L(taumid) / u0b)
        c_plus_mid = a_plus * x_mid
        c_minus_mid = a_minus * x_mid
        fm_mid = (L(gama) * positive * L(exptrm_positive_mid)
                  + negative * L(exptrm_minus_mid) + c_minus_mid)
        fp_mid = (positive * L(exptrm_positive_mid)
                  + L(gama) * negative * L(exptrm_minus_mid) + c_plus_mid)
        fm_mid = fm_mid + u0 * F0PI * torch.exp(-L(taumid) / u0)
        zrow = torch.zeros_like(fm_mid[:1])
        return _flux_set(ng, nt, flux_minus, flux_plus,
                         torch.cat([fm_mid, zrow], 0),
                         torch.cat([fp_mid, zrow], 0))

    flux_zero = (positive[-1] * exptrm_positive[-1]
                 + gama[-1] * negative[-1] * exptrm_minus[-1]
                 + c_plus_down[-1])
    xint = flux_zero / PI

    if controls.multi_phase == 0:  # N=2
        ubar2 = 0.767
        multi_plus = (1.0 + 1.5 * L(ftau_cld) * L(cosb) * u1
                      + L(gcos2) * (3.0 * ubar2 * ubar2 * u1 * u1 - 1.0) / 2.0)
        multi_minus = (1.0 - 1.5 * L(ftau_cld) * L(cosb) * u1
                       + L(gcos2) * (3.0 * ubar2 * ubar2 * u1 * u1 - 1.0)
                       / 2.0)
    elif controls.multi_phase == 1:  # N=1
        multi_plus = 1.0 + 1.5 * L(ftau_cld) * L(cosb) * u1
        multi_minus = 1.0 - 1.5 * L(ftau_cld) * L(cosb) * u1
    elif controls.multi_phase == 2:  # isotropic: unit Legendre terms, as
        # the JAX scan path (picaso_tpu/rt/toon.py:276-282)
        multi_plus = torch.ones_like(L(cosb) * u1)
        multi_minus = multi_plus
    else:
        raise ValueError(f'unknown multi_phase {controls.multi_phase}')

    G = positive * (multi_plus + L(gama) * multi_minus) * L(w0) * (0.5 / PI)
    H = negative * (L(gama) * multi_plus + multi_minus) * L(w0) * (0.5 / PI)
    A = (multi_plus * c_plus_up + multi_minus * c_minus_up) * L(w0) * (
        0.5 / PI)

    trans = torch.exp(-L(dtau) / u1)
    ssterm = ((L(w0_og) * F0PI / (4.0 * PI)) * L(p_single)
              * torch.exp(-L(tau_og[:-1]) / u0)
              * (1.0 - torch.exp(-L(dtau_og) * (u0 + u1) / (u0 * u1)))
              * (u0 / (u0 + u1)))
    den_u1 = L(lamda) * u1 - 1.0
    hdt1 = L(dtau) / u1
    x1 = hdt1 * den_u1
    msterm = (A * (1.0 - e_u0dt * trans) * (u0 / (u0 + u1))
              + G * _resonant_ratio(
                  L(exptrm_positive) * trans - 1.0, den_u1,
                  hdt1 * (1.0 + x1 * (0.5 + x1 / 6.0)))
              + H * (1.0 - L(exptrm_minus) * trans) / (L(lamda) * u1 + 1.0))
    src = ssterm + msterm
    for i in range(dtau.shape[0] - 1, -1, -1):
        xint = xint * trans[i] + src[i]
    return xint.reshape(ng, nt, *cols)


def _flux_set(ng, nt, *levels):
    """FluxSet of [ng, nt, nlevel, *cols] views of [nlevel, nang, *cols]
    arrays."""
    return FluxSet(*(x.movedim(1, 0).reshape(ng, nt, *x.shape[:1],
                                             *x.shape[2:])
                     for x in levels))


def thermal_1d(tlevel, dtau, w0, cosb, plevel, ubar1, surf_reflect, wno,
               hard_surface: bool = False):
    """Source-function thermal emission (fluxes.py:1683-1912) with the
    monochromatic blackbody (calc_type=0): TOA flux [ng, nt, nwno]."""
    all_b = blackbody(tlevel, 1.0 / wno).to(dtau.dtype)
    # fake isothermal continuation above the model top (fluxes.py:1797-1800)
    tau_top = dtau[0] * plevel[0] / (plevel[1] - plevel[0])
    return thermal_toa(all_b, dtau, w0, cosb, tau_top, surf_reflect, ubar1,
                       hard_surface)


def _thermal_solve(all_b, dtau, w0, cosb, tau_top, surf_reflect,
                   hard_surface):
    """The angle-independent half of the thermal solve (fluxes.py:
    1748-1840): the layer coefficients and the Toon89 system's solution,
    (b0, b1, lamda, gama, g1_plus_g2, exptrm, exptrm_positive,
    exptrm_minus, positive, negative)."""
    mu1 = 0.5  # hemispheric mean, Table 1 Toon (fluxes.py:1748)
    b0 = all_b[:-1]
    b1 = (all_b[1:] - b0) / dtau  # eqn 26 Toon89

    g1 = 2.0 - w0 * (1.0 + cosb)
    g2 = w0 * (1.0 - cosb)
    lamda = torch.sqrt(g1 ** 2 - g2 ** 2)
    gama = g2 / (g1 + lamda)
    g1_plus_g2 = 1.0 / (g1 + g2)

    twopimu = 2.0 * PI * mu1
    c_plus_up = twopimu * (b0 + b1 * g1_plus_g2)
    c_minus_up = twopimu * (b0 - b1 * g1_plus_g2)
    c_plus_down = twopimu * (b0 + b1 * dtau + b1 * g1_plus_g2)
    c_minus_down = twopimu * (b0 + b1 * dtau - b1 * g1_plus_g2)

    exptrm = torch.clamp(lamda * dtau, max=_exp_clip(dtau.dtype))
    exptrm_positive = torch.exp(exptrm)
    exptrm_minus = 1.0 / exptrm_positive

    # fake isothermal continuation above the model top (fluxes.py:1797-1800)
    b_top = (1.0 - torch.exp(-tau_top / mu1)) * all_b[0] * PI
    if hard_surface:
        b_surface = (1.0 - surf_reflect) * all_b[-1] * PI
    else:
        b_surface = (all_b[-1] + b1[-1] * mu1) * PI

    positive, negative = solve_two_stream(
        c_plus_up, c_minus_up, c_plus_down, c_minus_down, b_top, b_surface,
        surf_reflect, gama, dtau, exptrm_positive, exptrm_minus)
    return (b0, b1, lamda, gama, g1_plus_g2, exptrm, exptrm_positive,
            exptrm_minus, positive, negative)


def thermal_toa(all_b, dtau, w0, cosb, tau_top, surf_reflect, ubar1,
                hard_surface: bool = False):
    """TOA thermal flux [ng, nt, nwno] from the level Planck function
    all_b [nlevel, nwno] and the above-model optical depth tau_top [nwno]:
    the body of thermal_1d, with the contract of the JAX package's
    ``thermal_pallas`` (and the arithmetic of its ``_thermal_core``: the
    interleaved solve below performs the same operations, row for row)."""
    nlayer, nwno = dtau.shape
    mu1 = 0.5
    (b0, b1, lamda, gama, g1_plus_g2, exptrm, exptrm_positive, exptrm_minus,
     positive, negative) = _thermal_solve(all_b, dtau, w0, cosb, tau_top,
                                          surf_reflect, hard_surface)

    # source-function technique, Table 3 Toon (fluxes.py:1842-1849)
    G = (1.0 / mu1 - lamda) * positive
    H = gama * (lamda + 1.0 / mu1) * negative
    alpha1 = 2.0 * PI * (b0 + b1 * (g1_plus_g2 - mu1))
    alpha2 = 2.0 * PI * b1
    exptrm_positive_mdpt = torch.exp(0.5 * exptrm)
    exptrm_minus_mdpt = 1.0 / exptrm_positive_mdpt

    ng, nt = ubar1.shape
    L = lambda x: x[:, None, :]  # noqa: E731  layer array -> angle-broadcast
    iubar = ubar1.reshape(1, -1, 1).to(dtau.dtype)
    if hard_surface:
        fplus_bottom = ((1.0 - surf_reflect) * all_b[-1] * 2.0 * PI).expand(
            iubar.shape[1], nwno)
    else:
        fplus_bottom = (all_b[-1] + b1[-1] * iubar[0]) * 2.0 * PI

    # one exp per angle: the full-layer transmission is the square of the
    # midpoint transmission
    exptrm_angle_mdpt = torch.exp(-0.5 * L(dtau) / iubar)
    exptrm_angle = exptrm_angle_mdpt * exptrm_angle_mdpt
    den = L(lamda) * iubar - 1.0
    hdt = L(dtau) / iubar
    xden = hdt * den
    # upward sweep (fluxes.py:1897-1907): the midpoint flux of the top
    # layer is the TOA flux the reference reports
    up_full = (L(G) * _resonant_ratio(
                   L(exptrm_positive) * exptrm_angle - 1.0, den,
                   hdt * (1.0 + xden * (0.5 + xden / 6.0)))
               + L(H) / (L(lamda) * iubar + 1.0)
               * (1.0 - L(exptrm_minus) * exptrm_angle)
               + L(alpha1) * (1.0 - exptrm_angle)
               + L(alpha2) * (iubar - (L(dtau) + iubar) * exptrm_angle))
    up_mid = (L(G) * _resonant_ratio(
                  L(exptrm_positive) * exptrm_angle_mdpt
                  - L(exptrm_positive_mdpt), den,
                  L(exptrm_positive_mdpt) * 0.5 * hdt
                  * (1.0 + 0.25 * xden + xden * xden / 24.0))
              - L(H) / (L(lamda) * iubar + 1.0)
              * (L(exptrm_minus) * exptrm_angle_mdpt - L(exptrm_minus_mdpt))
              + L(alpha1) * (1.0 - exptrm_angle_mdpt)
              + L(alpha2) * (iubar + 0.5 * L(dtau)
                             - (L(dtau) + iubar) * exptrm_angle_mdpt))
    fp = fplus_bottom
    for i in range(nlayer - 1, -1, -1):
        fp_mid = fp * exptrm_angle_mdpt[i] + up_mid[i]
        fp = fp * exptrm_angle[i] + up_full[i]
    return fp_mid.reshape(ng, nt, nwno)


def thermal_levels(all_b, dtau, w0, cosb, tau_top, surf_reflect, ubar1,
                   hard_surface: bool = False) -> FluxSet:
    """Level and midpoint thermal fluxes of the source-function technique
    (fluxes.py:1683-1912): the FluxSet of the JAX package's ``thermal_1d``
    (each [ng, nt, nlevel, *cols]).

    all_b [nlevel, *cols] is the level Planck function (the climate solve
    passes the bin-integrated one, ``calc_type=1``); dtau, w0, cosb
    [nlayer, *cols] and tau_top (the above-model optical depth, [*cols])
    broadcast against it, so columns that share optics (the Jacobian's
    perturbations) share their optics arrays.  Same arithmetic as the JAX
    ``thermal_1d``: the solve, then per angle the downward and upward
    sweeps over the layers (fluxes.py:1883-1907) with the removable
    lamda*ubar -> 1 singularities through ``_resonant_ratio``.
    """
    nlayer = dtau.shape[0]
    mu1 = 0.5
    (b0, b1, lamda, gama, g1_plus_g2, exptrm, exptrm_positive, exptrm_minus,
     positive, negative) = _thermal_solve(all_b, dtau, w0, cosb, tau_top,
                                          surf_reflect, hard_surface)

    # source-function technique, Table 3 Toon (fluxes.py:1842-1849)
    G = (1.0 / mu1 - lamda) * positive
    H = gama * (lamda + 1.0 / mu1) * negative
    J = gama * (lamda + 1.0 / mu1) * positive
    K = (1.0 / mu1 - lamda) * negative
    alpha1 = 2.0 * PI * (b0 + b1 * (g1_plus_g2 - mu1))
    alpha2 = 2.0 * PI * b1
    sigma1 = 2.0 * PI * (b0 - b1 * (g1_plus_g2 - mu1))
    sigma2 = alpha2
    exptrm_positive_mdpt = torch.exp(0.5 * exptrm)
    exptrm_minus_mdpt = 1.0 / exptrm_positive_mdpt

    ng, nt = ubar1.shape
    L = lambda x: x.unsqueeze(1)  # noqa: E731  layer array -> angle-broadcast
    iubar = ubar1.reshape((1, -1) + (1,) * (positive.dim() - 1)).to(
        dtau.dtype)
    if hard_surface:
        fplus_bottom = ((1.0 - surf_reflect) * all_b[-1] * 2.0 * PI
                        ).expand(torch.broadcast_shapes(iubar[0].shape,
                                                        b1[-1].shape))
    else:
        fplus_bottom = (all_b[-1] + b1[-1] * iubar[0]) * 2.0 * PI
    fminus_top = ((1.0 - torch.exp(-tau_top / iubar[0])) * all_b[0]
                  * 2.0 * PI)

    # one exp per angle: the full-layer transmission is the square of the
    # midpoint transmission
    exptrm_angle_mdpt = torch.exp(-0.5 * L(dtau) / iubar)
    exptrm_angle = exptrm_angle_mdpt * exptrm_angle_mdpt
    lam = L(lamda)
    den = lam * iubar - 1.0
    hdt = L(dtau) / iubar           # lamda*dtau at the resonance
    xden = hdt * den
    dn_full = (L(J) / (lam * iubar + 1.0)
               * (L(exptrm_positive) - exptrm_angle)
               + L(K) * _resonant_ratio(
                   exptrm_angle - L(exptrm_minus), den,
                   L(exptrm_minus) * hdt
                   * (1.0 + xden * (0.5 + xden / 6.0)))
               + L(sigma1) * (1.0 - exptrm_angle)
               + L(sigma2) * (iubar * exptrm_angle + L(dtau) - iubar))
    dn_mid = (L(J) / (lam * iubar + 1.0)
              * (L(exptrm_positive_mdpt) - exptrm_angle_mdpt)
              + L(K) * _resonant_ratio(
                  L(exptrm_minus_mdpt) - exptrm_angle_mdpt, -den,
                  exptrm_angle_mdpt * 0.5 * hdt
                  * (1.0 - 0.25 * xden + xden * xden / 24.0))
              + L(sigma1) * (1.0 - exptrm_angle_mdpt)
              + L(sigma2) * (iubar * exptrm_angle_mdpt + 0.5 * L(dtau)
                             - iubar))
    # downward sweep (fluxes.py:1883-1893), written into the outputs
    shape = (nlayer + 1,) + torch.broadcast_shapes(fminus_top.shape,
                                                   dn_full.shape[1:])
    minus = torch.empty(shape, dtype=dtau.dtype, device=dtau.device)
    minus_mdpt = torch.empty_like(minus)
    minus[0] = fminus_top
    minus_mdpt[nlayer] = 0.0
    # per-layer views, taken once (each index would be a dispatch)
    t_mid, t_full = exptrm_angle_mdpt.unbind(0), exptrm_angle.unbind(0)
    m_lev, m_mid = minus.unbind(0), minus_mdpt.unbind(0)
    for i, (s_mid, s_full) in enumerate(zip(dn_mid.unbind(0),
                                            dn_full.unbind(0))):
        torch.add(m_lev[i] * t_mid[i], s_mid, out=m_mid[i])
        torch.add(m_lev[i] * t_full[i], s_full, out=m_lev[i + 1])
    del dn_full, dn_mid

    # upward sweep (fluxes.py:1897-1907)
    up_full = (L(G) * _resonant_ratio(
                   L(exptrm_positive) * exptrm_angle - 1.0, den,
                   hdt * (1.0 + xden * (0.5 + xden / 6.0)))
               + L(H) / (lam * iubar + 1.0)
               * (1.0 - L(exptrm_minus) * exptrm_angle)
               + L(alpha1) * (1.0 - exptrm_angle)
               + L(alpha2) * (iubar - (L(dtau) + iubar) * exptrm_angle))
    up_mid = (L(G) * _resonant_ratio(
                  L(exptrm_positive) * exptrm_angle_mdpt
                  - L(exptrm_positive_mdpt), den,
                  L(exptrm_positive_mdpt) * 0.5 * hdt
                  * (1.0 + 0.25 * xden + xden * xden / 24.0))
              - L(H) / (lam * iubar + 1.0)
              * (L(exptrm_minus) * exptrm_angle_mdpt - L(exptrm_minus_mdpt))
              + L(alpha1) * (1.0 - exptrm_angle_mdpt)
              + L(alpha2) * (iubar + 0.5 * L(dtau)
                             - (L(dtau) + iubar) * exptrm_angle_mdpt))
    plus = torch.empty_like(minus)
    plus_mdpt = torch.empty_like(minus)
    plus[nlayer] = fplus_bottom
    plus_mdpt[nlayer] = 0.0
    p_lev, p_mid = plus.unbind(0), plus_mdpt.unbind(0)
    s_mid, s_full = up_mid.unbind(0), up_full.unbind(0)
    for i in range(nlayer - 1, -1, -1):
        torch.add(p_lev[i + 1] * t_mid[i], s_mid[i], out=p_mid[i])
        torch.add(p_lev[i + 1] * t_full[i], s_full[i], out=p_lev[i])
    return _flux_set(ng, nt, minus, plus, minus_mdpt, plus_mdpt)
