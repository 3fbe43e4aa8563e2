"""Moist adiabatic gradient (latent-heat release of condensables).

Port of ``picaso_tpu/climate/moist.py`` (reference climate.py:2137-2541):
the coefficient tables (critical and freezing points, heats of fusion,
NIST Shomate-style specific heats) and ``moist_grad``, the T. Robinson
moist-gradient formula, as torch operations on whole level vectors; the
JAX ``jnp.where`` cascades are ``torch.where`` cascades here.

Condensables follow the reference: H2O, CH4, NH3, Fe (climate.py:2250-2255).
"""

from __future__ import annotations

import torch

from .adiabat import AdiabatGrid, did_grad_cp

__all__ = ['moist_grad', 'moist_grad_from_dry', 'cp_gas',
           'heat_of_vaporization', 'COND_CONSTANTS', 'SHOMATE']

RGAS = 8.314e7  # erg/K/mol

# Tcrit [K], Tfreeze [K], heat of fusion [erg/mol] (climate.py:2250-2255)
COND_CONSTANTS = {
    'H2O': (647.0, 273.0, 6.00e10),
    'CH4': (191.0, 90.0, 9.46e9),
    'NH3': (406.0, 195.0, 5.65e10),
    'Fe': (4000.0, 1150.0, 1.4e11),
}

# NIST Shomate-style cp polynomials, three T ranges (climate.py:2349-2502):
# cp[J/K/mol] = A + B t + C t^2 + D t^3 + E/t^2, t = T/1000
SHOMATE = {
    'H2O': ([33.7476, 22.1440, 43.2009], [-6.85376, 24.6949, 7.91703],
            [24.6006, -6.23914, -1.35732], [-10.2578, 0.576813, 0.0883558],
            [0.000170650, -0.0143783, -12.3810], 33.299),
    'CH4': ([30.1333, 33.3642, 107.517], [-10.7805, 62.9633, -0.420051],
            [116.987, -20.9146, 0.158105], [-64.8550, 2.54256, -0.0135050],
            [0.0315890, -6.26634, -53.2270], 33.258),
    'CO': ([30.7036, 34.2259, 35.3293], [-11.7368, 1.51655, 1.14525],
           [25.8658, 0.0492481, -0.170423], [-11.6476, -0.0690167,
                                             0.0111323],
           [-0.00675277, -2.61424, -2.85798], 29.104),
    'NH3': ([28.6905, 48.0925, 89.3168], [14.9648, 16.6892, -0.0283260],
            [32.2849, -0.765783, -0.403009], [-19.5766, -0.465621,
                                              0.0366428],
            [0.0281968, -7.37491, -68.5295], 33.284),
    'N2': ([30.7036, 34.2259, 35.3293], [-11.7368, 1.51655, 1.14525],
           [25.8658, 0.0492481, -0.170423], [-11.6476, -0.0690167,
                                             0.0111323],
           [-0.00675277, -2.61424, -2.85798], 29.104),
    'PH3': ([24.1623, 75.4246, 82.3854], [35.7131, -0.467915, 0.229399],
            [28.4716, 2.70503, -0.0280155], [-24.2205, -0.650872,
                                             0.00135605],
            [0.0530053, -13.0455, -24.2573], 33.259),
    'H2S': ([32.3729, 45.0479, 59.8489], [-1.43579, 7.28547, -0.380368],
            [29.0118, -0.645552, 0.218138], [-14.1925, -0.109566,
                                             -0.0148742],
            [0.00759539, -6.02580, -21.7958], 33.259),
    'TiO': ([24.6205, 42.5795, 25.6986], [30.8607, -3.86291, 2.45240],
            [-23.2493, 1.15148, 0.770717], [5.39026, -0.0315822,
                                            -0.0946717],
            [0.0642488, -2.14344, 26.1268], 33.880),
    'VO': ([23.6324, 40.2277, 31.0958], [28.8676, -2.68241, 0.0444865],
           [-21.5825, 0.855477, 1.06932], [5.35779, -0.00729363,
                                           -0.106395],
           [0.0281114, -2.10348, 13.7865], 29.106),
    'Fe': ([22.5120, 29.3785, 31.0353], [23.6042, -12.7912, -3.09778],
           [-49.5765, 6.80824, 0.766662], [26.1116, -0.979241, 0.00158800],
           [-0.0305055, 0.0621550, -22.0154], 21.387),
    'FeH': ([17.0970, 43.7692, 80.0135], [52.0678, 0.968978, -18.2832],
            [-34.3367, 0.818403, 3.55466], [7.96189, -0.356898, -0.288758],
            [0.455643, -1.88073, -41.0125], 34.906),
    'CrH': ([24.6453, 40.9948, 100.083], [12.9392, -3.29251, -36.2074],
            [0.0477315, 1.40327, 7.79945], [-2.45803, -0.0468814,
                                            -0.458881],
            [0.0859445, -3.87926, -68.1415], 29.417),
    'Na': ([20.8154, 21.0812, 38.7681], [-0.162936, -0.0211313, -9.69137],
           [0.281035, -0.188686, 1.61045], [-0.149202, 0.0703542,
                                            -0.0183163],
           [-0.000166252, -0.169969, -21.5246], 20.786),
    'K': ([20.8154, 20.1077, 80.8587], [-0.162936, 1.72326, -38.6316],
          [0.281035, -1.42054, 8.80886], [-0.149202, 0.388577, -0.553605],
          [-0.000166252, -0.0178336, -57.1459], 20.786),
    'Rb': ([20.8110, 21.8305, 67.6946], [-0.139382, -0.120618, -36.4056],
           [0.241553, -0.759797, 9.45407], [-0.129505, 0.324361,
                                            -0.654225],
           [-0.000134562, -0.519578, -22.9711], 20.786),
    'Cs': ([20.8111, 19.3844, -99.0597], [-0.139259, 3.51623, 42.3576],
           [0.238592, -3.00169, -2.76224], [-0.126005, 0.867065,
                                            -0.0552789],
           [-0.000147773, 0.0177750, 218.172], 20.786),
    'CO2': ([17.1622, 59.7854, 65.7964], [84.3617, -0.472970, -1.17414],
            [-71.5668, 1.36583, 0.232788], [24.3579, -0.300212,
                                            -0.00788867],
            [0.0429191, -6.20314, -17.2749], 20.786),
}


def cp_gas(mol, T, mmw):
    """cp in erg/g/K from the Shomate ranges (climate.py:2504-2541)."""
    A, B, C, D, E, default_cp = SHOMATE[mol]
    t = T / 1000.0

    def poly(it):
        return (A[it] + B[it] * t + C[it] * t ** 2 + D[it] * t ** 3
                + E[it] / t ** 2)

    cp = torch.where(T > 2500.0, poly(2),
                     torch.where(T > 1000.0, poly(1),
                                 torch.where(T > 100.0, poly(0),
                                             torch.full_like(t, default_cp))))
    return cp / mmw * 1e7


def heat_of_vaporization(mol, T, mmw):
    """Hvap in erg/mol (climate.py:2275-2306), zero above Tcrit."""
    zero = torch.zeros_like(T)
    if mol == 'H2O':
        t = T / 647.0
        h = (51.67 * torch.exp(0.199 * t)
             * torch.clamp(1 - t, min=0.0) ** 0.410)
        return torch.where(T < 647.0, h, zero) * 1e10
    if mol == 'CH4':
        t = T / 191.0
        h = 10.11 * torch.exp(0.22 * t) * torch.clamp(1 - t, min=0.0) ** 0.388
        return torch.where(T < 191.0, h, zero) * 1e10
    if mol == 'NH3':
        t = T - 273.0
        arg = torch.clamp(133.0 - t, min=0.0)
        h = (137.91 * torch.sqrt(arg) - 2.466 * arg) / 1e3 * mmw
        return torch.where(T < 406.0, h, zero) * 1e10
    if mol == 'Fe':
        return torch.where(T < 4000.0, zero + 3.50e2, zero) * 1e10
    raise ValueError(f'{mol} is not a supported condensable '
                     f'({list(COND_CONSTANTS)})')


def moist_grad_from_dry(t, gradNI, cond_abunds, condensables, cond_weights):
    """The moist gradient at temperature(s) t from the dry one ``gradNI``
    there (the second half of :func:`moist_grad`; the profile
    reconstruction looks the dry gradient up with its pressure cells taken
    once)."""
    a_sum_num = 0.0
    a_sum_den = 0.0
    f = 0.0
    cpI = 0.0
    zero = torch.zeros_like(t)
    for i, mol in enumerate(condensables):
        Tcrit, Tfr, hfus = COND_CONSTANTS[mol]
        dH = torch.where(t < Tcrit,
                         heat_of_vaporization(mol, t, cond_weights[i]), zero)
        dH = dH + torch.where(t < Tfr, zero + hfus, zero)
        q = cond_abunds[i]
        a = dH / RGAS / t
        a_sum_num = a_sum_num + a * q            # a_i * (p_c/p) with p_c=q p
        a_sum_den = a_sum_den + a ** 2 * q
        f = f + q
        cpI = cpI + q * cp_gas(mol, t, cond_weights[i]) * cond_weights[i]

    cp_NI = RGAS / gradNI
    gradb = 1.0 / ((1.0 - f) * cp_NI / RGAS + f * cpI / RGAS)

    numer = 1.0 + a_sum_num
    denom = 1.0 / gradb + a_sum_den
    return numer / denom


def moist_grad(t, p_bar, adiabat: AdiabatGrid, cond_abunds, condensables,
               cond_weights):
    """Moist adiabatic gradient (climate.py:2137-2243), vectorized.

    t, p_bar: [n] tensors (or 0-d); cond_abunds: [ncond] or [ncond, n]
    mixing ratios at the evaluation points (``cond_abunds[i]`` is
    condensable i); condensables: names; cond_weights: molecular weights
    (g/mol), same order.  Returns (grad_x, cp_x) like ``did_grad_cp``.
    """
    gradNI, cp_x = did_grad_cp(t, p_bar, adiabat)
    return moist_grad_from_dry(t, gradNI, cond_abunds, condensables,
                               cond_weights), cp_x
