# Frozen copy of picaso_tpu_torch/rayleigh.py at commit d22d65a, with its
# imports made local to this package.  The benchmark's yardstick:
# edit only to fix a fault of the copy, never to follow the port.
"""Rayleigh scattering cross sections.

Host (numpy) copy of ``picaso_tpu/rayleigh.py`` for the PyTorch port, which
must not import the JAX package.  Keep the two in step.

Port of the semantics of the reference ``picaso/rayleigh.py`` (which is
itself adapted from code by Ryan MacDonald): per-species refractive indices /
King correction factors with wavelength-dependent formulas for the nine
well-measured species and a tabulated-polarisability fallback for everything
else.  Host-side numpy computed once per wavenumber grid at load time; the
resulting sigma tables become device-resident constants.

sigma = 24 pi^3 nu^4 / n_ref^2 * ((eta^2-1)/(eta^2+2))^2 * F_king, returned in
cm^2/g after the Avogadro scaling used by the reference (rayleigh.py:108-110).
"""

from __future__ import annotations

import numpy as np

from .constants import AVOGADRO

__all__ = ['POLARISABILITIES', 'RAYLEIGH_MOLECULES', 'compute_sigma',
           'rayleigh_sigma_table']

# CGS polarisabilities, cm^3 (rayleigh.py:67-76)
POLARISABILITIES = {
    'H2': 0.80e-24, 'He': 0.21e-24, 'N2': 1.74e-24, 'O2': 1.58e-24,
    'O3': 3.21e-24, 'H2O': 1.45e-24, 'CH4': 2.59e-24, 'CO': 1.95e-24,
    'CO2': 2.91e-24, 'NH3': 2.26e-24, 'HCN': 2.59e-24, 'PH3': 4.84e-24,
    'SO2': 3.72e-24, 'SO3': 4.84e-24, 'C2H2': 3.33e-24, 'H2S': 3.78e-24,
    'NO': 1.70e-24, 'NO2': 3.02e-24, 'H3+': 0.385e-24, 'OH': 6.965e-24,
    'Na': 24.11e-24, 'K': 42.9e-24, 'Li': 24.33e-24, 'Rb': 47.39e-24,
    'Cs': 59.42e-24, 'TiO': 16.9e-24, 'VO': 14.4e-24, 'AlO': 8.22e-24,
    'SiO': 5.53e-24, 'CaO': 23.8e-24, 'TiH': 16.9e-24, 'MgH': 10.5e-24,
    'NaH': 24.11e-24, 'AlH': 8.22e-24, 'CrH': 11.6e-24, 'FeH': 9.47e-24,
    'CaH': 23.8e-24, 'BeH': 5.60e-24, 'ScH': 21.2e-24,
}

KING_NO_WAVE = {
    'O3': 1.060000, 'CO': 1.016995, 'C2H2': 1.064385, 'C2H6': 1.006063,
    'OCS': 1.138786, 'CH3Cl': 1.026042, 'H2S': 1.001880, 'SO2': 1.062638,
}

RAYLEIGH_MOLECULES = list(POLARISABILITIES.keys())

# number density at 0 C, 1 atm (rayleigh.py:65)
_N_REF = (101325.0 / (1.380649e-23 * 273.15)) * 1.0e-6
_HARTREE_WNO = 219474.6305


def _hohm(wno, f_par, w_par_sq, f_perp, w_perp_sq):
    """Polarisability + anisotropy from the Hohm (1993) dispersion formula."""
    x = (wno / _HARTREE_WNO) ** 2
    alpha = (1.0 / 3.0) * (f_par / (w_par_sq - x)
                           + 2.0 * (f_perp / (w_perp_sq - x)))
    gamma = f_par / (w_par_sq - x) - f_perp / (w_perp_sq - x)
    return alpha, gamma


def _lorentz_lorenz(alpha):
    return np.sqrt((1.0 + (8.0 * np.pi * _N_REF * alpha / 3.0))
                   / (1.0 - (4.0 * np.pi * _N_REF * alpha / 3.0)))


def _king(alpha, gamma):
    return 1.0 + 2.0 * (gamma / (3.0 * alpha)) ** 2


def _hohm_species(wno, f_par, w_par_sq, f_perp, w_perp_sq):
    alpha, gamma = _hohm(wno, f_par, w_par_sq, f_perp, w_perp_sq)
    eta = _lorentz_lorenz(alpha * 0.148184e-24)
    return eta, _king(alpha, gamma)


def _eta_F(species, wno):
    """Refractive index eta(nu) and King factor F(nu); rayleigh.py:112-268."""
    wl = 1e4 / wno
    if species == 'CH4':
        eta = 1.0 + (46662.0e-8 + (4.02e-14 * wno ** 2))
        eta = np.where(wl < 0.325, 1.000504679, eta)
        eta = np.where(wl > 0.633, 1.000476653, eta)
        eta = ((eta - 1.0) * (288.15 / 273.15)) + 1.0
        return eta, np.ones_like(wno)
    if species == 'CO2':
        return _hohm_species(wno, 6.00332, 0.22525399, 8.54433, 0.66083749)
    if species == 'H2':
        return _hohm_species(wno, 1.62632, 0.23940245, 1.40105, 0.29486069)
    if species == 'H2O':
        eta = 1.0 + ((3.011e-2 / (124.40 - 1.0 / (wl ** 2)))
                     + (7.46e-3 * (0.203 - 1.0 / wl))
                     / (1.03 - 1.98e3 / (wl ** 2) + 8.1e4 / (wl ** 4)
                        - 1.7e8 / (wl ** 8)))
        eta = np.where(wl < 0.360, 1.000258047, eta)
        eta = np.where(wl > 17.60, 1.000000000, eta)
        return eta, np.full_like(wno, 1.001005)
    if species == 'He':
        eta = 1.0 + ((0.014755297 / (426.29740 - 1.0 / (wl ** 2)))
                     * 1.0018141444038913)
        eta = np.where(wl < 0.2753, 1.00003578, eta)
        eta = np.where(wl > 0.4801,
                       1.0 + (0.01470091 / (423.98 - 1.0 / (wl ** 2))), eta)
        eta = np.where(wl > 2.0586, 1.00003469, eta)
        return eta, np.ones_like(wno)
    if species == 'N2':
        eta = 1.0 + ((5677.465e-8 + (318.81874e4 / (14.4e9 - wno ** 2)))
                     * 1.0001468057477378)
        eta = np.where(wl < 0.2540, 1.00030493, eta)
        eta = np.where(wl > 0.46816,
                       1.0 + (6498.2e-8 + (307.43305e4 / (14.4e9 - wno ** 2))),
                       eta)
        eta = np.where(wl > 2.0576, 1.00027883, eta)
        eta = ((eta - 1.0) * (288.15 / 273.15)) + 1.0
        F = 1.034 + 3.17e-12 * wno ** 2
        return eta, F
    if species == 'N2O':
        return _hohm_species(wno, 5.65126, 0.17424213, 9.72095, 0.72904985)
    if species == 'NH3':
        return _hohm_species(wno, 1.28964, 0.08454599, 10.84943, 0.76338846)
    if species == 'O2':
        return _hohm_species(wno, 2.74876, 0.18095751, 4.86007, 0.58545449)
    # generic fallback (rayleigh.py:299-314)
    if species in POLARISABILITIES:
        eta = _lorentz_lorenz(np.full_like(wno, POLARISABILITIES[species]))
    else:
        eta = np.zeros_like(wno)
    F = np.full_like(wno, KING_NO_WAVE.get(species, 1.0))
    return eta, F


def compute_sigma(species, wno):
    """Rayleigh cross section, cm^2/g (rayleigh.py:84-110)."""
    wno = np.asarray(wno, dtype=np.float64)
    eta, F = _eta_F(species, wno)
    sigma = (((24.0 * np.pi ** 3 * wno ** 4) / (_N_REF ** 2))
             * (((eta ** 2 - 1.0) / (eta ** 2 + 2.0)) ** 2) * F)
    return sigma * AVOGADRO


def rayleigh_sigma_table(wno, species=None):
    """dict of species -> sigma(nu) arrays for all (or requested) species."""
    species = species if species is not None else RAYLEIGH_MOLECULES
    return {s: compute_sigma(s, wno) for s in species}
