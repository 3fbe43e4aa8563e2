"""Raman scattering corrections to the Rayleigh single-scattering albedo.

Port of ``picaso_tpu/raman.py`` (reference picaso optics.py:435-652): the
Oklopcic+2018 H2 Raman cross sections with shifted stellar spectra (option
0), the legacy Pollack+1986 factor table (option 1), and 'none' (0.99999).
The tables are read with numpy (no pandas); the stellar binning is numpy
host code, run once per scene; :func:`raman_factor_oklopcic` is torch.

:func:`bin_star` is vectorised: the JAX package's loop scans the whole
stellar grid once per model wavenumber (minutes at nwno = 50 000 on the
5x fine grid), here one ``searchsorted`` per bin edge and one segmented
sum give the same tophat means with the same edge rule.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ['REFDATA_OPACITIES', 'load_raman_db', 'bin_star',
           'compute_stellar_shifts', 'raman_factor_oklopcic',
           'raman_factor_pollack']

REFDATA_OPACITIES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'picaso_tpu', 'refdata', 'opacities')

_NUM_J = 10  # hard-coded number of H2 rotational levels (optics.py:473)

# H2 rotational constants for the partition function (optics.py:541-545)
_KB = 1.38064852e-16
_B_ROT = 60.853
_C = 29979245800.0
_H = 6.62607004e-27


def load_raman_db(filename=None):
    """Oklopcic cross-section table (raman.txt: 16 header rows, then ji jf
    vf c deltanu) as a dict of numpy arrays.  ``c`` is normalised to a
    largest magnitude of 1, as the JAX loader does: it only enters
    scale-invariant ratios, and raw (~1e-45) it underflows float32."""
    filename = filename or os.path.join(REFDATA_OPACITIES, 'raman.txt')
    data = np.loadtxt(filename, skiprows=16, ndmin=2)
    c = data[:, 3]
    return {'ji': data[:, 0].astype(np.int64),
            'jf': data[:, 1].astype(np.int64),
            'vf': data[:, 2].astype(np.int64),
            'c': c / np.abs(c).max(),
            'deltanu': data[:, 4]}


def bin_star(wno_new, wno_old, Fp):
    """Tophat-average a hires stellar spectrum onto the model grid
    (optics.py:496-521).  Bin i > 0 holds wno_old in
    [w_i - d_{i-1}/2, w_i + d_i/2); bin 0 is open at both edges.  An empty
    bin is NaN, as the mean of nothing is in the JAX loop."""
    wno_new = np.asarray(wno_new, dtype=float)
    wno_old = np.asarray(wno_old, dtype=float)
    order = np.argsort(wno_old, kind='stable')
    x = wno_old[order]
    f = np.append(np.asarray(Fp, dtype=float)[order], 0.0)
    szmod = wno_new.shape[0]
    delta = np.zeros(szmod)
    delta[0:-1] = wno_new[1:] - wno_new[:-1]
    delta[szmod - 1] = delta[szmod - 2]
    # the loop's edge expressions, evaluated the same way
    lo = np.empty(szmod)
    hi = np.empty(szmod)
    lo[1:] = wno_new[1:] - 0.5 * delta[:-1]
    hi[1:] = wno_new[1:] + 0.5 * delta[1:]
    lo[0] = wno_new[0] - 0.5 * delta[0]
    hi[0] = wno_new[0] + 0.5 * delta[0]
    start = np.searchsorted(x, lo, side='left')
    start[0] = np.searchsorted(x, lo[0], side='right')   # strict > at bin 0
    stop = np.maximum(np.searchsorted(x, hi, side='left'), start)
    count = stop - start
    # segment sums: reduceat over interleaved (start, stop) pairs; the
    # appended zero keeps every index inside the array
    sums = np.add.reduceat(f, np.stack([start, stop], 1).reshape(-1))[::2]
    with np.errstate(invalid='ignore', divide='ignore'):
        return np.where(count > 0, sums / count, np.nan)


def compute_stellar_shifts(model_wno, raman_db, wno_star, flux_star):
    """Shifted/unshifted stellar flux ratios (optics.py:2370-2402):
    ([nwno, n_table_rows] ratios, unshifted binned spectrum [nwno])."""
    model_wno = np.asarray(model_wno, dtype=float)
    deltanu = np.asarray(raman_db['deltanu'])
    unshifted_spec = bin_star(model_wno, wno_star, flux_star)
    all_shifted = np.zeros((len(model_wno), len(deltanu)))
    unshifted = None
    for i in range(len(deltanu)):
        shifted_flux = bin_star(model_wno + deltanu[i], wno_star, flux_star)
        if i == 0:
            unshifted = shifted_flux
        with np.errstate(invalid='ignore', divide='ignore'):
            all_shifted[:, i] = shifted_flux / unshifted
    # shifted wavenumbers outside the stellar spectrum (empty bins) get the
    # neutral ratio
    all_shifted = np.where(np.isfinite(all_shifted), all_shifted, 1.0)
    return all_shifted, unshifted_spec


def _partition_function(j, T):
    b_energy = _B_ROT * _H * _C * j * (j + 1) / _KB
    g = (2.0 * j + 1.0) if j % 2 == 0 else 3.0 * (2.0 * j + 1.0)
    return g * torch.exp(-0.5 * b_energy * j * (j + 1) / T)


def _j_fraction(T):
    """[NUM_J, nlayer] Boltzmann fractions (optics.py:569-581)."""
    Z = sum(_partition_function(j, T) for j in range(20))
    return torch.stack([_partition_function(j, T) / Z for j in range(_NUM_J)])


def raman_factor_oklopcic(wno, stellar_shifts, tlayer, cross_sections,
                          j_initial, deltanu):
    """Modified Rayleigh single-scattering factor [nlayer, nwno]
    (compute_raman, optics.py:435-494): per-table-row cross sections
    Q = C / wno^3 / (wno + dnu), weighted by the layer J-level populations,
    the dnu = 0 rows counted as pure Rayleigh.  ``stellar_shifts`` is
    [nwno, nrow]."""
    j_at_temp = _j_fraction(tlayer)                          # [10, nlayer]
    shifted_wno = wno[None, :] + deltanu[:, None]            # [nrow, nwno]
    # any fixed rescale of C cancels in the ratio; max 1 keeps Q above the
    # float32 minimum normal
    cross_sections = cross_sections / torch.max(torch.abs(cross_sections))
    Q = cross_sections[:, None] / wno[None, :] ** 3.0 / shifted_wno
    is_ray = (deltanu == 0)[:, None]
    pop = j_at_temp[j_initial.long()]                        # [nrow, nlayer]
    ray = torch.einsum('rl,rw->lw', pop * is_ray, Q)
    w_shift = torch.einsum('rl,rw->lw', pop * ~is_ray, Q * stellar_shifts.T)
    wo_shift = torch.einsum('rl,rw->lw', pop * ~is_ray, Q)
    # far-IR wavenumbers below |dnu| can cancel the denominator to ~0:
    # the neutral factor there (the 0.99999 cap applies downstream)
    denom = ray + wo_shift
    ok = torch.abs(denom) > 1e-30
    return torch.where(ok, (ray + w_shift) / torch.where(ok, denom, 1.0), 1.0)


def raman_factor_pollack(nlayer, wave, refdata_dir=None):
    """Legacy Pollack factor on the wavelength grid ``wave`` (micron),
    layer-independent (optics.py:584-652): numpy [nlayer, nwave].
    ``refdata_dir`` holds ``opacities/raman_fortran.txt``."""
    path = (os.path.join(refdata_dir, 'opacities', 'raman_fortran.txt')
            if refdata_dir else os.path.join(REFDATA_OPACITIES,
                                             'raman_fortran.txt'))
    w, f = np.loadtxt(path, unpack=True)
    interp_raman = np.interp(wave, w, f)
    return np.broadcast_to(interp_raman, (nlayer, len(wave))).copy()
