"""Stellar-atmosphere grid spectra (PHOENIX / Castelli-Kurucz ck04).

Host (numpy) copy of ``picaso_tpu/stellar.py`` for the PyTorch port, which
must not import the JAX package.  Keep the two in step.

The reference pulls these through stsynphot's Icat interface
(justdoit.py:1756-1912); here the STScI CDBS grid trees (downloaded via
:mod:`picaso_tpu.data` to $PYSYN_CDBS) are read directly with the
bundled pure-numpy FITS parser and interpolated bilinearly in
(Teff, log g) at the nearest grid metallicity — the same file format
and lookup the stsynphot catalog performs.

Grid layout: $PYSYN_CDBS/grid/<name>/<name><m|p>MM/<prefix>_<teff>.fits,
each a BINTABLE with a WAVELENGTH column [Angstrom] and one gNN column
per log g (NN = 10*logg) holding F_lambda [erg/s/cm^2/A].
"""

from __future__ import annotations

import os
import re

import numpy as np

from .fits_lite import read_fits

__all__ = ['get_stellar_spectrum', 'list_metallicities']

_GRID_DIRS = {'phoenix': 'phoenix', 'ck04models': 'ck04models'}


def _cdbs_root(cdbs=None):
    root = cdbs or os.environ.get('PYSYN_CDBS')
    if not root or not os.path.isdir(root):
        raise FileNotFoundError(
            'stellar grids need $PYSYN_CDBS pointing at the STScI tree; '
            "download with picaso_tpu.data.get_data('stellar_grids') or use "
            "database='blackbody' / a user spectrum file")
    return root


def list_metallicities(database='phoenix', cdbs=None):
    """[(feh, subdir)] available for a grid, sorted by feh."""
    base = os.path.join(_cdbs_root(cdbs), 'grid', _GRID_DIRS[database])
    out = []
    for d in sorted(os.listdir(base)):
        m = re.search(r'([mp])(\d+)$', d)
        if m and os.path.isdir(os.path.join(base, d)):
            feh = int(m.group(2)) / 10.0 * (1 if m.group(1) == 'p' else -1)
            out.append((feh, os.path.join(base, d)))
    if not out:
        raise FileNotFoundError(f'no metallicity subdirs under {base}')
    return sorted(out)


def _teff_files(subdir):
    out = {}
    for f in os.listdir(subdir):
        m = re.search(r'_(\d+)\.fits$', f)
        if m:
            out[int(m.group(1))] = os.path.join(subdir, f)
    return dict(sorted(out.items()))


def _load_logg_columns(path):
    for hdr, data in read_fits(path):
        if isinstance(data, dict) and 'WAVELENGTH' in data:
            wave = np.asarray(data['WAVELENGTH'], float)
            cols = {int(k[1:]) / 10.0: np.asarray(v, float)
                    for k, v in data.items()
                    if re.fullmatch(r'g\d\d', k, re.IGNORECASE)}
            return wave, cols
    raise ValueError(f'{path}: no BINTABLE with WAVELENGTH column')


def _interp_logg(cols, logg):
    gs = np.array(sorted(g for g, v in cols.items() if np.any(v > 0)))
    if len(gs) == 0:
        gs = np.array(sorted(cols))
    g = float(np.clip(logg, gs[0], gs[-1]))
    hi = int(np.searchsorted(gs, g))
    if hi == 0 or gs[min(hi, len(gs) - 1)] == g:
        return cols[gs[min(hi, len(gs) - 1)]]
    lo = hi - 1
    w = (g - gs[lo]) / (gs[hi] - gs[lo])
    return (1 - w) * cols[gs[lo]] + w * cols[gs[hi]]


def _spectrum_at_metallicity(subdir, teff, logg):
    """(wave [A], F_lambda) bilinear in (Teff, log g) on ONE [Fe/H] subgrid."""
    files = _teff_files(subdir)
    teffs = np.array(list(files))
    t = float(np.clip(teff, teffs[0], teffs[-1]))
    hi = int(np.searchsorted(teffs, t))
    if hi == 0 or teffs[min(hi, len(teffs) - 1)] == t:
        wave_a, cols = _load_logg_columns(files[int(teffs[min(
            hi, len(teffs) - 1)])])
        flux_a = _interp_logg(cols, logg)
    else:
        w1, c1 = _load_logg_columns(files[int(teffs[hi - 1])])
        w2, c2 = _load_logg_columns(files[int(teffs[hi])])
        f1 = _interp_logg(c1, logg)
        f2 = np.interp(w1, w2, _interp_logg(c2, logg))
        w = (t - teffs[hi - 1]) / (teffs[hi] - teffs[hi - 1])
        wave_a, flux_a = w1, (1 - w) * f1 + w * f2
    return wave_a, flux_a


def get_stellar_spectrum(database, teff, metallicity, logg, cdbs=None):
    """(wno [cm^-1], flux [erg/cm^2/s/cm]) from a CDBS grid.

    Trilinear in (Teff, log g, [Fe/H]) — the stsynphot Icat lookup
    (justdoit.py:1756-1912 of the reference) re-done without astropy:
    bilinear (Teff, log g) on each of the two bracketing metallicity
    subgrids, then linear in [Fe/H] (already a log quantity) between
    them; off-grid metallicities clip to the nearest edge.  Output is
    wavenumber-ordered PER-WAVELENGTH flux — the convention every
    stellar consumer shares with the reference (its synphot spectra
    arrive as erg*cm^-3*s^-1, justdoit.py:1790): the fpfs ratio divides
    the per-wavelength thermal flux, and the climate path integrates
    over dlambda per bin.
    """
    mets = list_metallicities(database, cdbs)
    fehs = np.array([m[0] for m in mets])
    z = float(np.clip(metallicity, fehs[0], fehs[-1]))
    hi = int(np.searchsorted(fehs, z))
    if hi == 0 or fehs[min(hi, len(fehs) - 1)] == z:
        wave_a, flux_a = _spectrum_at_metallicity(
            mets[min(hi, len(fehs) - 1)][1], teff, logg)
    else:
        w1, f1 = _spectrum_at_metallicity(mets[hi - 1][1], teff, logg)
        w2, f2 = _spectrum_at_metallicity(mets[hi][1], teff, logg)
        f2 = np.interp(w1, w2, f2)
        w = (z - fehs[hi - 1]) / (fehs[hi] - fehs[hi - 1])
        wave_a, flux_a = w1, (1 - w) * f1 + w * f2

    keep = (wave_a > 0) & np.isfinite(flux_a)
    wave_cm = wave_a[keep] * 1e-8
    flam_per_cm = flux_a[keep] * 1e8          # erg/cm^2/s/A -> per cm
    wno = 1.0 / wave_cm
    order = np.argsort(wno)
    return wno[order], flam_per_cm[order]
