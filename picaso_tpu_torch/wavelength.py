"""Wavelength-grid utilities: the cloud and climate input grids, row
regridding and spectral binning.

Host (numpy) copy of ``get_cld_input_grid``, ``regrid``, ``create_grid`` and
``mean_regrid`` of ``picaso_tpu/wavelength.py``, which must not be imported
here.  The files are read by path with numpy (the JAX module reads the EGP
grid with pandas); ``mean_regrid``'s bin means repeat
``scipy.stats.binned_statistic``'s arithmetic in numpy.
"""

from __future__ import annotations

import numpy as np

from .refdata import refdata_path

__all__ = ['get_cld_input_grid', 'regrid', 'create_grid', 'mean_regrid']


def get_cld_input_grid(filename_or_grid='wave_EGP.dat', grid661=False):
    """196-point EGP cloud wavenumber grid (or 661 climate grid), ascending."""
    if grid661:
        return np.loadtxt(refdata_path('climate_INPUTS', 'wvno_661'),
                          usecols=[0])
    if isinstance(filename_or_grid, np.ndarray):
        return np.sort(filename_or_grid)
    path = (refdata_path('opacities', 'wave_EGP.dat')
            if filename_or_grid == 'wave_EGP.dat' else filename_or_grid)
    with open(path) as f:
        column = f.readline().split().index('wavenumber')
    return np.sort(np.loadtxt(path, skiprows=1, usecols=[column]))


def regrid(matrix, old_wno, new_wno):
    """Row-wise linear re-interpolation onto a new wavenumber grid."""
    matrix = np.asarray(matrix, dtype=np.float64)
    new = np.zeros((matrix.shape[0], len(new_wno)))
    for i in range(matrix.shape[0]):
        new[i, :] = np.interp(np.asarray(new_wno, dtype=np.float64),
                              np.asarray(old_wno, dtype=np.float64),
                              matrix[i, :])
    return new


def create_grid(min_wavelength, max_wavelength, constant_R):
    """Constant-R wavenumber grid (opacity_factory.py:712-739): geometric
    wavelength spacing (2R+1)/(2R-1) from min_wavelength, returned as
    ascending wavenumbers."""
    spacing = (2.0 * constant_R + 1.0) / (2.0 * constant_R - 1.0)
    npts = np.log(max_wavelength / min_wavelength) / np.log(spacing)
    wsize = int(np.ceil(npts)) + 1
    newwl = np.concatenate(
        [[min_wavelength],
         min_wavelength * np.cumprod(np.full(wsize - 1, spacing))])
    return 1e4 / newwl[::-1]


def _binned_mean(x, y, edges):
    """Per-bin means of y over x (NaN for empty bins): the arithmetic of
    ``scipy.stats.binned_statistic(x, y, bins=edges)`` -- digitize, the
    rightmost edge counted in the last bin, bincount sums over counts."""
    nbin = len(edges) + 1
    bins = np.digitize(x, edges)
    decimal = int(-np.log10(np.diff(edges).min())) + 6
    on_edge = np.where((x >= edges[-1]) & (np.around(x, decimal)
                                           == np.around(edges[-1], decimal)))
    bins[on_edge] -= 1
    count = np.bincount(bins, None, minlength=nbin)
    total = np.bincount(bins, y, minlength=nbin)
    out = np.full(nbin, np.nan)
    full = count.nonzero()
    out[full] = total[full] / count[full]
    return out[1:-1]


def mean_regrid(x, y, newx=None, R=None):
    """Bin a spectrum to a new grid (justplotit.py:31-63).

    Either supply target centers ``newx`` (bin edges are midpoints between
    centers, extended by half a step at both ends) or a resolving power
    ``R`` (the constant-R grid is used directly as the bin edges).  Returns
    the arithmetic bin centers and per-bin means (NaN for empty bins).
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if newx is None and R is not None:
        edges = create_grid(1e4 / np.max(x), 1e4 / np.min(x), R)
    elif newx is not None and R is None:
        newx = np.asarray(newx, dtype=np.float64)
        d = np.diff(newx)
        edges = np.concatenate([[newx[0] - d[0] / 2.0],
                                newx[:-1] + d / 2.0,
                                [newx[-1] + d[-1] / 2.0]])
    else:
        raise ValueError('Please either enter a newx or a R')
    edges = np.asarray(edges, dtype=np.float64)
    return (edges[:-1] + edges[1:]) / 2.0, _binned_mean(x, y, edges)
