"""Wavelength-grid utilities: the cloud and climate input grids, row
regridding and spectral binning.

Host (numpy) copy of ``get_cld_input_grid``, ``regrid``, ``create_grid``,
``create_grid_minR``, ``conv_non_uniform_R`` and ``mean_regrid`` of
``picaso_tpu/wavelength.py``, which must not be imported here.  The files are read by path with numpy (the JAX module reads the EGP
grid with pandas); ``mean_regrid``'s bin means repeat
``scipy.stats.binned_statistic``'s arithmetic in numpy.
``conv_non_uniform_R`` takes numpy arrays or torch tensors (then it runs on
their device).
"""

from __future__ import annotations

import numpy as np
import torch

from .refdata import refdata_path

__all__ = ['get_cld_input_grid', 'regrid', 'create_grid', 'create_grid_minR',
           'conv_non_uniform_R', 'mean_regrid']


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


def create_grid_minR(min_wavelength, max_wavelength, minimum_R):
    """Uniform-dwno wavenumber grid with the step set by ``minimum_R`` at
    ``min_wavelength`` (opacity_factory.py:692-710).  As in the reference,
    the resolving power wno/dwno equals ``minimum_R`` at the short end and
    falls toward longer wavelengths.  Returns (wavenumber grid ascending,
    dwno)."""
    dwno = 1e4 / (min_wavelength ** 2) * (min_wavelength / minimum_R)
    grid = np.arange(1e4 / max_wavelength, 1e4 / min_wavelength, dwno)
    return grid, dwno


def conv_non_uniform_R(model_flux, model_wl, R, obs_wl):
    """Convolve a model spectrum with a wavelength-dependent resolving
    power onto an observed wavelength grid (driver.py:338-381): one
    [nobs, nmodel] Gaussian kernel matrix, each row normalised, applied as
    a matrix-vector product.  numpy in, numpy out; a torch tensor
    ``model_flux`` keeps the product on its device and dtype.

    model_flux/model_wl [nmodel]; R [nobs] resolving power at each observed
    wavelength; obs_wl [nobs].  Returns [nobs].
    """
    if isinstance(model_flux, torch.Tensor):
        def xp(x):
            return torch.as_tensor(np.asarray(x, np.float64),
                                   dtype=model_flux.dtype,
                                   device=model_flux.device)
        exp, total, flux = torch.exp, torch.sum, model_flux
    else:
        xp, exp, total = np.asarray, np.exp, np.sum
        flux = np.asarray(model_flux)
    model_wl, obs_wl, R = xp(model_wl), xp(obs_wl), xp(R)
    sigma = (obs_wl / R) / 2.355                       # FWHM -> sigma
    arg = ((model_wl[None, :] - obs_wl[:, None])
           / sigma[:, None]) ** 2
    kern = exp(-0.5 * arg)
    kern = kern / total(kern, axis=1, keepdims=True)
    return kern @ flux


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
