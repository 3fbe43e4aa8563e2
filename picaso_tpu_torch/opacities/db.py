"""Monochromatic opacity grids on the device: neighbour search and
bilinear log-interpolation.

Port of ``picaso_tpu/opacities/db.py`` (the device half).  The opacity cube
``log_kappa [nmol, npt, nwno]`` is log10 cross section (cm^2/molecule) on
the ragged (T, P) grid of the reference monochromatic databases; every
per-call step (neighbour search, blend, Avogadro scaling) runs on the
tensor's device.  The sqlite loader is not ported yet (ROADMAP).

Grid semantics preserved exactly (reference picaso optics.py:2048-2123):
* bilinear in (1/T, log10 P) on log10(opacity);
* temperatures clamp to the grid edges; the pressure low index respects the
  ragged pressures-per-temperature count via ``min(ilo, nc_p[t_hi] - 3)``;
* continuum (CIA) takes the nearest temperature, no interpolation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import AVOGADRO

__all__ = ['PTGrid', 'OpacityGrid', 'interp_molecular', 'nearest_continuum',
           'LOG_AVO']

LOG_AVO = float(np.log10(AVOGADRO))


class PTGrid(NamedTuple):
    """The ragged (T, P) grid of the molecular table (1060/1460 layout)."""
    t_inv_grid: torch.Tensor   # [ntemp] 1/T, descending (T ascending)
    p_log_grid: torch.Tensor   # [npress] log10 P(bar)
    nc_p: torch.Tensor         # [ntemp] int32 pressures per temperature
    t_offset: torch.Tensor     # [ntemp] int32 start of each T in the flat grid


class OpacityGrid(NamedTuple):
    """Device-resident opacity data for one monochromatic database."""
    wno: torch.Tensor          # [nwno]
    log_kappa: torch.Tensor    # [nmol, npt, nwno] log10 cm^2/molecule
    pt: PTGrid
    cont_opa: torch.Tensor     # [ncont, ntcia, nwno]
    cia_temps: torch.Tensor    # [ntcia]
    molecules: tuple
    continuum_molecules: tuple


def _last_true(mask):
    """Index of the last True per row (0 where none): the JAX module's
    ``n - 1 - argmax(mask[:, ::-1])``, relying on argmax returning the
    FIRST maximal index, as jnp.argmax does."""
    n = mask.shape[1]
    last = n - 1 - torch.argmax(torch.flip(mask, [1]).to(torch.int32), dim=1)
    return torch.where(mask.any(dim=1), last, torch.zeros_like(last))


def _find_indices(pt: PTGrid, tlayer, player_bar):
    """Neighbour indices + weights (reference optics.py:2048-2123).

    Returns (t_w [nlayer], p_w [nlayer], idx [4, nlayer] int64) where the
    idx rows are the flat-grid rows of the corners (t_low,p_low),
    (t_hi,p_low), (t_hi,p_hi), (t_low,p_hi) -- the reference's weight
    pairing, which the gather kernel's weights follow.
    """
    t_inv = 1.0 / tlayer
    p_log = torch.log10(player_bar)
    tg = pt.t_inv_grid
    pg = pt.p_log_grid
    ntemp = tg.shape[0]

    # last grid index with 1/T_grid > 1/T (t_inv_grid is descending),
    # clamped to [0, ntemp-2]
    t_low = torch.clamp(_last_true(tg[None, :] > t_inv[:, None]),
                        max=ntemp - 2)
    t_hi = t_low + 1

    last_le = _last_true(pg[None, :] <= p_log[:, None])
    # ragged-pressure guard: min(ilo, nc_p[t_hi] - 3)  (optics.py:2094-2099)
    p_low = torch.minimum(last_le, pt.nc_p.long()[t_hi] - 3)
    p_low = torch.clamp(p_low, min=0)
    p_hi = p_low + 1

    t_w = (t_inv - tg[t_low]) / (tg[t_hi] - tg[t_low])
    p_w = (p_log - pg[p_low]) / (pg[p_hi] - pg[p_low])

    off = pt.t_offset.long()
    idx = torch.stack([off[t_low] + p_low, off[t_hi] + p_low,
                       off[t_hi] + p_hi, off[t_low] + p_hi], dim=0)
    return t_w, p_w, idx


def corner_weights(t_w, p_w):
    """[4, nlayer] bilinear weights in the corner order of _find_indices."""
    return torch.stack([(1 - t_w) * (1 - p_w), t_w * (1 - p_w),
                        t_w * p_w, (1 - t_w) * p_w], dim=0)


def interp_molecular(opa: OpacityGrid, tlayer, player_bar):
    """All molecules' cross sections at every layer: [nmol, nlayer, nwno].

    Bilinear interpolation in (1/T, log10 P) on log10 opacity, then 10**x
    times Avogadro (optics.py:2290-2294).  The Avogadro term is folded
    into the exponent: 10**-50 underflows f32, 10**(-50 + 23.78) does not.
    """
    t_w, p_w, idx = _find_indices(opa.pt, tlayer, player_bar)
    k = opa.log_kappa[:, idx, :]                       # [nmol, 4, nlayer, nwno]
    w = corner_weights(t_w, p_w).to(k.dtype)           # [4, nlayer]
    logk = torch.einsum('mqlw,ql->mlw', k, w)
    return 10.0 ** (logk + LOG_AVO)


def nearest_continuum(opa: OpacityGrid, tlayer):
    """Continuum opacity at the nearest CIA temperature [ncont, nlayer, nwno]
    (optics.py:2296-2306; argmin takes the first of tied temperatures)."""
    it = torch.argmin(torch.abs(opa.cia_temps[None, :] - tlayer[:, None]),
                      dim=1)
    return opa.cont_opa[:, it, :]
