"""Adiabatic gradient and specific heat lookup tables.

Port of ``picaso_tpu/climate/adiabat.py`` (reference ``did_grad_cp``,
climate.py:497-567): bilinear lookup of nabla_ad and log10 cp on the 53 x 26
(log10 T, log10 P) H/He grid of
``climate_INPUTS/specific_heat_p_adiabat_grad.json``, with the numba
original's edge clamping, as torch operations on whole level vectors.
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import torch

from .. import checked_device, default_dtype

__all__ = ['AdiabatGrid', 'load_adiabat_grid', 'did_grad_cp']

_ADIABAT_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), 'picaso_tpu', 'refdata', 'climate_INPUTS',
    'specific_heat_p_adiabat_grad.json')


class AdiabatGrid(NamedTuple):
    t_table: torch.Tensor   # [53] log10 K
    p_table: torch.Tensor   # [26] log10 bar
    grad: torch.Tensor      # [53, 26] dlnT/dlnP at constant S
    cp: torch.Tensor        # [53, 26] log10 erg/g/K


def load_adiabat_grid(device='cuda', dtype=None) -> AdiabatGrid:
    """The bundled table on ``device`` (default ``'cuda'``; raises where
    there is none) in ``dtype`` (default: float64 on the CPU, float32 on
    CUDA)."""
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    with open(_ADIABAT_JSON) as f:
        d = json.load(f)
    return AdiabatGrid(*(torch.tensor(d[k], dtype=dtype, device=device)
                         for k in ('temperature', 'pressure', 'adiabat_grad',
                                   'specific_heat')))


def _locate(table, value):
    """Bisection locate (climate.py:611-646): the last index with
    table <= value, clamped to [0, n-1]; 0 below the grid (a right-side
    search, as ``jnp.searchsorted(side='right')``)."""
    idx = torch.searchsorted(table, value.contiguous(), right=True) - 1
    return torch.clamp(idx, 0, table.shape[0] - 1)


def _cell(table, pos, value):
    """(clamped cell index, weight): weight 0 at or below the first node,
    1 at or beyond the last, linear in between (climate.py:497-567)."""
    n = table.shape[0]
    pos_c = torch.clamp(pos, 0, n - 2)
    lin = (value - table[pos_c]) / (table[pos_c + 1] - table[pos_c])
    fact = torch.where(pos == 0, 0.0, torch.where(pos == n - 1, 1.0, lin))
    return pos_c, fact


def pressure_cells(p_bar, adiabat: AdiabatGrid):
    """(cell index, weight) of pressure(s) p [bar] in the table: the
    temperature-independent half of the lookup, which the profile
    reconstruction computes once for all its levels."""
    pres_log = torch.log10(p_bar)
    return _cell(adiabat.p_table, _locate(adiabat.p_table, pres_log),
                 pres_log)


def _temperature_cells(t, adiabat: AdiabatGrid):
    temp_log = torch.log10(t)
    return _cell(adiabat.t_table, _locate(adiabat.t_table, temp_log),
                 temp_log)


def _bilinear(tab, t_cells, p_cells):
    pos_t, factkt = t_cells
    pos_p, factkp = p_cells
    g1 = tab[pos_t, pos_p]
    g2 = tab[pos_t + 1, pos_p]
    g3 = tab[pos_t + 1, pos_p + 1]
    g4 = tab[pos_t, pos_p + 1]
    return ((1 - factkt) * (1 - factkp) * g1 + factkt * (1 - factkp) * g2
            + factkt * factkp * g3 + (1 - factkt) * factkp * g4)


def did_grad(t, p_cells, adiabat: AdiabatGrid):
    """nabla_ad alone, at temperature(s) t [K] and the ``pressure_cells``
    of the pressure(s): the half of :func:`did_grad_cp` the profile
    reconstruction reads."""
    return _bilinear(adiabat.grad, _temperature_cells(t, adiabat), p_cells)


def did_grad_cp(t, p_bar, adiabat: AdiabatGrid):
    """(nabla_ad, cp) at temperature(s) t [K] and pressure(s) p [bar].

    Below-grid points take the edge value (weight 0), above-grid points
    pin to the last cell with weight 1.
    """
    t_cells = _temperature_cells(t, adiabat)
    p_cells = pressure_cells(p_bar, adiabat)
    return (_bilinear(adiabat.grad, t_cells, p_cells),
            torch.pow(10.0, _bilinear(adiabat.cp, t_cells, p_cells)))
