"""Equilibrium chemistry: interpolation on the tabulated (T, P) grid.

Port of ``ChemGrid``, ``chem_grid_from_table`` and ``chem_interp`` of
``picaso_tpu/chemistry.py`` (reference justdoit.py:3106-3200): 4-neighbour
bilinear interpolation of log10 abundances in (1/T, log10 P) with edge
clamping and the ragged ``nc_p - 3`` pressure guard, as torch operations so
the climate loop's chemistry refresh is device work.  The table comes as a
dict of numpy columns instead of a pandas frame.  ``quench_levels`` and
``run_vulcan`` wait for the disequilibrium port (ROADMAP Queue 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import checked_device, default_dtype
from .opacities.ck import _last_true

__all__ = ['ChemGrid', 'chem_grid_from_table', 'chem_interp']


class ChemGrid(NamedTuple):
    """Equilibrium chemistry table on a ragged (T, P) grid."""
    log_abunds: torch.Tensor    # [npt, nspecies] log10 mixing ratios
    t_inv_grid: torch.Tensor    # [ntemp]
    p_log_grid: torch.Tensor    # [npress]
    nc_p: torch.Tensor          # [ntemp] int32
    t_offset: torch.Tensor      # [ntemp] int32
    species: tuple


def chem_grid_from_table(columns, device='cuda', dtype=None) -> ChemGrid:
    """ChemGrid from a table of columns (name -> numpy array) with
    'pressure' and 'temperature' among them, rows temperature-major (all
    pressures of T1, then T2, ...) as in the reference grids; the other
    columns are the species, in the table's order.  On ``device`` (default
    ``'cuda'``; raises where there is none) in ``dtype`` (default: float64
    on the CPU, float32 on CUDA)."""
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    species = tuple(c for c in columns if c not in ('pressure',
                                                     'temperature'))
    temps_all = np.asarray(columns['temperature'])
    pressures_all = np.asarray(columns['pressure'])
    _, t_first = np.unique(temps_all, return_index=True)
    temps = temps_all[np.sort(t_first)]
    _, p_first = np.unique(pressures_all, return_index=True)
    pressures = pressures_all[np.sort(p_first)]
    pressures = pressures[pressures > 0]
    nc_p = np.array([(temps_all == t).sum() for t in temps])
    t_offset = np.concatenate([[0], np.cumsum(nc_p)[:-1]])
    vals = np.stack([np.asarray(columns[s], np.float64) for s in species],
                    axis=1)
    log_abunds = np.log10(np.where(vals > 0, vals, 1e-50))

    def dev(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return ChemGrid(log_abunds=dev(log_abunds), t_inv_grid=dev(1.0 / temps),
                    p_log_grid=dev(np.log10(pressures)),
                    nc_p=dev(nc_p, torch.int32),
                    t_offset=dev(t_offset, torch.int32), species=species)


def chem_interp(grid: ChemGrid, tlevel, plevel_bar):
    """Abundances at (T, P) points: [nlevel, nspecies] (chemistry.py:72-109
    of the JAX package, which ports justdoit.py:3106-3200)."""
    t_inv = 1.0 / tlevel
    p_log = torch.log10(plevel_bar)
    tg, pg = grid.t_inv_grid, grid.p_log_grid
    ntemp = tg.shape[0]

    t_low = torch.clamp(_last_true(tg[None, :] > t_inv[:, None]),
                        max=ntemp - 2)
    t_hi = t_low + 1
    p_low = _last_true(pg[None, :] <= p_log[:, None])
    p_low = torch.clamp(torch.minimum(p_low, grid.nc_p[t_hi].long() - 3),
                        min=0)
    p_hi = p_low + 1

    t_w = ((t_inv - tg[t_low]) / (tg[t_hi] - tg[t_low]))[:, None]
    p_w = ((p_log - pg[p_low]) / (pg[p_hi] - pg[p_low]))[:, None]

    la = grid.log_abunds
    off = grid.t_offset.long()
    i_ll = off[t_low] + p_low
    i_hl = off[t_hi] + p_low
    i_hh = off[t_hi] + p_hi
    i_lh = off[t_low] + p_hi
    out = ((1 - t_w) * (1 - p_w) * la[i_ll]
           + t_w * (1 - p_w) * la[i_hl]
           + t_w * p_w * la[i_hh]
           + (1 - t_w) * p_w * la[i_lh])
    return torch.pow(10.0, out)
