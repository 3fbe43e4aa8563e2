"""Carry the JAX package's grids, scenes and climate tables across to the
port.

The inputs are plain numpy arrays (for example
``{k: np.asarray(v) for k, v in scene._asdict().items()}`` of a
``picaso_tpu`` SceneTensors, or of its CK table's ``CKArrays``) plus the
static tuples, so nothing here imports jax.  The outputs are the port's objects on ``device`` (default
``'cuda'``; raises where there is no card) in ``dtype`` (default: float64
on the CPU, float32 on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from . import checked_device, default_dtype
from .chemistry import ChemGrid
from .climate.adiabat import AdiabatGrid
from .opacities.ck import CKArrays, CKTable
from .opacities.db import OpacityGrid, PTGrid
from .pipeline import SceneTensors

__all__ = ['grid_from_numpy', 'scene_from_numpy', 'ck_table_from_numpy',
           'chem_grid_from_numpy', 'adiabat_from_numpy']

_INT_FIELDS = {'nc_p', 't_offset', 'raman_ji'}


def _tensor(name, value, device, dtype):
    dt = torch.int32 if name in _INT_FIELDS else dtype
    return torch.tensor(np.asarray(value), dtype=dt, device=device)


def grid_from_numpy(arrays, molecules, continuum_molecules, device='cuda',
                    dtype=None) -> OpacityGrid:
    """OpacityGrid from numpy arrays.

    ``arrays`` holds wno, log_kappa [nmol, npt, nwno], cont_opa, cia_temps
    and the PTGrid fields t_inv_grid, p_log_grid, nc_p, t_offset.
    """
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype

    def t(name):
        return _tensor(name, arrays[name], device, dtype)

    pt = PTGrid(*(t(name) for name in PTGrid._fields))
    return OpacityGrid(wno=t('wno'), log_kappa=t('log_kappa'), pt=pt,
                       cont_opa=t('cont_opa'), cia_temps=t('cia_temps'),
                       molecules=tuple(molecules),
                       continuum_molecules=tuple(continuum_molecules))


def scene_from_numpy(arrays, device='cuda', dtype=None) -> SceneTensors:
    """SceneTensors from a dict with one numpy array per field."""
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    return SceneTensors(**{name: _tensor(name, arrays[name], device, dtype)
                           for name in SceneTensors._fields})


def ck_table_from_numpy(arrays, molecules, full_abunds, gauss_pts, temps,
                        pressures, device='cuda', dtype=None, per_gas=None,
                        per_gas_molecules=None) -> CKTable:
    """CKTable from numpy arrays.

    ``arrays`` holds the CKArrays fields (wno, delta_wno, gauss_wts,
    ln_kappa, p_log_grid, t_inv_grid, nc_p, cont_opa, cia_temps) and
    continuum_molecules; ``full_abunds`` maps column name -> numpy array
    (a pandas frame's columns, in order); ``per_gas`` [ngas, npress,
    ntemp, nwno, ngauss], optional, the per-gas tables of
    ``per_gas_molecules``.
    """
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    ck = CKArrays(*(_tensor(name, arrays[name], device, dtype)
                    for name in CKArrays._fields[:-1]),
                  tuple(arrays['continuum_molecules']))
    return CKTable(ck, molecules, full_abunds, gauss_pts, temps, pressures,
                   wno=arrays['wno'], delta_wno=arrays['delta_wno'],
                   gauss_wts=arrays['gauss_wts'],
                   per_gas=(None if per_gas is None else _tensor(
                       'per_gas', per_gas, device, dtype)),
                   per_gas_molecules=per_gas_molecules)


def chem_grid_from_numpy(arrays, species, device='cuda',
                         dtype=None) -> ChemGrid:
    """ChemGrid from numpy arrays (log_abunds, t_inv_grid, p_log_grid,
    nc_p, t_offset) and the species tuple."""
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    return ChemGrid(*(_tensor(name, arrays[name], device, dtype)
                      for name in ChemGrid._fields[:-1]), tuple(species))


def adiabat_from_numpy(arrays, device='cuda', dtype=None) -> AdiabatGrid:
    """AdiabatGrid from numpy arrays (t_table, p_table, grad, cp)."""
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    return AdiabatGrid(*(_tensor(name, arrays[name], device, dtype)
                         for name in AdiabatGrid._fields))
