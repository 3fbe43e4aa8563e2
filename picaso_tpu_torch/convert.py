"""Carry the JAX package's grids and scenes across to the port.

The inputs are plain numpy arrays (for example
``{k: np.asarray(v) for k, v in scene._asdict().items()}`` of a
``picaso_tpu`` SceneTensors) plus the static tuples, so nothing here
imports jax.  The outputs are the port's objects on ``device`` in
``dtype`` (default: float64 on the CPU, float32 on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch

from . import default_dtype
from .opacities.db import OpacityGrid, PTGrid
from .pipeline import SceneTensors

__all__ = ['grid_from_numpy', 'scene_from_numpy']

_INT_FIELDS = {'nc_p', 't_offset', 'raman_ji'}


def _tensor(name, value, device, dtype):
    dt = torch.int32 if name in _INT_FIELDS else dtype
    return torch.tensor(np.asarray(value), dtype=dt, device=device)


def grid_from_numpy(arrays, molecules, continuum_molecules, device='cpu',
                    dtype=None) -> OpacityGrid:
    """OpacityGrid from numpy arrays.

    ``arrays`` holds wno, log_kappa [nmol, npt, nwno], cont_opa, cia_temps
    and the PTGrid fields t_inv_grid, p_log_grid, nc_p, t_offset.
    """
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else dtype

    def t(name):
        return _tensor(name, arrays[name], device, dtype)

    pt = PTGrid(*(t(name) for name in PTGrid._fields))
    return OpacityGrid(wno=t('wno'), log_kappa=t('log_kappa'), pt=pt,
                       cont_opa=t('cont_opa'), cia_temps=t('cia_temps'),
                       molecules=tuple(molecules),
                       continuum_molecules=tuple(continuum_molecules))


def scene_from_numpy(arrays, device='cpu', dtype=None) -> SceneTensors:
    """SceneTensors from a dict with one numpy array per field."""
    device = torch.device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    return SceneTensors(**{name: _tensor(name, arrays[name], device, dtype)
                           for name in SceneTensors._fields})

