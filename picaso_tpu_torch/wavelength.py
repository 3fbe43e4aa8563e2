"""Wavenumber grids of the climate and cloud inputs.

Port of ``get_cld_input_grid(grid661=True)`` of ``picaso_tpu/wavelength.py``,
read with numpy by path.  The rest of that module (the 196-point EGP cloud
grid, ``regrid``) waits for the port of the front door (ROADMAP Queue 1).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ['get_cld_input_grid']

_WVNO_661 = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'picaso_tpu', 'refdata', 'climate_INPUTS', 'wvno_661')


def get_cld_input_grid(grid661=True):
    """The 661-bin climate wavenumber grid (``climate_INPUTS/wvno_661``),
    as stored."""
    if not grid661:
        raise NotImplementedError(
            'the 196-point EGP cloud grid is not ported yet: ROADMAP Queue 1 '
            '(the front door)')
    return np.loadtxt(_WVNO_661, usecols=[0])
