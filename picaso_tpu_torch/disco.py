"""Disk geometry: Gauss-Chebyshev 'disco ball' angles and disk integration.

Port of ``picaso_tpu/disco.py``.  Angle construction (``make_geometry``,
``get_angles_1d``, ``get_angles_3d``, ``compute_disco``) stays host-side
numpy, copied from the JAX module; the disk compressions are torch
reductions over the (gauss, chebyshev) facet axes.

Semantics parity notes (reference picaso file:line):
- compute_disco          -> disco.py:8-50  (incl. the phase>pi branch)
- get_angles_1d          -> disco.py:52-89 (Abramowitz-Stegun half-sphere nodes)
- get_angles_3d          -> disco.py:92-115
- compress_disco         -> disco.py:118-149 (sym_fac=2pi when nt==1)
- compress_thermal       -> disco.py:151-181 (sym_fac=1/(2pi) when nt>1)
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    'Geometry', 'compute_disco', 'get_angles_1d', 'get_angles_3d',
    'make_geometry', 'compress_disco', 'compress_thermal',
]

# Abramowitz & Stegun Table 25.8 half-sphere Gauss nodes (disco.py:67-84)
_AS_NODES = {
    5: (np.array([0.0985350858, 0.3045357266, 0.5620251898, 0.8019865821,
                  0.9601901429]),
        np.array([0.0157479145, 0.0739088701, 0.1463869871, 0.1671746381,
                  0.0967815902])),
    6: (np.array([0.0730543287, 0.2307661380, 0.4413284812, 0.6630153097,
                  0.8519214003, 0.9706835728]),
        np.array([0.0087383018, 0.0439551656, 0.0986611509, 0.1407925538,
                  0.1355424972, 0.0723103307])),
    7: (np.array([0.0562625605, 0.1802406917, 0.3526247171, 0.5471536263,
                  0.7342101772, 0.8853209468, 0.9775206136]),
        np.array([0.0052143622, 0.0274083567, 0.0663846965, 0.1071250657,
                  0.1273908973, 0.1105092582, 0.0559673634])),
    8: (np.array([0.0446339553, 0.1443662570, 0.2868247571, 0.4548133152,
                  0.6280678354, 0.7856915206, 0.9086763921, 0.9822200849]),
        np.array([0.0032951914, 0.0178429027, 0.0454393195, 0.0791995995,
                  0.1060473594, 0.1125057995, 0.0911190236, 0.0445508044])),
}


class Geometry(NamedTuple):
    """Frozen disk-integration geometry.

    ubar0/ubar1 have shape [ng, nt]; weights are 1-D.  ``cos_theta`` is the
    cosine of the planetary phase angle and ``sym_fac_*`` the symmetry
    prefactors baked in by the reference compress routines.
    """
    ubar0: np.ndarray
    ubar1: np.ndarray
    gweight: np.ndarray
    tweight: np.ndarray
    gangle: np.ndarray
    tangle: np.ndarray
    latitude: np.ndarray
    longitude: np.ndarray
    cos_theta: float
    phase_angle: float

    @property
    def ng(self):
        return self.ubar0.shape[0]

    @property
    def nt(self):
        return self.ubar0.shape[1]


def compute_disco(ng, nt, gangle, tangle, phase_angle):
    """Incident (ubar0) and outgoing (ubar1) cosines per facet.

    Mirrors disco.py:8-50 including the sign flip for phase > pi used by
    full 0-360 reflected phase curves.
    """
    cos_theta = np.cos(phase_angle)
    # The reference writes arcsin((g - (c-1)/(c+1)) / (2/(c+1))) which
    # divides by zero at phase = pi (disco.py:36-50 upstream shares the
    # bug).  The (c+1) factors cancel algebraically:
    #   (g - (c-1)/(c+1)) / (2/(c+1)) = (g*(c+1) - (c-1)) / 2
    # identical for every c != -1 and finite at the c = -1 limit
    # (argument -> 1, longitude -> pi/2) — full-phase new-moon geometry.
    arg = np.clip((gangle * (cos_theta + 1.0) - (cos_theta - 1.0)) / 2.0,
                  -1.0, 1.0)
    if phase_angle <= np.pi:
        longitude = np.arcsin(arg)
    else:
        longitude = -np.arcsin(arg)
    colatitude = np.arccos(tangle)
    latitude = np.pi / 2 - colatitude
    f = np.sin(colatitude)
    ubar0 = np.outer(np.cos(longitude - phase_angle), f)
    ubar1 = np.outer(np.cos(longitude), f)
    return ubar0, ubar1, cos_theta, latitude, longitude


def get_angles_1d(ngauss):
    """Half-sphere Gauss nodes for the symmetric (nt=1) fast path."""
    if ngauss not in _AS_NODES:
        raise ValueError('ngauss must be 5, 6, 7 or 8 for the 1d symmetric '
                         f'integration (got {ngauss})')
    gangle, gweight = _AS_NODES[ngauss]
    return gangle, gweight, np.array([0.0]), np.array([1.0])


def get_angles_3d(num_gangle, num_tangle):
    """Gauss (longitude) x Chebyshev (latitude) nodes for the full disk."""
    i = np.linspace(1, num_tangle, num_tangle)
    tangle = np.cos(i * np.pi / (num_tangle + 1))
    tweight = np.pi / (num_tangle + 1) * np.sin(i * np.pi / (num_tangle + 1)) ** 2
    gangle, gweight = np.polynomial.legendre.leggauss(num_gangle)
    return gangle, gweight, tangle, tweight


def make_geometry(phase=0.0, num_gangle=10, num_tangle=1) -> Geometry:
    """Build a Geometry the way ``inputs.phase_angle`` does (justdoit.py:1453).

    num_tangle==1 activates the quarter-sphere symmetric path: num_gangle is
    halved and snapped to the nearest Abramowitz-Stegun node count, and
    cos_theta is forced to 1.0 (justdoit.py:1513-1532).
    """
    if num_tangle == 1:
        if phase != 0:
            raise ValueError('num_tangle=1 symmetric integration requires '
                             'phase=0; use num_tangle>1 for non-zero phase')
        half = int(num_gangle / 2)
        possible = np.array([5, 6, 7, 8])
        ng = int(possible[np.abs(possible - half).argmin()])
        gangle, gweight, tangle, tweight = get_angles_1d(ng)
        ubar0, ubar1, cos_theta, lat, lon = compute_disco(
            len(gangle), len(tangle), gangle, tangle, phase)
        cos_theta = 1.0  # justdoit.py:1532
    else:
        gangle, gweight, tangle, tweight = get_angles_3d(num_gangle, num_tangle)
        ubar0, ubar1, cos_theta, lat, lon = compute_disco(
            num_gangle, num_tangle, gangle, tangle, phase)
    return Geometry(ubar0=ubar0, ubar1=ubar1, gweight=gweight,
                    tweight=tweight, gangle=gangle, tangle=tangle,
                    latitude=lat, longitude=lon,
                    cos_theta=float(cos_theta), phase_angle=float(phase))


def compress_disco(xint_at_top, gweight, tweight, cos_theta, F0PI):
    """Reflected-light disk integration -> geometric albedo spectrum.

    xint_at_top: [ng, nt, nwno].  Mirrors disco.py:118-149: the nt==1
    symmetric case multiplies by 2*pi.
    """
    nt = xint_at_top.shape[1]
    sym_fac = 2.0 * math.pi if nt == 1 else 1.0
    w = gweight[:, None] * tweight[None, :]
    albedo = _angle_sum(xint_at_top, w)
    return sym_fac * 0.5 * albedo / F0PI * (cos_theta + 1.0)


def compress_thermal(flux_at_top, gweight, tweight):
    """Thermal disk integration (disco.py:151-181).

    flux_at_top: [ng, nt, ...]; integrates the leading two axes.
    """
    nt = flux_at_top.shape[1]
    sym_fac = 1.0 if nt == 1 else 1.0 / (2.0 * math.pi)
    w = gweight[:, None] * tweight[None, :]
    return _angle_sum(flux_at_top, w) * sym_fac


def _angle_sum(x, w):
    """sum over (g, t) of x[g, t, ...] * w[g, t]: a product and a sum over
    the two angle axes, so each element's terms add in one order whatever
    the trailing (wavenumber) width -- a wave shard's result is then
    bitwise the whole grid's (a matrix-vector product may pick another
    order for another width)."""
    w = w.reshape(w.shape + (1,) * (x.dim() - 2))
    return (x * w).sum(dim=(0, 1))
