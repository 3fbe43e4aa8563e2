"""Equilibrium chemistry: interpolation on the tabulated (T, P) grid.

Port of ``ChemGrid``, ``chem_grid_from_table`` and ``chem_interp`` of
``picaso_tpu/chemistry.py`` (reference justdoit.py:3106-3200): 4-neighbour
bilinear interpolation of log10 abundances in (1/T, log10 P) with edge
clamping and the ragged ``nc_p - 3`` pressure guard, as torch operations so
the climate loop's chemistry refresh is device work.  The table comes as a
dict of numpy columns instead of a pandas frame.

The disequilibrium half is host numpy, as in the JAX package: the Zahnle &
Marley (2014) quench levels (``quench_levels``, ``_oh_concentration``;
chemistry.py:116-192 of the JAX package) and the adjustments a profile
takes from them, as plain functions on a profile of columns (the JAX
facade's methods, justdoit.py:890-991): ``find_kzz``,
``adjust_quench_chemistry`` (with the kinetic CO2), ``volatile_rainout``
and ``cold_trap``.  The front door and the climate state share them.
``run_vulcan`` (an external kinetics package) is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import checked_device, default_dtype
from .opacities.ck import _last_true

__all__ = ['ChemGrid', 'chem_grid_from_table', 'chem_interp',
           'quench_levels', 'find_kzz', 'adjust_quench_chemistry',
           'volatile_rainout', 'cold_trap']


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


# ---------------------------------------------------------------------------
# quench chemistry (Zahnle & Marley 2014), port of deq_chem.py:5-152
# ---------------------------------------------------------------------------

def _oh_concentration(temp, press_bar, x_h2o, x_h2):
    """OH number density for PH3 quenching (deq_chem.py OH_conc)."""
    K = 10 ** (3.672 - (14791.0 / temp))
    kb = 1.3807e-16
    x_oh = K * x_h2o * (x_h2 ** -0.5) * (press_bar ** -0.5)
    n = press_bar * 1e6 / (kb * temp)
    return x_oh * n


def quench_levels(pressure_bar, temp, dtdp, kz, mmw_layer, scale_height,
                  grav_si, mh_linear=1.0, x_h2o=None, x_h2=None,
                  strict=True):
    """Quench level indices (Zahnle & Marley 2014 timescales).

    Port of deq_chem.py:5-152 ``get_quench_levels``: mixing time H^2/Kzz vs
    chemical timescales, crossing detected scanning from depth upward; the
    cold-case pressure-grid extension (deq_chem.py:47-54) included.
    Returns (dict group -> level index, t_mix array).
    """
    temp = np.array(temp, dtype=float)
    pressure = np.array(pressure_bar, dtype=float)
    mmw = np.array(mmw_layer, dtype=float)
    kz = np.atleast_1d(np.asarray(kz, dtype=float))
    nlevel = len(temp)
    if kz.size == 1:
        kz = np.full(nlevel, float(kz[0]))

    # cold-case extension down to 1e6 bar (deq_chem.py:44-54)
    if temp.min() <= 250 and pressure[-1] < 1e6:
        ext_p = np.logspace(np.log10(pressure[-1] + 100), 6, 10)
        pressure = np.append(pressure, ext_p)
        for i in range(nlevel, nlevel + 10):
            new_temp = np.exp(np.log(temp[i - 1]) - dtdp[-1]
                              * (np.log(pressure[i - 1])
                                 - np.log(pressure[i])))
            temp = np.append(temp, new_temp)
        nlevel = len(temp)
    while len(mmw) < nlevel:
        mmw = np.append(mmw, mmw[-1])
    while len(kz) < nlevel:
        kz = np.append(kz, kz[-1])

    k_b, m_p = 1.38e-23, 1.66e-27
    scale_H = (k_b / (mmw * m_p)) * temp * 1e2 / grav_si  # cm
    scale_H[:len(scale_height)] = scale_height
    t_mix = scale_H ** 2 / kz

    t_chems = {
        'CO-CH4-H2O': (1.5e-6 / pressure * mh_linear ** -0.7)
        * np.exp(42000.0 / temp),
        'CO2': (1e-10 / pressure ** 0.5) * np.exp(38000.0 / temp),
        'NH3-N2': (1e-7 / pressure) * np.exp(52000.0 / temp),
        'HCN': (1.5e-4 / (pressure * mh_linear ** 0.7))
        * np.exp(36000.0 / temp),
    }
    if x_h2o is not None and x_h2 is not None:
        xo = np.asarray(x_h2o, dtype=float)
        xh = np.asarray(x_h2, dtype=float)
        while len(xo) < nlevel:
            xo = np.append(xo, xo[-1])
            xh = np.append(xh, xh[-1])
        OH = _oh_concentration(temp, pressure, xo, xh)
        t_chems['PH3'] = 0.19047619047 * 1e13 * np.exp(6013.6 / temp) / OH

    out = {}
    for name, t_chem in t_chems.items():
        if name != 'PH3' and np.max(t_mix) < np.min(t_chem):
            if strict:
                raise ValueError(f'{name} mixing across the whole pressure '
                                 'range; start with a deeper pressure grid')
            out[name] = nlevel - 2  # quench at depth (non-strict mode)
            continue
        for j in range(nlevel - 1, 0, -1):
            if (t_mix[j - 1] <= t_chem[j - 1]) and (t_mix[j] >= t_chem[j]):
                out[name] = int(min(j, nlevel - 2))
                break
    return out, t_mix


# ---------------------------------------------------------------------------
# the quench adjustments of a profile (justdoit.py:890-991 of the JAX
# package, there methods of the facade on a pandas frame)
# ---------------------------------------------------------------------------

def find_kzz(atmosphere):
    """The active Kzz profile of ``atmosphere`` (a facade's
    ``inputs['atmosphere']``): the self-consistent, then the constant one
    of its 'kzz' store, else the profile's 'kz' column, else None
    (justdoit.py:890-902)."""
    kz_store = atmosphere.get('kzz', {})
    if isinstance(kz_store, dict):
        for key in ('sc_kzz', 'constant_kzz'):
            kz = kz_store.get(key)
            if kz is not None and not isinstance(kz, int):
                return np.asarray(kz)
    prof = atmosphere.get('profile')
    if prof is not None and 'kz' in getattr(prof, 'keys', lambda: [])():
        return np.asarray(prof['kz'])
    return None


def adjust_quench_chemistry(profile, quench_levels, kinetic_CO2=True):
    """Freeze quenched species above their quench level, conserving the
    total through H2, with the Zahnle & Marley eq. 43 kinetic CO2
    (justdoit.py:904-935).  ``profile`` maps column name to a numpy array,
    levels top first; returns a new dict.  The JAX facade's
    ``df.loc[0:qlev + 1]`` includes its end label: levels 0 to qlev + 1."""
    df = {k: np.array(v) for k, v in profile.items()}
    nlevel = len(df['pressure'])
    H2 = df['H2'].astype(float).copy()
    for iquench in ['PH3', 'CO-CH4-H2O', 'CO2', 'NH3-N2', 'HCN']:
        if iquench not in quench_levels:
            continue
        qlev = min(int(quench_levels[iquench]), nlevel - 1)
        for imol in iquench.split('-'):
            if imol not in df:
                continue
            old = df[imol]
            new = old.copy()
            new[:qlev + 2] = old[qlev]
            df[imol] = new
            H2 = H2 + (old - new)
    if kinetic_CO2 and 'CO2' in quench_levels and \
            all(m in df for m in ('CO', 'H2O', 'CO2')):
        T = df['temperature']
        K = 18.3 * np.exp(-2376 / T - (932 / T) ** 2)
        fCO2 = (df['CO'] * df['H2O']) / (K * df['H2'])
        qlev = min(int(quench_levels['CO2']), nlevel - 1)
        fCO2[:qlev] = fCO2[qlev]
        old = df['CO2']
        df['CO2'] = fCO2
        H2 = H2 + (old - fCO2)
    df['H2'] = H2
    return df


def volatile_rainout(profile, quench_levels,
                     species_to_consider=('H2O', 'CH4', 'NH3')):
    """Cap quenched volatiles at their saturation vapour pressure above the
    quench level (justdoit.py:937-967); returns a new dict."""
    from .virga import pvaps
    df = {k: np.array(v) for k, v in profile.items()}
    nlevel = len(df['pressure'])
    quench_mols = np.concatenate([k.split('-') for k in quench_levels])
    H2 = df['H2'].astype(float).copy()
    for imol in species_to_consider:
        if imol not in df or imol not in quench_mols:
            continue
        qlev = None
        for k, lev in quench_levels.items():
            if imol in k.split('-'):
                qlev = min(int(lev), nlevel - 1)
        if qlev is None:
            continue
        get_pvap = getattr(pvaps, imol, None)
        if get_pvap is None:
            continue
        quench_abund = df[imol][qlev]
        old = df[imol].copy()
        col = df[imol]
        for i in range(0, qlev + 1):
            pvap_abund = (get_pvap(df['temperature'][i])
                          / (df['pressure'][i] * 1e6))
            if pvap_abund < quench_abund:
                col[i] = pvap_abund
        H2 = H2 + (old - col)
    df['H2'] = H2
    return df


def cold_trap(profile, species_to_consider=('H2O', 'CH4', 'NH3')):
    """Make condensible abundances non-increasing upward from the highest
    level whose temperature is under the condensation curve
    (justdoit.py:969-991); returns a new dict."""
    from .virga import condensation_t
    df = {k: np.array(v) for k, v in profile.items()}
    H2 = df['H2'].astype(float).copy()
    for mol in species_to_consider:
        if mol not in df:
            continue
        _, cond_t = condensation_t(mol, 1, 2.2,
                                   pressure=np.asarray(df['pressure']))
        cross = np.where(cond_t > np.asarray(df['temperature']))[0]
        if len(cross) == 0:
            continue
        cond_layer = int(cross[-1])
        old = df[mol].copy()
        col = df[mol]
        for i in range(cond_layer - 1, 0, -1):
            if col[i] < col[i - 1]:
                col[i - 1] = col[i]
        H2 = H2 + (old - col)
    df['H2'] = H2
    return df
