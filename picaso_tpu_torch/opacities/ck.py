"""Correlated-k opacity tables (premixed and per-gas), on the device.

Port of ``picaso_tpu/opacities/ck.py`` (reference
picaso ``RetrieveCKs``, optics.py:654-1875): the premixed ln-kappa cube
[npress, ntemp, nwno, ngauss] sits on the device, and the bilinear
(1/T, log10 P) interpolation (``get_pre_mix_ck``, optics.py:1081-1161) and
the CIA log-interpolation in inverse temperature (``get_continuum``,
optics.py:1398-1498) are torch operations on it, so a climate iteration's
opacity update is device work.

The chemistry table (``full_abunds``) rides along with the table as in the
reference; here it is a dict of numpy columns in table order (the JAX
package keeps a pandas frame, which the port does not import).

A table may carry per-gas ln-k tables [ngas, npress, ntemp, nwno, ngauss]
(``per_gas``, for ``per_gas_molecules``), mixed on the fly by resort-rebin
(``opacities/resortrebin.py``) for disequilibrium chemistry.
``ck_taugas`` gives the spectrum path's molecular and continuum optical
depths: from the per-gas tables mixed at the atmosphere's own abundances
where the table has them, else from the premixed table.

:func:`load_ck_db` reads a table from files (ck.py:128-265 of the JAX
package): a premixed hdf5 (the reference ``get_ck_tables`` layout), a
legacy 1460-grid ASCII directory (``opacities/legacy.py``, numpy alone), or
a directory of per-gas ``<mol>_1460.hdf5`` tables for resort-rebin.  The
hdf5 formats import h5py where they are read.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .. import checked_device
from .db import connect
from .factory import synthetic_cross_sections

__all__ = ['CKArrays', 'CKTable', 'load_ck_db', 'synthetic_ck_table',
           'interp_premix', 'ck_continuum', 'ck_taugas',
           'double_gauss_points']

AVOGADRO = 6.02214086e+23

REFDATA_OPACITIES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), 'picaso_tpu', 'refdata', 'opacities')
CONTINUUM_DB = os.path.join(REFDATA_OPACITIES, 'ck_cx_cont_opacities.db')


class CKArrays(NamedTuple):
    """Device-resident CK data."""
    wno: torch.Tensor            # [nwno]
    delta_wno: torch.Tensor      # [nwno]
    gauss_wts: torch.Tensor      # [ngauss]
    ln_kappa: torch.Tensor       # [npress, ntemp, nwno, ngauss] (premixed)
    p_log_grid: torch.Tensor     # [npress] log10 bar
    t_inv_grid: torch.Tensor     # [ntemp] 1/K
    nc_p: torch.Tensor           # [ntemp] int32
    cont_opa: torch.Tensor       # [ncont, ntcia, nwno]
    cia_temps: torch.Tensor      # [ntcia] sorted
    continuum_molecules: tuple

    def to(self, device, dtype):
        """The arrays on ``device``, the float ones in ``dtype``."""
        return CKArrays(*(x.to(device, dtype) if x.is_floating_point()
                          else x.to(device) for x in self[:-1]),
                        self.continuum_molecules)


class CKTable:
    """A CK table: the device arrays, host copies of the grids, and the
    chemistry table (``full_abunds``: column name -> numpy array, rows
    temperature-major as in the reference grids)."""

    def __init__(self, arrays: CKArrays, molecules, full_abunds, gauss_pts,
                 temps, pressures, wno, delta_wno, gauss_wts, per_gas=None,
                 per_gas_molecules=None):
        # optional per-gas ln-k tables [ngas, npress, ntemp, nwno, ngauss]
        # on the arrays' device, for resort-rebin mixing
        self.per_gas = per_gas
        self.per_gas_molecules = (tuple(per_gas_molecules)
                                  if per_gas_molecules else ())
        self.arrays = arrays
        self.molecules = tuple(molecules)
        self.full_abunds = dict(full_abunds)
        self.gauss_pts = np.asarray(gauss_pts)
        self.temps = np.asarray(temps)
        self.pressures = np.asarray(pressures)
        self.wno = np.asarray(wno)
        self.delta_wno = np.asarray(delta_wno)
        self.gauss_wts = np.asarray(gauss_wts)
        self.nwno = len(self.wno)
        self.ngauss = len(self.gauss_wts)
        self.continuum_molecules = arrays.continuum_molecules

    def to(self, device, dtype):
        """The same table with its arrays (the per-gas tables too) on
        ``device`` in ``dtype``."""
        return CKTable(self.arrays.to(device, dtype), self.molecules,
                       self.full_abunds, self.gauss_pts, self.temps,
                       self.pressures, self.wno, self.delta_wno,
                       self.gauss_wts,
                       per_gas=(None if self.per_gas is None
                                else self.per_gas.to(device, dtype)),
                       per_gas_molecules=self.per_gas_molecules)

    def take_bins(self, sl):
        """The same table on the wavenumber bins ``sl`` (a slice): the
        premixed and per-gas tables, the continuum and the grids."""
        a = self.arrays
        arrays = a._replace(wno=a.wno[sl], delta_wno=a.delta_wno[sl],
                            ln_kappa=a.ln_kappa[:, :, sl],
                            cont_opa=a.cont_opa[:, :, sl])
        return CKTable(arrays, self.molecules, self.full_abunds,
                       self.gauss_pts, self.temps, self.pressures,
                       self.wno[sl], self.delta_wno[sl], self.gauss_wts,
                       per_gas=(None if self.per_gas is None
                                else self.per_gas[:, :, :, sl]),
                       per_gas_molecules=self.per_gas_molecules)


def double_gauss_points(order=4, gfrac=0.95):
    """8-point double-Gauss quadrature used by the CK tables: two
    Gauss-Legendre sets over [0, gfrac] and [gfrac, 1]
    (opacity_factory.py:1474 g_w_2gauss semantics)."""
    x, w = np.polynomial.legendre.leggauss(order)
    pts1 = gfrac * 0.5 * (x + 1.0)
    wts1 = gfrac * 0.5 * w
    pts2 = gfrac + (1 - gfrac) * 0.5 * (x + 1.0)
    wts2 = (1 - gfrac) * 0.5 * w
    return np.concatenate([pts1, pts2]), np.concatenate([wts1, wts2])


def _db_wno(continuum_db):
    cur, conn = connect(continuum_db)
    try:
        cur.execute('SELECT wavenumber_grid FROM header')
        return cur.fetchone()[0]
    finally:
        conn.close()


def _load_continuum(continuum_db, wno, dtype=np.float32):
    """Continuum table [ncont, ntemp, nwno] from the CK continuum sqlite
    (ck.py:102-125 of the JAX package): (table, temperatures, molecules)."""
    cur, conn = connect(continuum_db)
    try:
        cur.execute('SELECT wavenumber_grid FROM header')
        db_wno = cur.fetchone()[0]
        if not (len(db_wno) == len(wno) and np.allclose(db_wno, wno)):
            raise ValueError('continuum DB wavenumber grid does not match '
                             f'the CK table grid ({len(db_wno)} vs '
                             f'{len(wno)} pts)')
        cur.execute('SELECT molecule FROM continuum')
        mols = sorted(set(x[0] for x in cur.fetchall()))
        cur.execute('SELECT temperature FROM continuum')
        temps = np.unique([x[0] for x in cur.fetchall()])
        # floored at the DB's own 1e-33: exact zeros would give log(0) in
        # the 1/T log-interpolation (see the JAX module)
        cont = np.zeros((len(mols), len(temps), len(wno)), dtype)
        for im, mol in enumerate(mols):
            cur.execute('SELECT temperature, opacity FROM continuum '
                        'WHERE molecule = ?', (mol,))
            for t, op in cur.fetchall():
                cont[im, int(np.searchsorted(temps, t))] = op
    finally:
        conn.close()
    return np.maximum(cont, np.asarray(1e-33, dtype)), temps, tuple(mols)


def _torch_dtype(dtype):
    """A torch float dtype from a torch, numpy or string one ('float64'
    as a TOML file gives it)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float64): torch.float64,
            np.dtype(np.float32): torch.float32}[np.dtype(dtype)]


def _ck_arrays(wno, delta_wno, gauss_wts, ln_kappa, pressures, temps, nc_p,
               continuum_db, dtype, device):
    """CKArrays on ``device`` in ``dtype`` from host arrays, with the
    continuum of ``continuum_db`` (default the bundled CK continuum
    database, whose grid the table's must be)."""
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    cont, cia_temps, cont_mols = _load_continuum(
        continuum_db or CONTINUUM_DB, wno, np_dtype)

    def dev(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return CKArrays(
        wno=dev(wno), delta_wno=dev(delta_wno), gauss_wts=dev(gauss_wts),
        ln_kappa=dev(ln_kappa),
        p_log_grid=dev(np.log10(pressures[pressures > 0])),
        t_inv_grid=dev(1.0 / temps), nc_p=dev(nc_p, torch.int32),
        cont_opa=dev(cont), cia_temps=dev(cia_temps),
        continuum_molecules=cont_mols)


def load_ck_db(ck_db, method='preweighted', continuum_db=None,
               dtype=torch.float64, device='cuda', **kwargs) -> CKTable:
    """Load a CK table from files (ck.py:128-193 of the JAX package) onto
    ``device`` (default the card; raises where there is none) in ``dtype``
    (default float64, the climate solve's; a numpy dtype or its name is
    taken too).

    method='preweighted': a premixed hdf5 (the reference get_ck_tables
    format) or a legacy 1460-grid ASCII directory (or its ``ascii_data``
    file; optics.py:768-1058).  method='resortrebin': a directory of
    per-gas ``<mol>_1460.hdf5`` tables (opacity_factory.py:2280), mixed
    per layer from each atmosphere's abundances (gasesfly,
    optics.py:1164-1198); kwargs: preload_gases (list, required).
    """
    device = checked_device(device)
    dtype = _torch_dtype(dtype)
    if method == 'resortrebin':
        return _load_per_gas_ck(ck_db, kwargs.get('preload_gases'),
                                continuum_db, dtype, device)
    if (os.path.isdir(ck_db)
            or os.path.basename(str(ck_db)) == 'ascii_data'):
        return _load_legacy_ck(ck_db, continuum_db, dtype, device)
    import h5py
    with h5py.File(ck_db, 'r') as f:
        molecules = [x.decode('utf-8') for x in f['ck_molecules'][:]]
        wno = f['wno'][:]
        delta_wno = f['delta_wno'][:]
        pressures_flat = f['pressures'][:]
        temps_flat = f['temperatures'][:]
        gauss_pts = f['gauss_pts'][:]
        gauss_wts = f['gauss_wts'][:]
        kappa = f['kcoeffs'][:]       # [npress, ntemp, nwno, ngauss], ln
        abunds = dict(zip([x.decode('utf-8') for x in f['abunds_map'][:]],
                          np.asarray(f['abunds'][:]).T))
    abunds['temperature'] = temps_flat
    abunds['pressure'] = pressures_flat
    temps, nc_p = np.unique(temps_flat, return_counts=True)
    pressures = np.unique(pressures_flat)
    arrays = _ck_arrays(wno, delta_wno, gauss_wts, kappa, pressures, temps,
                        nc_p, continuum_db, dtype, device)
    return CKTable(arrays, molecules, abunds, gauss_pts, temps, pressures,
                   wno=wno, delta_wno=delta_wno, gauss_wts=gauss_wts)


def _load_per_gas_ck(ck_db, preload_gases, continuum_db, dtype, device):
    """CKTable in gasesfly mode from per-gas hdf5 tables (ck.py:196-237 of
    the JAX package).  The premixed table is a solar-abundance sum of the
    per-gas tables in kappa space (used only where no atmosphere
    abundances exist); spectra and climate runs resort-rebin per layer."""
    from .resortrebin import load_per_gas_tables

    if not preload_gases:
        raise ValueError("method='resortrebin' needs preload_gases=[...]")
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    per_gas, meta = load_per_gas_tables(ck_db, preload_gases, np_dtype)
    loaded = [m for m in preload_gases
              if os.path.exists(os.path.join(ck_db, f'{m}_1460.hdf5'))]
    solar = {'H2O': 1e-3, 'CH4': 5e-4, 'CO': 3e-4, 'NH3': 1e-4,
             'CO2': 1e-7, 'H2S': 3e-5}
    w = np.array([solar.get(m, 1e-5) for m in loaded], np_dtype)
    premix = np.log(np.einsum('g,gptwk->ptwk', w, np.exp(per_gas))
                    + 1e-300)

    wno = np.asarray(meta['wno'], float)
    temps = np.asarray(meta['temps'], float)
    pressures = np.asarray(meta['pressures'], float)
    # rows T-major; the JAX package's frame's columns: the gases, H2, He,
    # temperature, pressure
    nrow = len(temps) * len(pressures)
    abunds = {m: np.full(nrow, solar.get(m, 1e-5)) for m in loaded}
    abunds.update(H2=np.full(nrow, 0.837), He=np.full(nrow, 0.155),
                  temperature=np.repeat(temps, len(pressures)),
                  pressure=np.tile(pressures, len(temps)))
    arrays = _ck_arrays(wno, meta['delta_wno'], meta['gauss_wts'], premix,
                        pressures, temps, meta['nc_p'], continuum_db, dtype,
                        device)
    return CKTable(arrays, loaded, abunds, meta['gauss_pts'], temps,
                   pressures, wno=wno, delta_wno=meta['delta_wno'],
                   gauss_wts=meta['gauss_wts'],
                   per_gas=torch.tensor(per_gas, dtype=dtype, device=device),
                   per_gas_molecules=loaded)


def _load_legacy_ck(ck_db, continuum_db, dtype, device):
    """CKTable from a legacy 1460-grid ASCII table (ck.py:240-265 of the
    JAX package; ``opacities/legacy.py``): ln kappa = log10 kappa x ln 10,
    the chemistry table of the file's species at its positive-pressure
    points."""
    from .legacy import load_legacy_ck_1460

    leg = load_legacy_ck_1460(ck_db)
    wno = np.asarray(leg['wno'], float)
    kappa_ln = np.asarray(leg['kappa'], float) * np.log(10.0)
    pressures_flat = leg['pressures']
    temps = np.asarray(leg['temps'], float)
    p_pos = np.unique(pressures_flat[pressures_flat > 0])
    keep = pressures_flat > 0
    table = np.asarray(leg['abunds'])[keep, :len(leg['molecules'])]
    abunds = {m: table[:, i] for i, m in enumerate(leg['molecules'])}
    abunds['pressure'] = leg['pressure_labels']
    abunds['temperature'] = leg['temperature_labels']
    arrays = _ck_arrays(wno, leg['delta_wno'], leg['gauss_wts'], kappa_ln,
                        p_pos, temps, np.asarray(leg['nc_p'], int),
                        continuum_db, dtype, device)
    return CKTable(arrays, leg['molecules'], abunds, leg['gauss_pts'],
                   temps, p_pos, wno=wno, delta_wno=leg['delta_wno'],
                   gauss_wts=leg['gauss_wts'])


def synthetic_ck_table(continuum_db=None,
                       molecules=('H2O', 'CH4', 'CO', 'NH3'), ntemp=10,
                       npress=10, seed=7, grid661=False,
                       dtype=torch.float64, device='cuda',
                       with_per_gas=False) -> CKTable:
    """Synthetic premixed CK table (ck.py:268-372 of the JAX package) on
    ``device`` (default ``'cuda'``; raises where there is none) in
    ``dtype`` (default float64, the climate solve's).

    The 196-point EGP grid of the bundled CK continuum database, or with
    ``grid661=True`` the 661-bin climate grid (``climate_INPUTS/wvno_661``)
    with the 196-grid CIA row-interpolated onto it.  Band-structured
    synthetic cross sections (the monochromatic factory's), a weak spread
    across the 8 gauss points, and a solar-ish chemistry table at every
    (T, P) grid point.  ``with_per_gas`` adds per-gas tables from the same
    cross sections, one molecule each, unmixed (ck.py:356-369 of the JAX
    package).
    """
    device = checked_device(device)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    if continuum_db is None:
        continuum_db = CONTINUUM_DB
    wno = _db_wno(continuum_db)
    if grid661:
        from ..wavelength import get_cld_input_grid
        wno = np.sort(np.asarray(get_cld_input_grid(grid661=True),
                                 np.float64))
    delta_wno = np.zeros(len(wno))
    delta_wno[1:-1] = 0.5 * (wno[2:] - wno[:-2])
    delta_wno[0] = wno[1] - wno[0]
    delta_wno[-1] = wno[-1] - wno[-2]

    temps = np.linspace(100, 3200, ntemp)
    pressures = np.logspace(-6, 3, npress)
    gauss_pts, gauss_wts = double_gauss_points()
    ngauss = len(gauss_pts)

    # premixed kappa: solar-ish abundance-weighted sum of synthetic sigmas
    mix_solar = {'H2O': 1e-3, 'CH4': 5e-4, 'CO': 3e-4, 'NH3': 1e-4,
                 'CO2': 1e-7, 'H2S': 3e-5}
    sigma_sum = 0.0
    for mol in molecules:
        sig = synthetic_cross_sections(mol, wno, temps, pressures, seed=seed)
        sigma_sum = sigma_sum + mix_solar.get(mol, 1e-5) * sig
    # [ntemp, npress, nwno] -> [npress, ntemp, nwno, ngauss]
    base = np.log(np.maximum(sigma_sum, 1e-50)).transpose(1, 0, 2)
    spread = np.linspace(-1.5, 2.5, ngauss)
    ln_kappa = base[..., None] + spread[None, None, None, :]

    # chemistry table at every (T, P) grid point, T-major
    columns = {k: [] for k in ('H2', 'He', 'H2O', 'CH4', 'CO', 'NH3', 'N2',
                               'temperature', 'pressure')}
    for T in temps:
        for P in pressures:
            row = {'H2': 0.837, 'He': 0.155,
                   'H2O': mix_solar['H2O'] * min(1.0, (T / 1500.0)),
                   'CH4': mix_solar['CH4'] * min(1.0, (2000.0 / T)),
                   'CO': mix_solar['CO'] * min(1.0, (T / 1300.0) ** 2),
                   'NH3': mix_solar['NH3'] * min(1.0, (900.0 / T) ** 2),
                   'N2': 1e-5, 'temperature': T, 'pressure': P}
            for k, v in row.items():
                columns[k].append(v)
    abunds = {k: np.asarray(v, np.float64) for k, v in columns.items()}

    if grid661:
        wno196 = _db_wno(continuum_db)
        cont196, cia_temps, cont_mols = _load_continuum(
            continuum_db, wno196, np_dtype)
        cont = np.zeros(cont196.shape[:2] + (len(wno),), np_dtype)
        for im in range(cont196.shape[0]):
            for it in range(cont196.shape[1]):
                cont[im, it] = np.interp(wno, wno196, cont196[im, it])
    else:
        cont, cia_temps, cont_mols = _load_continuum(continuum_db, wno,
                                                     np_dtype)

    def dev(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    arrays = CKArrays(
        wno=dev(wno), delta_wno=dev(delta_wno), gauss_wts=dev(gauss_wts),
        ln_kappa=dev(ln_kappa), p_log_grid=dev(np.log10(pressures)),
        t_inv_grid=dev(1.0 / temps),
        nc_p=dev(np.full(ntemp, npress), torch.int32), cont_opa=dev(cont),
        cia_temps=dev(cia_temps), continuum_molecules=cont_mols)
    per_gas = None
    if with_per_gas:
        per_gas = np.zeros((len(molecules), npress, ntemp, len(wno),
                            ngauss), np_dtype)
        for ig, mol in enumerate(molecules):
            sig = synthetic_cross_sections(mol, wno, temps, pressures,
                                           seed=seed)
            base = np.log(np.maximum(sig, 1e-50)).transpose(1, 0, 2)
            per_gas[ig] = base[..., None] + spread[None, None, None, :]
        per_gas = dev(per_gas)
    return CKTable(arrays, molecules, abunds, gauss_pts, temps, pressures,
                   wno=wno, delta_wno=delta_wno, gauss_wts=gauss_wts,
                   per_gas=per_gas, per_gas_molecules=molecules)


# ---------------------------------------------------------------------------
# on-device interpolation
# ---------------------------------------------------------------------------

def _last_true(mask):
    """Index of the last True along axis 1, 0 where there is none: the
    reversed-argmax search of the JAX package (argmax takes the first of
    equal maxima, in torch as in jax)."""
    n = mask.shape[1]
    m = mask.to(torch.int32)
    any_true = m.sum(dim=1) > 0
    last = n - 1 - torch.argmax(torch.flip(m, dims=(1,)), dim=1)
    return torch.where(any_true, last, torch.zeros_like(last))


def _neighbours(t_inv_grid, p_log_grid, nc_p, tlayer, player_bar):
    """Shared (1/T, log10 P) neighbour search (optics.py:1098-1152;
    ck.py:379-402 of the JAX package)."""
    t_inv = 1.0 / tlayer
    p_log = torch.log10(player_bar)
    ntemp = t_inv_grid.shape[0]

    t_low = _last_true(t_inv_grid[None, :] > t_inv[:, None])
    t_low = torch.clamp(t_low, max=ntemp - 2)
    t_hi = t_low + 1

    p_low = _last_true(p_log_grid[None, :] <= p_log[:, None])
    p_low = torch.clamp(torch.minimum(p_low, nc_p[t_hi].long() - 3), min=0)
    p_hi = p_low + 1

    t_w = (t_inv - t_inv_grid[t_low]) / (t_inv_grid[t_hi]
                                         - t_inv_grid[t_low])
    p_w = (p_log - p_log_grid[p_low]) / (p_log_grid[p_hi]
                                         - p_log_grid[p_low])
    return t_low, t_hi, p_low, p_hi, t_w, p_w


def interp_premix(ck: CKArrays, tlayer, player_bar):
    """Premixed molecular opacity [nlayer, nwno, ngauss] x Avogadro:
    bilinear in (1/T, log10 P) on ln kappa (optics.py:1151-1161)."""
    t_low, t_hi, p_low, p_hi, t_w, p_w = _neighbours(
        ck.t_inv_grid, ck.p_log_grid, ck.nc_p, tlayer, player_bar)
    tw = t_w[:, None, None]
    pw = p_w[:, None, None]
    k = ck.ln_kappa
    ln_k = ((1 - tw) * (1 - pw) * k[p_low, t_low]
            + tw * (1 - pw) * k[p_low, t_hi]
            + tw * pw * k[p_hi, t_hi]
            + (1 - tw) * pw * k[p_hi, t_low])
    return torch.exp(ln_k) * AVOGADRO


def ck_continuum(ck: CKArrays, tlayer):
    """CIA at the layer temperatures, log-interpolated in 1/T
    (optics.py:1474-1497): [ncont, nlayer, nwno].  The bracketing index
    is a left-side search, clipped to [1, n - 1]."""
    temps = ck.cia_temps
    n = temps.shape[0]
    ihi = torch.clamp(torch.searchsorted(temps, tlayer.contiguous()), 1,
                      n - 1)
    ilo = ihi - 1
    t_lo = temps[ilo]
    t_hi = temps[ihi]
    t_w = ((1.0 / tlayer - 1.0 / t_lo) / (1.0 / t_hi - 1.0 / t_lo))
    lo = torch.log(ck.cont_opa[:, ilo, :])
    hi = torch.log(ck.cont_opa[:, ihi, :])
    return torch.exp((1 - t_w)[None, :, None] * lo
                     + t_w[None, :, None] * hi)


def ck_taugas(ck_table: CKTable, atm, kappa=None):
    """TAUGAS [ngauss, nlayer, nwno] of the spectrum path from the premixed
    table (ck.py:442-497 of the JAX package): the premixed kappa needs no
    mixing-ratio weighting (optics.py:257-262); with per-gas tables the
    molecular k-coefficients are resort-rebin mixed from the atmosphere's
    own abundances instead (gasesfly mode, optics.py:1164-1198).  The
    continuum follows the CK CIA log-interpolation either way.  ``atm`` is
    an ``atmosphere.Atmosphere``; the result lies on the table's device in
    its dtype.  ``kappa`` [nlayer, nwno, ngauss], where given, is the
    molecular opacity to use (the climate's ``ck_rtprops``)."""
    from . import assemble
    from ..constants import PCONV

    a = ck_table.arrays

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=a.ln_kappa.dtype,
                               device=a.ln_kappa.device)

    if kappa is None and ck_table.per_gas is not None:
        from . import resortrebin as rr
        mixes = torch.stack([
            t(atm.mixing_ratio_layer(m)) if m in atm.molecules
            else t(np.zeros(atm.nlayer))
            for m in ck_table.per_gas_molecules])
        kappa = rr.resortrebin_kappa(
            ck_table.per_gas.to(a.ln_kappa.dtype), a.t_inv_grid,
            a.p_log_grid, a.nc_p, t(np.array(ck_table.gauss_pts)),
            t(np.array(ck_table.gauss_wts)), mixes, t(atm.t_layer),
            t(atm.p_layer / PCONV))
    elif kappa is None:
        kappa = interp_premix(a, t(atm.t_layer), t(atm.p_layer / PCONV))
    taugas = (kappa * t(atm.colden / atm.mmw_layer)[:, None, None]
              ).permute(2, 0, 1)

    specs = assemble.classify_continuum(
        atm.continuum_pairs(ck_table.continuum_molecules))
    if specs:
        nlayer = atm.nlayer
        cont = ck_continuum(a, t(atm.t_layer))
        cont_kappa = {
            s.name: cont[list(ck_table.continuum_molecules).index(s.name)]
            for s in specs}
        coef1 = assemble.amagat_coef1(
            t(atm.temperature), t(atm.pressure / PCONV), t(atm.t_layer),
            t(atm.p_layer / PCONV), atm.gravity, t(atm.mmw_layer))
        mix = {m: t(atm.mixing_ratio_layer(m)) for m in atm.molecules}
        for s in specs:
            for m in (s.mol1, s.mol2):
                if m and m not in mix:
                    mix[m] = t(np.zeros(nlayer))
        elec = t(atm.electrons_layer if atm.electrons_layer is not None
                 else np.zeros(nlayer))
        taugas = taugas + assemble.continuum_tau(
            specs, cont_kappa, mix, elec, coef1, t(atm.p_layer),
            t(atm.t_layer), t(atm.colden), t(atm.mmw_layer))[None]
    return taugas
