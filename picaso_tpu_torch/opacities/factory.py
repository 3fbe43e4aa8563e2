"""Synthetic opacity grids and databases for tests and the
production-shaped problem.

Port of the in-memory grid constructors and the sqlite writers
(``build_synthetic_db``, ``slice_db``) of
``picaso_tpu/opacities/factory.py``: deterministic pseudo-line bands with
temperature/pressure broadening, spanning the ~1e-33..1e-18 cm^2/molecule
range of real cross sections.  Every random draw comes from
``np.random.default_rng(crc32(name) + seed)`` exactly as in the JAX
module, so both packages build the same tables.

The production (T, P) layout is read from the chemistry table bundled with
the JAX package, by path and with numpy: importing ``picaso_tpu`` would
import jax, and the port runs where neither jax nor pandas is installed.
The correlated-k tooling is not ported yet.
"""

from __future__ import annotations

import os
import sqlite3
import zlib

import numpy as np
import torch

from .. import checked_device
from .db import OpacityGrid, PTGrid, _adapt_array, connect

__all__ = ['synthetic_cross_sections', 'synthetic_opacity_grid',
           'default_pt_grid', 'production_pt_grid',
           'synthetic_opacity_grid_ragged', 'build_synthetic_db',
           'slice_db']

_CHEM_1060 = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    'picaso_tpu', 'refdata', 'chemistry', '2015_06_1060grid_feh_00_co_10.txt')

CONTINUUM = ('H2H2', 'H2He')


def default_pt_grid(ntemp=20, npress=15):
    """A regular (T, P) grid shaped like the 1060 grid (same per-T count)."""
    temps = np.linspace(75, 3400, ntemp)
    pressures = np.logspace(-6, 3, npress)   # bar
    return temps, pressures


def synthetic_cross_sections(molecule, wno, temps, pressures, seed=1234,
                             n_bands=12):
    """Deterministic band-structured cross sections sigma(T, P, wno), host
    numpy in float64 (factory.py:40-66 of the JAX package).  Returns
    [ntemp, npress, nwno] in cm^2/molecule."""
    rng = np.random.default_rng(zlib.crc32(molecule.encode()) + seed)
    wmin, wmax = wno.min(), wno.max()
    centers = rng.uniform(wmin, wmax, n_bands)
    widths = rng.uniform(0.01, 0.08, n_bands) * (wmax - wmin)
    strengths = 10 ** rng.uniform(-26, -21, n_bands)
    t_exp = rng.uniform(-1.0, 1.5, n_bands)

    sigma = np.zeros((len(temps), len(pressures), len(wno)))
    base = 1e-33  # floor continuum
    for it, T in enumerate(temps):
        for ip, P in enumerate(pressures):
            broad = 1.0 + 0.15 * np.log10(max(P, 1e-6) / 1e-6)
            s = np.zeros(len(wno)) + base * (T / 1000.0)
            for c, w, amp, te in zip(centers, widths, strengths, t_exp):
                s = s + (amp * (T / 1000.0) ** te
                         / (1.0 + ((wno - c) / (w * broad)) ** 2))
            sigma[it, ip] = s
    return sigma


def _cia_shape(mol, wno):
    """The synthetic CIA spectral shape of continuum ``mol`` at 1000 K."""
    rng = np.random.default_rng(zlib.crc32(mol.encode()))
    return 10 ** (-8 + 2 * np.sin(wno / wno.max() * 6 + rng.uniform(0, 3)))


def _continuum_table(wno, cia_temps, dtype):
    cont = np.zeros((len(CONTINUUM), len(cia_temps), len(wno)))
    for im, mol in enumerate(CONTINUUM):
        shape = _cia_shape(mol, wno)
        for it, T in enumerate(cia_temps):
            cont[im, it] = shape * (T / 1000.0) ** 0.5
    # the JAX module fills a table of the working dtype in place
    return cont.astype(dtype)


def synthetic_opacity_grid(wno, molecules=('H2O', 'CH4', 'CO', 'NH3'),
                           ntemp=8, npress=6, seed=1234,
                           dtype=torch.float64, device='cuda') -> OpacityGrid:
    """Regular-grid OpacityGrid (factory.py:145-183 of the JAX package)."""
    device = checked_device(device)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    wno = np.asarray(wno, np.float64)
    temps, pressures = default_pt_grid(ntemp, npress)
    npt = ntemp * npress
    log_kappa = np.zeros((len(molecules), npt, len(wno)), np_dtype)
    for im, mol in enumerate(molecules):
        sigma = synthetic_cross_sections(mol, wno, temps, pressures,
                                         seed=seed)
        log_kappa[im] = np.log10(
            np.where(sigma > 0, sigma, 1e-50)).reshape(npt, -1)
    cia_temps = np.linspace(100, 3000, 10)
    cont = _continuum_table(wno, cia_temps, np_dtype)

    nc_p = np.full(ntemp, npress, np.int32)
    t_offset = np.concatenate([[0], np.cumsum(nc_p)[:-1]]).astype(np.int32)

    def dev(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    pt = PTGrid(t_inv_grid=dev(1.0 / temps), p_log_grid=dev(np.log10(pressures)),
                nc_p=dev(nc_p, torch.int32), t_offset=dev(t_offset, torch.int32))
    return OpacityGrid(wno=dev(wno), log_kappa=dev(log_kappa), pt=pt,
                       cont_opa=dev(cont), cia_temps=dev(cia_temps),
                       molecules=tuple(molecules),
                       continuum_molecules=CONTINUUM)


def production_pt_grid():
    """The ragged 1060-point (T, P) grid of the production monochromatic
    DBs (60 temperatures x 15-18 pressures each), read from the bundled
    Visscher chemistry table, which is tabulated on that grid.

    Returns (temps_flat [1060], press_flat [1060], nc_p [60]).
    """
    tab = np.loadtxt(_CHEM_1060, skiprows=1, usecols=(0, 1))
    temps_flat = tab[:, 0].astype(np.float64)
    press_flat = (10.0 ** tab[:, 1]).astype(np.float64)
    _, idx, counts = np.unique(temps_flat, return_index=True,
                               return_counts=True)
    order = np.argsort(idx)
    nc_p = counts[order].astype(np.int32)
    return temps_flat, press_flat, nc_p


def _band_sigma_flat(molecule, wno, temps_flat, press_flat, device,
                     seed=1234, n_bands=12):
    """Band-model log10 cross sections [npt, nwno] (float32, on ``device``)
    on a flat ragged PT list.

    Same band model and float32 arithmetic as the JAX module's
    ``_band_sigma_device``: the 16 x 1060 x 50k production cube is built
    on the card in seconds and never visits host memory.
    """
    rng = np.random.default_rng(zlib.crc32(molecule.encode()) + seed)
    wmin, wmax = wno.min(), wno.max()
    centers = rng.uniform(wmin, wmax, n_bands)
    widths = rng.uniform(0.01, 0.08, n_bands) * (wmax - wmin)
    strengths = 10 ** rng.uniform(-26, -21, n_bands)
    t_exp = rng.uniform(-1.0, 1.5, n_bands)

    def f32(x):
        return torch.tensor(np.asarray(x), dtype=torch.float32,
                            device=device)

    wno_d = f32(wno)
    press = f32(press_flat)
    broad = 1.0 + 0.15 * torch.log10(torch.clamp(press, min=1e-6) / 1e-6)
    tfac = f32(temps_flat) / 1000.0                          # [npt]
    # sigma underflows f32 at the 1e-33 floor: rescale by 1e30 so every
    # intermediate sits in f32 range, subtract 30 from the log after
    s = (1e-33 * 1e30) * tfac[:, None] * torch.ones_like(wno_d)[None, :]
    for c, w, amp, te in zip(f32(centers), f32(widths), f32(strengths),
                             f32(t_exp)):
        d = (wno_d[None, :] - c) / (w * broad[:, None])
        s = s + (amp * 1e30) * tfac[:, None] ** te / (1.0 + d * d)
    return torch.log10(s) - 30.0


def synthetic_opacity_grid_ragged(wno, molecules, seed=1234,
                                  dtype=torch.float64,
                                  device='cuda') -> OpacityGrid:
    """Production-shaped OpacityGrid: the ragged 1060-point PT grid with
    synthetic band-model opacities for ``molecules`` (factory.py:259-297
    of the JAX package)."""
    device = checked_device(device)
    wno = np.asarray(wno, np.float64)
    temps_flat, press_flat, nc_p = production_pt_grid()
    log_kappa = torch.empty((len(molecules), len(temps_flat), len(wno)),
                            dtype=dtype, device=device)
    for im, mol in enumerate(molecules):
        log_kappa[im] = _band_sigma_flat(mol, wno, temps_flat, press_flat,
                                         device, seed=seed)

    cia_temps = np.linspace(100, 3000, 10)
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    cont = _continuum_table(wno, cia_temps, np_dtype)

    t_offset = np.concatenate([[0], np.cumsum(nc_p)[:-1]]).astype(np.int32)
    temps = np.array(sorted(set(temps_flat)))
    # per-T pressure grids share one log-spaced ladder; the longest row is
    # the p_log_grid (shorter rows are guarded by nc_p)
    imax = int(np.argmax(nc_p))
    p_row = press_flat[t_offset[imax]:t_offset[imax] + nc_p[imax]]

    def dev(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    pt = PTGrid(t_inv_grid=dev(1.0 / temps), p_log_grid=dev(np.log10(p_row)),
                nc_p=dev(nc_p, torch.int32), t_offset=dev(t_offset, torch.int32))
    return OpacityGrid(wno=dev(wno), log_kappa=log_kappa, pt=pt,
                       cont_opa=dev(cont), cia_temps=dev(cia_temps),
                       molecules=tuple(molecules),
                       continuum_molecules=CONTINUUM)


_SCHEMA = ('CREATE TABLE header (id INTEGER PRIMARY KEY, '
           'pressure_unit VARCHAR, temperature_unit VARCHAR, '
           'wavenumber_grid array, continuum_unit VARCHAR, '
           'molecular_unit VARCHAR)',
           'CREATE TABLE molecular (id INTEGER PRIMARY KEY, '
           'molecule VARCHAR, ptid INTEGER, pressure FLOAT, '
           'temperature FLOAT, opacity array)',
           'CREATE TABLE continuum (id INTEGER PRIMARY KEY, '
           'molecule VARCHAR, temperature FLOAT, opacity array)')
_INSERT_HEADER = ('INSERT INTO header (pressure_unit, temperature_unit, '
                  'wavenumber_grid, continuum_unit, molecular_unit) '
                  'VALUES (?,?,?,?,?)')
_INSERT_MOLECULAR = ('INSERT INTO molecular (molecule, ptid, pressure, '
                     'temperature, opacity) VALUES (?,?,?,?,?)')
_INSERT_CONTINUUM = ('INSERT INTO continuum (molecule, temperature, '
                     'opacity) VALUES (?,?,?)')


def _new_db(filename):
    """A fresh database with the reference schema (opacity_factory.py:
    622-740 of the reference): (connection, cursor)."""
    sqlite3.register_adapter(np.ndarray, _adapt_array)
    conn = sqlite3.connect(filename, detect_types=sqlite3.PARSE_DECLTYPES)
    cur = conn.cursor()
    for statement in _SCHEMA:
        cur.execute(statement)
    return conn, cur


def build_synthetic_db(filename, wno, molecules=('H2O', 'CH4', 'CO', 'NH3'),
                       continuum=('H2H2', 'H2He'), ntemp=8, npress=6,
                       cia_temps=None, seed=1234, pt_layout='regular',
                       device='cuda'):
    """Write a reference-schema sqlite database with synthetic opacities
    (factory.py:69-142 of the JAX package); returns ``filename``.

    ``pt_layout='regular'``: the ``ntemp x npress`` grid of
    :func:`default_pt_grid`, cross sections from the float64 numpy band
    model (:func:`synthetic_cross_sections`, the JAX writer's numbers
    exactly).  ``pt_layout='1060'``: the ragged production grid
    (:func:`production_pt_grid`), one ``molecular`` row per flat grid
    point, the float32 band model :func:`_band_sigma_flat` evaluated on
    ``device`` (the JAX writer evaluates the same float32 arithmetic on its
    device; the two agree to ~1e-4 dex).  The CIA rows use ``crc32`` seeds
    as in the JAX package.
    """
    if pt_layout == '1060':
        device = checked_device(device)
        temps_flat, press_flat, _ = production_pt_grid()
    else:
        temps, pressures = default_pt_grid(ntemp, npress)
    if cia_temps is None:
        cia_temps = np.linspace(100, 3000, 10)
    wno_arr = np.asarray(wno)

    conn, cur = _new_db(filename)
    cur.execute(_INSERT_HEADER, ('bar', 'kelvin',
                                 np.asarray(wno, np.float64),
                                 'cm-1 amagat-2', 'cm2/molecule'))
    for mol in molecules:
        if pt_layout == '1060':
            log_sig = _band_sigma_flat(mol, wno_arr, temps_flat, press_flat,
                                       device, seed=seed)
            log_sig = log_sig.cpu().numpy().astype(np.float64)
            for ptid0, (T, P) in enumerate(zip(temps_flat, press_flat)):
                cur.execute(_INSERT_MOLECULAR,
                            (mol, ptid0 + 1, float(P), float(T),
                             10.0 ** log_sig[ptid0]))
            continue
        sigma = synthetic_cross_sections(mol, wno_arr, temps, pressures,
                                         seed=seed)
        ptid = 0
        for it, T in enumerate(temps):
            for ip, P in enumerate(pressures):
                ptid += 1
                cur.execute(_INSERT_MOLECULAR,
                            (mol, ptid, float(P), float(T),
                             sigma[it, ip].astype(np.float64)))
    for mol in continuum:
        shape = _cia_shape(mol, wno_arr)
        for T in cia_temps:
            cur.execute(_INSERT_CONTINUUM,
                        (mol, float(T),
                         (shape * (T / 1000.0) ** 0.5).astype(np.float64)))
    conn.commit()
    conn.close()
    return filename


def slice_db(src_db, dst_db, wave_range, molecules=None):
    """Write a narrow-wavelength slice of a reference-schema opacity
    database (factory.py:468-529 of the JAX package); returns ``dst_db``.

    ``wave_range`` is [min, max] in micron (open interval); ``molecules``
    optionally restricts the species kept.  Continuum rows are sliced on
    the same window; the header keeps the source's units.
    """
    cur, conn = connect(src_db)
    cur.execute('SELECT wavenumber_grid FROM header')
    wno = np.asarray(cur.fetchone()[0], float)
    cur.execute('SELECT pressure_unit, temperature_unit, continuum_unit, '
                'molecular_unit FROM header')
    units = cur.fetchone()
    wave = 1e4 / wno
    keep = (wave > min(wave_range)) & (wave < max(wave_range))
    if not keep.any():
        raise ValueError(f'no wavenumber points inside {wave_range} um')
    idx = np.where(keep)[0]

    out, oc = _new_db(dst_db)
    oc.execute(_INSERT_HEADER, (units[0], units[1], wno[idx], units[2],
                                units[3]))
    if molecules is None:
        cur.execute('SELECT DISTINCT molecule FROM molecular')
        molecules = [x[0] for x in cur.fetchall()]
    for mol in molecules:
        cur.execute('SELECT ptid, pressure, temperature, opacity '
                    'FROM molecular WHERE molecule = ?', (mol,))
        rows = [(mol, ptid, p, t, np.asarray(op, float)[idx])
                for ptid, p, t, op in cur.fetchall()]
        oc.executemany(_INSERT_MOLECULAR, rows)
    cur.execute('SELECT molecule, temperature, opacity FROM continuum')
    crows = [(mol, t, np.asarray(op, float)[idx])
             for mol, t, op in cur.fetchall()]
    oc.executemany(_INSERT_CONTINUUM, crows)
    out.commit()
    out.close()
    conn.close()
    return dst_db
