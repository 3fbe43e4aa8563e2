"""Legacy 1460-grid ASCII correlated-k table reader and writer (Lupu
tables).

Port of ``picaso_tpu/opacities/legacy.py`` (reference ``optics.py:768-1058``
``get_legacy_data_1460``), host numpy.  The file is a flat
whitespace-token stream, consumed section by section in the reference's
order for the 24-species / 73 x 20 P-T / 200-window / 8-gauss tables:

  n_species, species names, elemental abundances
  [max_pc, max_tc, max_ele] (Fortran order), nwno, window centers,
  4-token variant marker, window widths, 4 filler tokens, nc_t,
  nc_p per temperature, dummy header block, pressures (millibar),
  temperatures, (ngauss1, ngauss2, gfrac, ngauss), gauss points and
  weights, 2 filler tokens, kappa [windows, 2*ngauss, max_pc, max_tc]
  (Fortran order, log10 cm^2/molecule).

:func:`write_legacy_ascii` writes the same tokens in the same text as the
JAX package's writer, so the two write byte-identical files.
:func:`synthetic_legacy_table` (the port's own, no JAX counterpart) builds
a table in that layout on the CK continuum grid, whose numbers are the
same on every machine.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ['load_legacy_ck_1460', 'write_legacy_ascii',
           'synthetic_legacy_table']

# layout constants of the 1460-point Lupu grid (optics.py:783-787)
MAX_ELE = 35
MAX_TC = 73
MAX_PC = 20
MAX_WINDOWS = 200
NGAUSS = 8
N_DUMMY = 37      # tokens in the header block before the pressure table
N_SPECIES = 24

GRID_1460 = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), 'picaso_tpu', 'refdata', 'opacities', 'grid1460.csv')

# the species of synthetic_legacy_table, in the legacy tables' style
LEGACY_SPECIES = ('e-', 'H2', 'H', 'H+', 'H-', 'H2-', 'H2+', 'H3+', 'He',
                  'H2O', 'CH4', 'CO', 'NH3', 'N2', 'PH3', 'H2S', 'TiO', 'VO',
                  'Fe', 'FeH', 'CrH', 'Na', 'K', 'Rb')


class _Tokens:
    def __init__(self, path):
        with open(path) as f:
            self.toks = f.read().split()
        self.i = 0

    def take(self, n):
        out = self.toks[self.i:self.i + n]
        if len(out) != n:
            raise ValueError(f'legacy ascii truncated: wanted {n} tokens '
                             f'at offset {self.i}, got {len(out)}')
        self.i += n
        return out

    def floats(self, n):
        return np.array(self.take(n), dtype=np.float64)

    def ints(self, n):
        return np.array(self.take(n), dtype=np.float64).astype(int)


def load_legacy_ck_1460(path, max_tc=MAX_TC, max_pc=MAX_PC,
                        max_ele=MAX_ELE, max_windows=MAX_WINDOWS,
                        nspecies=N_SPECIES):
    """Parse a legacy ``ascii_data`` CK table (a file, or the directory
    holding it) into a dict of numpy arrays: molecules, abunds
    [npt, max_ele], wno, delta_wno, pressures (bar), temps, nc_p,
    gauss_pts, gauss_wts and kappa [max_pc, max_tc, nwno, ngauss] (log10,
    as stored); legacy.py:61-112 of the JAX package."""
    if os.path.isdir(path):
        path = os.path.join(path, 'ascii_data')
    tk = _Tokens(path)
    n_sp = tk.ints(1)[0]
    if n_sp != nspecies:
        nspecies = n_sp
    molecules = tk.take(nspecies)
    abunds = tk.floats(max_ele * max_pc * max_tc).reshape(
        (max_pc, max_tc, max_ele), order='F')
    nwno = tk.ints(1)[0]
    wno = tk.floats(max_windows - 4)
    marker = tk.floats(4)
    delta_wno = tk.floats(max_windows - 4)
    tk.take(4)
    nc_t = tk.ints(1)[0]
    nc_p = tk.ints(max_tc)
    tk.take(N_DUMMY)
    pressures = tk.floats(max_pc * max_tc) / 1e3   # millibar -> bar
    temps = tk.floats(nc_t)
    tk.ints(2)                                     # ngauss1, ngauss2
    gfrac = tk.floats(1)[0]
    ngauss = tk.ints(1)[0]
    gpw = tk.floats(2 * ngauss).reshape(ngauss, 2)
    tk.take(2)
    kappa = tk.floats(max_windows * 2 * ngauss * max_pc * max_tc).reshape(
        (max_windows, 2 * ngauss, max_pc, max_tc), order='F')
    kappa = kappa.swapaxes(1, 3).swapaxes(0, 2)[:, :, :nwno, :ngauss]
    # per-point (P, T) labels of the abundance table, zero-P rows dropped
    pt_press = pressures.reshape(max_tc, max_pc)
    keep = pt_press > 0
    return dict(molecules=list(molecules),
                abunds=abunds.reshape(max_pc * max_tc, max_ele, order='F'),
                nwno=nwno, wno=wno[:nwno], delta_wno=delta_wno[:nwno],
                marker=marker, nc_p=nc_p,
                pressures=pressures, temps=temps,
                pressure_labels=pt_press[keep],
                temperature_labels=np.repeat(temps, max_pc).reshape(
                    max_tc, max_pc)[keep],
                gauss_pts=gpw[:, 0], gauss_wts=gpw[:, 1], gfrac=gfrac,
                ngauss=ngauss, kappa=kappa)


def write_legacy_ascii(path, molecules, abunds, wno, delta_wno, nc_p,
                       pressures_bar, temps, gauss_pts, gauss_wts, kappa,
                       gfrac=0.95, max_ele=MAX_ELE, max_windows=None):
    """Write the legacy token layout (legacy.py:115-155 of the JAX
    package, token for token, three to a line).

    kappa: [max_pc, max_tc, nwno, ngauss] log10 values, zero-padded out to
    [max_windows, 2*ngauss] in the window and gauss axes like the
    historical files.
    """
    max_pc, max_tc, nwno, ngauss = kappa.shape
    if max_windows is None:
        max_windows = nwno + 4
    toks = [len(molecules)]
    toks += list(molecules)
    ab = np.zeros((max_pc, max_tc, max_ele))
    ab[:, :, :abunds.shape[-1]] = np.asarray(abunds).reshape(
        max_pc, max_tc, -1, order='F')
    toks += list(ab.ravel(order='F'))
    toks += [nwno]
    w = np.zeros(max_windows - 4)
    w[:nwno] = wno
    toks += list(w)
    toks += [9.0, 9.0, 9.0, 9.0]          # variant marker (non-zero)
    dw = np.zeros(max_windows - 4)
    dw[:nwno] = delta_wno
    toks += list(dw)
    toks += [0.0] * 4
    toks += [len(temps)]
    toks += list(np.asarray(nc_p, int))
    toks += [0.0] * N_DUMMY
    toks += list(np.asarray(pressures_bar) * 1e3)
    toks += list(temps)
    toks += [ngauss // 2, ngauss // 2, gfrac, ngauss]
    toks += [v for p_w in zip(gauss_pts, gauss_wts) for v in p_w]
    toks += [0.0] * 2
    kap = np.zeros((max_windows, 2 * ngauss, max_pc, max_tc))
    kap[:nwno, :ngauss] = np.moveaxis(np.asarray(kappa), (0, 1), (2, 3))
    toks += list(kap.ravel(order='F'))
    toks += [0.0] * 2
    with open(path, 'w') as f:
        for i in range(0, len(toks), 3):
            f.write(' '.join(str(t) for t in toks[i:i + 3]) + '\n')


def _sig(x, digits):
    """``x`` rounded to ``digits`` significant digits by Python's correctly
    rounded formatting."""
    return np.array([float(f'{v:.{digits - 1}e}') for v in
                     np.ravel(x)]).reshape(np.shape(x))


def synthetic_legacy_table():
    """A premixed CK table in the legacy layout: ``write_legacy_ascii``'s
    keyword arguments (kappa [20, 73, 196, 8] log10 cm^2/molecule).

    The 1460-point (T, P) grid of ``refdata/opacities/grid1460.csv`` (73
    temperatures x 20 pressures), the 196 bins of the CK continuum
    database (which the loader requires), ``LEGACY_SPECIES`` with a
    solar-ish chemistry (``synthetic_ck_table``'s laws, the other species
    traces) and the band model of ``factory.synthetic_cross_sections``
    premixed as ``synthetic_ck_table`` mixes it, with its spread across
    the gauss points.  Every written number is rounded (log10 kappa to 4
    decimals, abundances and quadrature to a few significant digits) so
    that a last-bit difference of a transcendental function between two
    machines cannot reach the file's text.
    """
    from .ck import CONTINUUM_DB, _db_wno, double_gauss_points
    from .factory import synthetic_cross_sections

    grid = np.genfromtxt(GRID_1460, delimiter=',', names=True)
    temps_flat = grid['temperature_K']
    press_flat = grid['pressure_bar']
    temps = temps_flat[::MAX_PC]
    pressures = press_flat[:MAX_PC]
    if not (np.array_equal(np.repeat(temps, MAX_PC), temps_flat)
            and np.array_equal(np.tile(pressures, MAX_TC), press_flat)):
        raise ValueError('grid1460.csv is not 73 temperatures x the same '
                         '20 pressures')
    wno = np.asarray(_db_wno(CONTINUUM_DB), np.float64)
    delta_wno = np.zeros(len(wno))
    delta_wno[1:-1] = 0.5 * (wno[2:] - wno[:-2])
    delta_wno[0] = wno[1] - wno[0]
    delta_wno[-1] = wno[-1] - wno[-2]

    mix_solar = {'H2O': 1e-3, 'CH4': 5e-4, 'CO': 3e-4, 'NH3': 1e-4}
    sigma_sum = 0.0
    for mol, vmr in mix_solar.items():
        sigma_sum = sigma_sum + vmr * synthetic_cross_sections(
            mol, wno, temps, pressures, seed=7)
    # [ntemp, npress, nwno] -> [npress, ntemp, nwno, ngauss], log10
    base = np.log(np.maximum(sigma_sum, 1e-50)).transpose(1, 0, 2)
    spread = np.linspace(-1.5, 2.5, NGAUSS)
    kappa = np.round((base[..., None] + spread) / np.log(10.0), 4)

    # chemistry at every grid point, T-major (pressure fastest)
    t = np.repeat(temps, MAX_PC)
    cols = {sp: np.full(t.shape, 1e-12) for sp in LEGACY_SPECIES}
    cols.update({'H2': np.full(t.shape, 0.837), 'He': np.full(t.shape, 0.155),
                 'e-': 1e-9 * t / 1000.0, 'H': 1e-6 * t / 1000.0,
                 'H-': 1e-11 * t / 1000.0,
                 'H2O': 1e-3 * np.minimum(1.0, t / 1500.0),
                 'CH4': 5e-4 * np.minimum(1.0, 2000.0 / t),
                 'CO': 3e-4 * np.minimum(1.0, (t / 1300.0) ** 2),
                 'NH3': 1e-4 * np.minimum(1.0, (900.0 / t) ** 2),
                 'N2': np.full(t.shape, 1e-5),
                 'H2S': np.full(t.shape, 3e-5),
                 'PH3': np.full(t.shape, 5e-7),
                 'Na': np.full(t.shape, 2e-6), 'K': np.full(t.shape, 1e-7)})
    abunds = _sig(np.stack([cols[sp] for sp in LEGACY_SPECIES], axis=1), 6)
    gauss_pts, gauss_wts = double_gauss_points()
    return dict(molecules=list(LEGACY_SPECIES), abunds=abunds, wno=wno,
                delta_wno=delta_wno, nc_p=np.full(MAX_TC, MAX_PC),
                pressures_bar=press_flat, temps=temps,
                gauss_pts=_sig(gauss_pts, 12), gauss_wts=_sig(gauss_wts, 12),
                kappa=kappa, max_windows=MAX_WINDOWS)
