"""Monochromatic opacity grids on the device: neighbour search and
bilinear log-interpolation.

Port of ``picaso_tpu/opacities/db.py`` (the device half).  The opacity cube
``log_kappa [nmol, npt, nwno]`` is log10 cross section (cm^2/molecule) on
the ragged (T, P) grid of the reference monochromatic databases; every
per-call step (neighbour search, blend, Avogadro scaling) runs on the
tensor's device.  :func:`load_opacity_db` reads a reference-format sqlite
database on the host (numpy and ``sqlite3``) and puts it on the device the
caller names.

Grid semantics preserved exactly (reference picaso optics.py:2048-2123):
* bilinear in (1/T, log10 P) on log10(opacity);
* temperatures clamp to the grid edges; the pressure low index respects the
  ragged pressures-per-temperature count via ``min(ilo, nc_p[t_hi] - 3)``;
* continuum (CIA) takes the nearest temperature, no interpolation.
"""

from __future__ import annotations

import io
import sqlite3
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import checked_device, default_dtype
from ..constants import AVOGADRO

__all__ = ['PTGrid', 'OpacityGrid', 'connect', 'load_opacity_db',
           'interp_molecular', 'interp_molecular_nearest',
           'nearest_continuum', 'LOG_AVO']

LOG_AVO = float(np.log10(AVOGADRO))


class PTGrid(NamedTuple):
    """The ragged (T, P) grid of the molecular table (1060/1460 layout)."""
    t_inv_grid: torch.Tensor   # [ntemp] 1/T, descending (T ascending)
    p_log_grid: torch.Tensor   # [npress] log10 P(bar)
    nc_p: torch.Tensor         # [ntemp] int32 pressures per temperature
    t_offset: torch.Tensor     # [ntemp] int32 start of each T in the flat grid


class OpacityGrid(NamedTuple):
    """Device-resident opacity data for one monochromatic database."""
    wno: torch.Tensor          # [nwno]
    log_kappa: torch.Tensor    # [nmol, npt, nwno] log10 cm^2/molecule
    pt: PTGrid
    cont_opa: torch.Tensor     # [ncont, ntcia, nwno]
    cia_temps: torch.Tensor    # [ntcia]
    molecules: tuple
    continuum_molecules: tuple
    # optional int16 fixed-point copy of log_kappa [nmol, npt, nwno] and
    # its [scale, offset] float32 pair (with_blocked_table(quantize=True))
    log_kappa_blocked: Optional[torch.Tensor] = None
    blocked_qparams: Optional[torch.Tensor] = None

    def with_blocked_table(self, quantize=False):
        """The grid with the gather table the JAX package's
        ``with_blocked_table`` adds (db.py:105-117 there).

        ``quantize=True`` adds the int16 fixed-point table (half the bytes
        of the float32 one, ~1e-3 dex steps) and its qparams;
        ``forward`` then gathers from it (``cuda_interp.interp_tau_q``).
        The table stays in the flat ``[nmol, npt, nwno]`` layout: the JAX
        package's ``[npt, nwb, nmol, block_w]`` repack and its padding to
        128-lane blocks made each TPU row fetch one contiguous DMA, while
        the CUDA gathers already read flat-table rows coalesced.  So
        ``quantize=False`` returns the grid unchanged: the flat float32
        table is the port's gather layout.
        """
        if not quantize:
            return self
        from .cuda_interp import quantize_table
        q, qparams = quantize_table(self.log_kappa)
        return self._replace(log_kappa_blocked=q, blocked_qparams=qparams)


def _convert_array(blob):
    out = io.BytesIO(blob)
    out.seek(0)
    return np.load(out)


def _adapt_array(arr):
    out = io.BytesIO()
    np.save(out, arr)
    out.seek(0)
    return sqlite3.Binary(out.read())


def connect(db_filename):
    """sqlite connection with numpy-array columns (the reference's
    optics.py:1977): returns (cursor, connection)."""
    sqlite3.register_adapter(np.ndarray, _adapt_array)
    sqlite3.register_converter('array', _convert_array)
    conn = sqlite3.connect(db_filename, detect_types=sqlite3.PARSE_DECLTYPES)
    return conn.cursor(), conn


def load_opacity_db(db_filename, wave_range=None, resample=1,
                    molecules: Optional[Sequence[str]] = None, dtype=None,
                    device='cuda', native=None) -> OpacityGrid:
    """Load a reference-format sqlite opacity database into an OpacityGrid
    on ``device`` in ``dtype`` (default: float64 on the CPU, float32 on
    CUDA).

    Port of the JAX package's ``load_opacity_db`` (db.py:120-214 there)
    through its Python row path: ``wave_range`` in micron (open interval),
    ``resample`` a stride through the stored wavenumber grid, ``molecules``
    a subset of the stored ones (kept in sorted order).  P and T keep
    their first-appearance order (pandas ``unique``), ``nc_p`` counts the
    pressures of each temperature and ``t_offset`` starts each temperature
    in the flat grid; zero opacities become 1e-50 before the log; each CIA
    row goes to its temperature's place by ``searchsorted``.  The decode
    runs on the host, then the arrays move to the device once.

    ``native`` picks the decode of the blobs, as the JAX package's
    ``native`` does (db.py:170-180 there): the C++ library of
    :mod:`picaso_tpu_torch.native` (multithreaded over molecules, window,
    stride and log10 fused in; float32 only, bitwise the Python decode's)
    or numpy.  ``None``: the C++ decode for a float32 load, numpy
    otherwise.  ``True``: the C++ decode, and where it cannot be used (a
    float64 load, no g++ or libsqlite3, a blob it cannot read) a
    ``warnings.warn`` that names the reason before the numpy decode runs.
    ``False``: numpy.
    """
    device = checked_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    cur, conn = connect(db_filename)

    cur.execute('SELECT wavenumber_grid FROM header')
    wno_full = cur.fetchone()[0][::resample]
    wave = 1e4 / wno_full
    if wave_range is None:
        loc = np.arange(len(wno_full))
    else:
        loc = np.where((wave > min(wave_range)) & (wave < max(wave_range)))[0]
    wno = wno_full[loc]

    cur.execute('SELECT molecule FROM continuum')
    avail_continuum = sorted(set(x[0] for x in cur.fetchall()))
    cur.execute('SELECT temperature FROM continuum')
    cia_temps = np.unique([x[0] for x in cur.fetchall()])

    cur.execute('SELECT molecule FROM molecular')
    avail_mol = sorted(set(x[0] for x in cur.fetchall()))
    if molecules is not None:
        avail_mol = [m for m in avail_mol if m in set(molecules)]

    cur.execute('SELECT DISTINCT ptid, pressure, temperature FROM molecular')
    pt_pairs = sorted(cur.fetchall(), key=lambda x: x[0])
    pressures_all = np.array([p for _, p, _ in pt_pairs])
    temps_all = np.array([t for _, _, t in pt_pairs])
    # unique in first-appearance order, like pandas .unique()
    _, p_first = np.unique(pressures_all, return_index=True)
    pressures = pressures_all[np.sort(p_first)]
    _, t_first = np.unique(temps_all, return_index=True)
    temps = temps_all[np.sort(t_first)]
    nc_p = np.array([(temps_all == t).sum() for t in temps])
    t_offset = np.concatenate([[0], np.cumsum(nc_p)[:-1]])

    log_kappa = cont = None
    if native or (native is None and np_dtype == np.float32):
        log_kappa, cont, reason = _native_decode(
            db_filename, avail_mol, len(pt_pairs), avail_continuum,
            cia_temps, loc, resample, np_dtype)
        if reason is not None and native:
            warnings.warn(f'load_opacity_db(native=True): {reason}; '
                          'decoding with numpy instead', stacklevel=2)

    if log_kappa is None:
        log_kappa = np.full((len(avail_mol), len(pt_pairs), len(wno)),
                            -50.0, dtype=np_dtype)
        for im, mol in enumerate(avail_mol):
            cur.execute('SELECT ptid, opacity FROM molecular '
                        'WHERE molecule = ?', (mol,))
            for ptid, op in cur.fetchall():
                arr = op[::resample][loc]
                log_kappa[im, ptid - 1] = np.log10(
                    np.where(arr != 0, arr, 1e-50)).astype(np_dtype)

        cont = np.zeros((len(avail_continuum), len(cia_temps), len(wno)),
                        dtype=np_dtype)
        for im, mol in enumerate(avail_continuum):
            cur.execute('SELECT temperature, opacity FROM continuum '
                        'WHERE molecule = ?', (mol,))
            for t, op in cur.fetchall():
                it = int(np.searchsorted(cia_temps, t))
                cont[im, it] = op[::resample][loc].astype(np_dtype)
    conn.close()

    def dev(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    pt = PTGrid(t_inv_grid=dev(1.0 / temps), p_log_grid=dev(np.log10(pressures)),
                nc_p=dev(nc_p, torch.int32), t_offset=dev(t_offset, torch.int32))
    return OpacityGrid(wno=dev(wno), log_kappa=dev(log_kappa), pt=pt,
                       cont_opa=dev(cont), cia_temps=dev(cia_temps),
                       molecules=tuple(avail_mol),
                       continuum_molecules=tuple(avail_continuum))


def _native_decode(db_filename, molecules, npt, continuum, cia_temps, loc,
                   resample, np_dtype):
    """(log_kappa, cont, None) from the C++ decode, or (None, None,
    reason) where it cannot be used."""
    if np_dtype != np.float32:
        return None, None, (f'the C++ decode writes float32, not '
                            f'{np.dtype(np_dtype).name}')
    from .. import native as native_mod
    try:
        log_kappa = native_mod.load_molecular(db_filename, molecules, npt,
                                              loc, resample)
        if log_kappa is None:
            return None, None, ('the C++ library is unavailable ('
                                f'{native_mod.unavailable_reason()})')
        cont = native_mod.load_continuum(db_filename, continuum, cia_temps,
                                         loc, resample)
    except RuntimeError as e:
        return None, None, f'the C++ decode failed ({e})'
    return log_kappa, cont, None


def _last_true(mask):
    """Index of the last True per row (0 where none): the JAX module's
    ``n - 1 - argmax(mask[:, ::-1])``, relying on argmax returning the
    FIRST maximal index, as jnp.argmax does."""
    n = mask.shape[1]
    last = n - 1 - torch.argmax(torch.flip(mask, [1]).to(torch.int32), dim=1)
    return torch.where(mask.any(dim=1), last, torch.zeros_like(last))


def _find_indices(pt: PTGrid, tlayer, player_bar, return_parity=False):
    """Neighbour indices + weights (reference optics.py:2048-2123).

    Returns (t_w [nlayer], p_w [nlayer], idx [4, nlayer] int64) where the
    idx rows are the flat-grid rows of the corners (t_low,p_low),
    (t_hi,p_low), (t_hi,p_hi), (t_low,p_hi) -- the reference's weight
    pairing, which the gather kernel's weights follow.  With
    ``return_parity`` also the base-corner parities (t_low % 2,
    p_low % 2), int32 [nlayer] each, that the gather probe's parity slots
    take (``probes.gather_probe.parity_slots``).
    """
    t_inv = 1.0 / tlayer
    p_log = torch.log10(player_bar)
    tg = pt.t_inv_grid
    pg = pt.p_log_grid
    ntemp = tg.shape[0]

    # last grid index with 1/T_grid > 1/T (t_inv_grid is descending),
    # clamped to [0, ntemp-2]
    t_low = torch.clamp(_last_true(tg[None, :] > t_inv[:, None]),
                        max=ntemp - 2)
    t_hi = t_low + 1

    last_le = _last_true(pg[None, :] <= p_log[:, None])
    # ragged-pressure guard: min(ilo, nc_p[t_hi] - 3)  (optics.py:2094-2099)
    p_low = torch.minimum(last_le, pt.nc_p.long()[t_hi] - 3)
    p_low = torch.clamp(p_low, min=0)
    p_hi = p_low + 1

    t_w = (t_inv - tg[t_low]) / (tg[t_hi] - tg[t_low])
    p_w = (p_log - pg[p_low]) / (pg[p_hi] - pg[p_low])

    off = pt.t_offset.long()
    idx = torch.stack([off[t_low] + p_low, off[t_hi] + p_low,
                       off[t_hi] + p_hi, off[t_low] + p_hi], dim=0)
    if return_parity:
        return t_w, p_w, idx, ((t_low % 2).to(torch.int32),
                               (p_low % 2).to(torch.int32))
    return t_w, p_w, idx


def corner_weights(t_w, p_w):
    """[4, nlayer] bilinear weights in the corner order of _find_indices."""
    return torch.stack([(1 - t_w) * (1 - p_w), t_w * (1 - p_w),
                        t_w * p_w, (1 - t_w) * p_w], dim=0)


def interp_molecular(opa: OpacityGrid, tlayer, player_bar):
    """All molecules' cross sections at every layer: [nmol, nlayer, nwno].

    Bilinear interpolation in (1/T, log10 P) on log10 opacity, then 10**x
    times Avogadro (optics.py:2290-2294).  The Avogadro term is folded
    into the exponent: 10**-50 underflows f32, 10**(-50 + 23.78) does not.
    """
    t_w, p_w, idx = _find_indices(opa.pt, tlayer, player_bar)
    k = opa.log_kappa[:, idx, :]                       # [nmol, 4, nlayer, nwno]
    w = corner_weights(t_w, p_w).to(k.dtype)           # [4, nlayer]
    logk = torch.einsum('mqlw,ql->mlw', k, w)
    return 10.0 ** (logk + LOG_AVO)


def nearest_continuum(opa: OpacityGrid, tlayer):
    """Continuum opacity at the nearest CIA temperature [ncont, nlayer, nwno]
    (optics.py:2296-2306; argmin takes the first of tied temperatures)."""
    it = torch.argmin(torch.abs(opa.cia_temps[None, :] - tlayer[:, None]),
                      dim=1)
    return opa.cont_opa[:, it, :]


def interp_molecular_nearest(opa: OpacityGrid, tlayer, player_bar):
    """Nearest-(T, P) molecular cross sections [nmol, nlayer, nwno]: the
    reference's default query method (``get_opacities_nearest``,
    optics.py:2310-2368; db.py:308-329 of the JAX package).  Each layer
    takes the flat grid point that minimises hypot(ln P_grid - ln P_layer,
    T_grid - T_layer) over all (T, P) pairs -- the reference's own mix of
    ln-pressure with linear temperature -- with argmin's first index on
    ties.  Plain torch, no kernel."""
    pt = opa.pt
    npt = opa.log_kappa.shape[1]
    i = torch.arange(npt, device=tlayer.device)
    off = pt.t_offset.long()
    t_index = torch.searchsorted(off, i, right=True) - 1
    T_flat = 1.0 / pt.t_inv_grid[t_index]
    p_index = i - off[t_index]
    lnP_flat = pt.p_log_grid[p_index] * float(np.log(10.0))
    d2 = ((lnP_flat[None, :] - torch.log(player_bar)[:, None]) ** 2
          + (T_flat[None, :] - tlayer[:, None]) ** 2)
    pick = torch.argmin(d2, dim=1)
    logk = opa.log_kappa[:, pick, :]
    return 10.0 ** (logk + LOG_AVO)
