"""The molecular opacity gather and the continuum on the benchmark's raw
table: the ragged (T, P) grid as two flat lists, the log10 cross sections
[nmol, npt, nwno].

The bracketing follows picaso_tpu_torch/opacities/db.py at commit d22d65a
(reference picaso optics.py:2048-2123): bilinear in (1/T, log10 P) on
log10 opacity, temperatures clamped to the grid's edges, the low pressure
index held to ``nc_p[t_hi] - 3`` on the ragged grid; the continuum takes
the nearest CIA temperature.  The grid's axes are derived here from the
flat lists, not taken from the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .constants import AVOGADRO

LOG_AVO = float(np.log10(AVOGADRO))


class RaggedGrid(NamedTuple):
    """The axes of a ragged (T, P) grid, derived from its flat lists."""
    temps: np.ndarray       # [ntemp] ascending
    t_offset: np.ndarray    # [ntemp] first flat row of each temperature
    nc_p: np.ndarray        # [ntemp] pressures per temperature
    p_log: np.ndarray       # [npress] log10 P(bar) of the longest row


def ragged_grid(temps_flat, press_flat) -> RaggedGrid:
    """Axes of the grid whose rows are (temps_flat[i], press_flat[i]),
    grouped by temperature in ascending order, each group's pressures on
    one shared log ladder."""
    temps_flat = np.asarray(temps_flat, np.float64)
    temps, t_offset, nc_p = np.unique(temps_flat, return_index=True,
                                      return_counts=True)
    imax = int(np.argmax(nc_p))
    row = press_flat[t_offset[imax]:t_offset[imax] + nc_p[imax]]
    return RaggedGrid(temps, t_offset.astype(np.int64),
                      nc_p.astype(np.int64), np.log10(row))


def bracket(grid: RaggedGrid, tlayer, player_bar):
    """(t_w [nlayer], p_w [nlayer], idx [4, nlayer]) in numpy float64: the
    flat rows of the corners (t_lo, p_lo), (t_hi, p_lo), (t_hi, p_hi),
    (t_lo, p_hi) and the weights of the bilinear blend."""
    t_inv = 1.0 / np.asarray(tlayer, np.float64)
    p_log = np.log10(np.asarray(player_bar, np.float64))
    tg = 1.0 / grid.temps                      # descending
    ntemp = len(tg)
    below = tg[None, :] > t_inv[:, None]
    t_lo = np.where(below.any(1), ntemp - 1 - np.argmax(below[:, ::-1], 1),
                    0)
    t_lo = np.minimum(t_lo, ntemp - 2)
    t_hi = t_lo + 1
    le = grid.p_log[None, :] <= p_log[:, None]
    npress = len(grid.p_log)
    last_le = np.where(le.any(1), npress - 1 - np.argmax(le[:, ::-1], 1), 0)
    p_lo = np.maximum(np.minimum(last_le, grid.nc_p[t_hi] - 3), 0)
    p_hi = p_lo + 1
    t_w = (t_inv - tg[t_lo]) / (tg[t_hi] - tg[t_lo])
    p_w = (p_log - grid.p_log[p_lo]) / (grid.p_log[p_hi] - grid.p_log[p_lo])
    off = grid.t_offset
    idx = np.stack([off[t_lo] + p_lo, off[t_hi] + p_lo, off[t_hi] + p_hi,
                    off[t_lo] + p_hi])
    return t_w, p_w, idx


def corner_weights(t_w, p_w):
    """[4, nlayer] bilinear weights in the corner order of :func:`bracket`."""
    return np.stack([(1 - t_w) * (1 - p_w), t_w * (1 - p_w), t_w * p_w,
                     (1 - t_w) * p_w])


def cross_sections(log_kappa, idx, weights, cols, dtype, store=None):
    """Avogadro-scaled cross sections [nmol, nlayer, ncols] of every
    molecule of the table at every layer, on the wavenumber columns
    ``cols`` (a slice).  ``store``: a dtype the gathered rows are rounded
    to first (the control's lower precision)."""
    dev = log_kappa.device
    rows = log_kappa[:, torch.as_tensor(idx, device=dev), cols]
    if store is not None:
        rows = rows.to(store)
    rows = rows.to(dtype)                              # [nmol, 4, nlayer, nc]
    w = torch.as_tensor(weights, dtype=dtype, device=dev)
    logk = (rows * w[None, :, :, None]).sum(dim=1)
    return 10.0 ** (logk + LOG_AVO)


def nearest_temperature(cia_temps, tlayer):
    """Index of the nearest CIA temperature per layer (argmin's first on
    ties)."""
    return np.argmin(np.abs(np.asarray(cia_temps)[None, :]
                            - np.asarray(tlayer)[:, None]), axis=1)
