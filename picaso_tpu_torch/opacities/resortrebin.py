"""On-the-fly correlated-k gas mixing by resort-rebin (Amundsen 2017).

Port of ``picaso_tpu/opacities/resortrebin.py`` (reference
``deq_chem.py:273-598``): the per-molecule CK tables are mixed at the 4
(T, P) grid neighbours of each layer by pairwise resort-rebin -- the outer
product of the two gases' g-points weighted by their VMRs, the mixed k's
sorted, the cumulative weight distribution rebinned onto the g-point
quadrature -- then bilinearly ln-interpolated to the layer (T, P).

Plain torch on the table's device: the mix runs over (layer, neighbour,
wavenumber) at once, one pairwise step per gas.  The JAX package has no
Pallas kernel here.  Two details keep the JAX numbers: the sort of each
Nk^2 row is stable (``jnp.argsort``'s default; equal mixed k's keep their
order, and with it their weights' cumulative sum), and ``jnp.interp`` is
written out with ``torch.searchsorted`` as JAX computes it (a right-side
search clipped to [1, n - 1], the flat ends).

:func:`load_per_gas_tables` reads the per-gas ``<mol>_1460.hdf5`` files
(h5py, imported where it runs) into numpy, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from .ck import AVOGADRO, _neighbours

__all__ = ['interp_rows', 'mix_2_gases', 'mix_gases_at_neighbours',
           'resortrebin_kappa', 'synthetic_per_gas_tables',
           'load_per_gas_tables']


def interp_rows(x, xp, fp):
    """``jnp.interp(x, xp[r], fp[r])`` for every row r: x [n], xp and fp
    [R, m] (each xp row ascending) -> [R, n]; flat outside each row."""
    nrow, m = xp.shape
    xq = x.expand(nrow, x.shape[0]).contiguous()
    i = torch.clamp(torch.searchsorted(xp.contiguous(), xq, right=True), 1,
                    m - 1)
    x0, x1 = xp.gather(1, i - 1), xp.gather(1, i)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    df = f1 - f0
    dx = x1 - x0
    delta = xq - x0
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f0,
                    f0 + (delta / torch.where(dx0, torch.ones_like(dx), dx))
                    * df)
    f = torch.where(xq < xp[:, :1], fp[:, :1], f)
    return torch.where(xq > xp[:, -1:], fp[:, -1:], f)


def mix_2_gases(k1, k2, mix1, mix2, gauss_pts, gauss_wts):
    """Resort-rebin two gases' k-coefficients (deq_chem.py:538-598).

    k1, k2: [..., Nk] linear k-coefficients; mix1, mix2 broadcastable
    VMRs [...].  Returns (kmix [..., Nk], mix_total).
    """
    mix_t = mix1 + mix2
    Nk = gauss_wts.shape[0]
    lead = k1.shape[:-1]
    kmix = ((mix1[..., None, None] * k1[..., :, None]
             + mix2[..., None, None] * k2[..., None, :])
            / mix_t[..., None, None]).reshape(*lead, Nk * Nk)
    wts = (gauss_wts[:, None] * gauss_wts[None, :]).reshape(-1)
    kmix_sort, order = torch.sort(kmix, dim=-1, stable=True)
    wts_sort = wts[order]
    csum = torch.cumsum(wts_sort, dim=-1)
    x = csum / csum[..., -1:]
    logk = torch.log10(torch.clamp(kmix_sort, min=1e-300))
    kmix_bin = torch.pow(10.0, interp_rows(
        gauss_pts, x.reshape(-1, Nk * Nk), logk.reshape(-1, Nk * Nk)
    )).reshape(*lead, Nk)
    return kmix_bin, mix_t


def mix_gases_at_neighbours(ln_kappas, mixes, gauss_pts, gauss_wts):
    """Mix all gases: ln_kappas [ngas, ..., Nk], mixes [ngas, ...].

    Sequential pairwise mixing as do_mixing_mono_gasesfly
    (deq_chem.py:387-481).  Returns ln of the mixed k-coefficients.
    """
    kmix = torch.exp(ln_kappas[0])
    mix_t = mixes[0]
    for i in range(1, ln_kappas.shape[0]):
        kmix, mix_t = mix_2_gases(kmix, torch.exp(ln_kappas[i]), mix_t,
                                  mixes[i], gauss_pts, gauss_wts)
    return torch.log(torch.clamp(kmix, min=1e-300))


def resortrebin_kappa(ln_kappa_gases, t_inv_grid, p_log_grid, nc_p,
                      gauss_pts, gauss_wts, mixes, tlayer, player_bar):
    """Mixed molecular opacity [nlayer, nwno, Nk] x Avogadro.

    ln_kappa_gases: [ngas, npress, ntemp, nwno, Nk] per-gas CK tables;
    mixes: [ngas, nlayer] VMR profiles; every tensor on one device.
    Mixing happens at the 4 (T, P) neighbours of every layer, then
    bilinear interpolation on ln kappa (optics.py:1164-1197).  The largest
    intermediate is [nlayer, 4, nwno, Nk^2]: 122 MB in float64 at 90
    layers and 661 bins.
    """
    t_low, t_hi, p_low, p_hi, t_w, p_w = _neighbours(
        t_inv_grid, p_log_grid, nc_p, tlayer, player_bar)

    # the four neighbour columns: [ngas, nlayer, 4, nwno, Nk]
    pidx = torch.stack([p_low, p_low, p_hi, p_hi], 1)     # [nlayer, 4]
    tidx = torch.stack([t_low, t_hi, t_hi, t_low], 1)
    k_nb = ln_kappa_gases[:, pidx, tidx]

    mixes_b = mixes[:, :, None, None].expand(k_nb.shape[:-1])
    ln_mixed = mix_gases_at_neighbours(k_nb, mixes_b, gauss_pts,
                                       gauss_wts)         # [nlayer,4,nw,Nk]

    tw = t_w[:, None, None]
    pw = p_w[:, None, None]
    ln_k = ((1 - tw) * (1 - pw) * ln_mixed[:, 0]
            + tw * (1 - pw) * ln_mixed[:, 1]
            + tw * pw * ln_mixed[:, 2]
            + (1 - tw) * pw * ln_mixed[:, 3])
    return torch.exp(ln_k) * AVOGADRO


def synthetic_per_gas_tables(wno, molecules=('H2O', 'CH4', 'CO', 'NH3'),
                             ntemp=8, npress=6, seed=11, dtype=np.float32):
    """Per-gas ln-k tables [ngas, npress, ntemp, nwno, 8] (numpy) for
    tests, and their grid (resortrebin.py:102-122 of the JAX package)."""
    from .ck import double_gauss_points
    from .factory import default_pt_grid, synthetic_cross_sections

    temps, pressures = default_pt_grid(ntemp, npress)
    gauss_pts, gauss_wts = double_gauss_points()
    Nk = len(gauss_pts)
    out = np.zeros((len(molecules), npress, ntemp, len(wno), Nk), dtype)
    spread = np.linspace(-1.0, 2.0, Nk)
    for ig, mol in enumerate(molecules):
        sigma = synthetic_cross_sections(mol, np.asarray(wno), temps,
                                         pressures, seed=seed)
        base = np.log(np.maximum(sigma, 1e-50)).transpose(1, 0, 2)
        out[ig] = (base[..., None] + spread[None, None, None, :])
    meta = dict(temps=temps, pressures=pressures, gauss_pts=gauss_pts,
                gauss_wts=gauss_wts)
    return out, meta


def load_per_gas_tables(path, preload_gases, dtype=np.float32):
    """Read the per-gas ``<mol>_1460.hdf5`` CK files in ``path``
    (resortrebin.py:123-145 of the JAX package; opacity_factory.py:2280):
    (ln-k tables [ngas, npress, ntemp, nwno, Nk] in numpy ``dtype`` for
    the gases of ``preload_gases`` that have a file, in that order; the
    grid of the first: wno, delta_wno, pressures, temps, gauss_pts,
    gauss_wts, nc_p)."""
    import os

    import h5py

    kappas, meta = [], None
    for mol in preload_gases:
        fn = os.path.join(path, f'{mol}_1460.hdf5')
        if not os.path.exists(fn):
            continue
        with h5py.File(fn, 'r') as f:
            kappas.append(np.asarray(f['kcoeffs'], dtype))
            if meta is None:
                meta = dict(
                    wno=f['wno'][:], delta_wno=f['delta_wno'][:],
                    pressures=np.unique(f['pressures'][:]),
                    temps=np.unique(f['temperatures'][:]),
                    gauss_pts=f['gauss_pts'][:],
                    gauss_wts=f['gauss_wts'][:],
                    nc_p=np.asarray(f['nc_p'][:], int))
    if not kappas:
        raise FileNotFoundError(f'no per-gas CK tables found in {path}')
    return np.stack(kappas), meta
