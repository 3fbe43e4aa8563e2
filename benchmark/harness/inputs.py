"""The raw inputs of a run, made from ``--seed``: the wavenumber grid, the
opacity table (made on the device), the CIA table, and the pool of
atmospheres the traffic draws from.  Both sides, the port and the
reference, read these and nothing the other made.

The table is the band model of picaso_tpu_torch/opacities/factory.py
(``_band_sigma_flat`` at commit d22d65a: 12 pseudo-line bands per
molecule, broadened with pressure, scaled with temperature, on a 1e-33
cm^2 floor) with the seed added to each molecule's draw, evaluated in
float32 on the device in one pass per band.
"""

from __future__ import annotations

import math
import os
import zlib

import numpy as np
import torch

from ..reference.spectrum import Atmos, Planet, Table


def constant_r_grid(wavelength_um, resolution):
    """Wavenumbers [n] (cm^-1, ascending) of a constant-resolution grid
    from the longest to the shortest wavelength: w_i = w_0 e^(i / R)."""
    w_lo = 1e4 / max(wavelength_um)
    w_hi = 1e4 / min(wavelength_um)
    n = int(math.floor(resolution * math.log(w_hi / w_lo))) + 1
    return w_lo * np.exp(np.arange(n) / resolution)


def wavenumbers(cfg):
    """The configuration's wavenumber grid; its length must be the
    ``nwno`` the file states."""
    wno = constant_r_grid(cfg['wavelength_um'], cfg['resolution'])
    if len(wno) != cfg['nwno']:
        raise ValueError(f'the grid has {len(wno)} wavenumbers, the '
                         f'configuration states {cfg["nwno"]}')
    return wno


def pt_grid(folder, cfg):
    """(temps_flat, press_flat) [npt] of the configuration's ragged grid."""
    tab = np.loadtxt(os.path.join(folder, cfg['pt_grid']), delimiter=',')
    return tab[:, 0].astype(np.float64), 10.0 ** tab[:, 1]


def band_table(molecules, wno, temps_flat, press_flat, seed, device,
               band, dtype=torch.float32):
    """log10 cross sections [nmol, npt, nwno] on ``device``, worked out
    in float32 and stored in ``dtype``."""
    dev = torch.device(device)
    out = torch.empty((len(molecules), len(temps_flat), len(wno)),
                      dtype=dtype, device=dev)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=dev)
    wno_d = f32(wno)
    press = f32(press_flat)
    broad = 1.0 + band['broadening'] * torch.log10(
        torch.clamp(press, min=1e-6) / 1e-6)
    tfac = f32(temps_flat) / 1000.0
    wmin, wmax = float(wno.min()), float(wno.max())
    n = band['bands']
    for im, mol in enumerate(molecules):
        rng = np.random.default_rng(zlib.crc32(mol.encode()) + seed)
        centers = rng.uniform(wmin, wmax, n)
        widths = rng.uniform(*band['width_fraction'], n) * (wmax - wmin)
        strengths = 10 ** rng.uniform(*band['log10_strength'], n)
        t_exp = rng.uniform(*band['t_exponent'], n)
        # the 1e-33 floor underflows float32: scale by 1e30 inside
        s = (band['floor'] * 1e30) * tfac[:, None] * torch.ones_like(
            wno_d)[None, :]
        for c, w, amp, te in zip(f32(centers), f32(widths), f32(strengths),
                                 f32(t_exp)):
            d = (wno_d[None, :] - c) / (w * broad[:, None])
            s = s + (amp * 1e30) * tfac[:, None] ** te / (1.0 + d * d)
        out[im] = torch.log10(s) - 30.0
    return out


def cia_table(continuum, wno, cia_temps, seed):
    """CIA [ncont, ntcia, nwno] float64 on the host: a smooth spectral
    shape per pair (factory.py's ``_cia_shape``) times (T / 1000 K)^0.5."""
    cont = np.zeros((len(continuum), len(cia_temps), len(wno)))
    for im, mol in enumerate(continuum):
        rng = np.random.default_rng(zlib.crc32(mol.encode()) + seed)
        shape = 10 ** (-8 + 2 * np.sin(wno / wno.max() * 6
                                       + rng.uniform(0, 3)))
        cont[im] = shape[None, :] * (np.asarray(cia_temps)[:, None]
                                     / 1000.0) ** 0.5
    return cont


def table(folder, cfg, seed, device) -> Table:
    wno = wavenumbers(cfg)
    temps_flat, press_flat = pt_grid(folder, cfg)
    mols = tuple(cfg['molecules'])
    cia_temps = np.asarray(cfg['cia_temps_K'], np.float64)
    return Table(wno=wno,
                 log_kappa=band_table(mols, wno, temps_flat, press_flat,
                                      seed, device, cfg['band_model'],
                                      getattr(torch, cfg['table_dtype'])),
                 temps_flat=temps_flat, press_flat=press_flat,
                 molecules=mols,
                 cia=cia_table(cfg['continuum'], wno, cia_temps, seed),
                 cia_temps=cia_temps, continuum=tuple(cfg['continuum']))


def planet(cfg) -> Planet:
    p = cfg['planet']
    return Planet(gravity=p['gravity_cgs'], radius=p['radius_cm'],
                  mass=p['mass_g'], rstar=cfg['star']['radius_cm'],
                  p_reference=p['p_reference_bar'])


def levels(cfg):
    lo, hi = cfg['p_bar']
    return np.logspace(math.log10(lo), math.log10(hi), cfg['levels'])


def pool(cfg, traffic, seed):
    """The traffic's pool of atmospheres [Atmos], drawn from the seed:
    T(P) = T50 (P / pivot)^exponent clipped at a floor, the molecules'
    base mixing ratios times a metallicity factor, H2 and He fixed, and a
    grey cloud deck opd = s (layer / (nlayer - 1))^power."""
    rng = np.random.default_rng([seed, 1])
    n = traffic['pool']
    prof, cld = traffic['profile'], traffic['cloud']
    t50 = rng.uniform(*prof['t50_K'], n)
    logz = rng.uniform(*traffic['log10_metallicity'], n)
    logs = rng.uniform(*cld['log10_scale'], n)
    p = levels(cfg)
    nlayer = len(p) - 1
    shape = (np.arange(nlayer) / (nlayer - 1)) ** cld['power']
    out = []
    for i in range(n):
        temp = np.clip(t50[i] * (p / prof['pivot_bar']) ** prof['exponent'],
                       prof['floor_K'], None)
        mix = tuple(cfg['fixed_mix'].items()) + tuple(
            (m, v * 10 ** logz[i]) for m, v in cfg['base_mix'].items())
        out.append(Atmos(pressure_bar=p, temperature=temp, mix=mix,
                         cloud_opd=10 ** logs[i] * shape,
                         cloud_g0=cld['g0'], cloud_w0=cld['w0']))
    return out
