"""Radiative-convective equilibrium core: fluxes, zones, profile
reconstruction.

Port of the parts of ``picaso_tpu/climate/core.py`` that the fused
chemical-equilibrium solve (``climate/fused.py``) runs (reference
climate.py:1687-1952 ``get_fluxes``, :1122-1152 the adiabat re-stitch):

* the CK gauss points, the disk angles and, in the Jacobian, the
  perturbed temperature profiles are batch axes of one flux evaluation:
  the columns of the Toon solves are (perturbation, gauss, wavenumber);
* the convective-zone bookkeeping (``zone_maps``) is host numpy, so the
  profile reconstruction loops over the convective levels alone, with the
  JAX scan's arithmetic per level, on the dry or the moist adiabat.

The host Newton solver ``t_start`` (and its ``_jacobian``, ``_apply_step``,
``_flux_state``) waits (ROADMAP Queue 1): ``run_climate`` does not use it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import disco as disco_mod
from ..optics import RTProps
from ..rt import toon
from .adiabat import AdiabatGrid, did_grad, pressure_cells
from .moist import moist_grad_from_dry

__all__ = ['SIGMA_SB', 'ClimateGeometry', 'make_climate_geometry',
           'chapman', 'tidal_flux', 'ZoneMaps', 'zone_maps',
           'reconstruct_profile', 'thermal_level_fluxes', 'thermal_fluxes',
           'visible_level_fluxes', 'visible_fluxes']

SIGMA_SB = 0.56687e-4  # value baked into climate.py:5130


class ClimateGeometry(NamedTuple):
    """Disk angles for climate fluxes (5-node half-sphere, nt=1)."""
    ubar1: torch.Tensor      # [ng, 1] thermal outgoing angles
    gweight: torch.Tensor
    tweight: torch.Tensor


def make_climate_geometry(device, dtype) -> ClimateGeometry:
    geom = disco_mod.make_geometry(0.0, num_gangle=10, num_tangle=1)
    return ClimateGeometry(*(torch.tensor(np.asarray(x), dtype=dtype,
                                          device=device)
                             for x in (geom.ubar1, geom.gweight,
                                       geom.tweight)))


def chapman(pressure, pm, hratio):
    """Chapman deposition shape exp(1 + h ln(p/pm) - (p/pm)^h)
    (fluxes.py:3732-3751); host numpy."""
    x = np.asarray(pressure, float) / pm
    return np.exp(1.0 + hratio * np.log(x) - x ** hratio)


def tidal_flux(teff, nlevel, pressure=None, colden=None, injection=None):
    """Level energy-balance sink/source profile [erg/cm^2/s]
    (fluxes.py:3671-3729): the -sigma Teff^4 internal-heat sink, plus an
    optional energy injection, a Chapman-function deposition
    (``injection['total_energy']`` erg/cm^2/s peaking at
    ``injection['press_max']`` bar, scale-height ratio
    ``injection['hratio']``) or a beam profile per level
    (``injection['beam_profile']`` with ``injection['inject_beam']``),
    normalised so that exactly total_energy crosses the column.  Host
    numpy, as in the JAX package."""
    tide = -SIGMA_SB * teff ** 4
    if not injection:
        return np.zeros(nlevel) + tide
    incr = np.zeros(nlevel)
    if injection.get('inject_beam'):
        beam = np.asarray(injection['beam_profile'], float)
        incr[2:] = -beam[2:nlevel]
        e_tot = float(np.sum(beam))
    else:
        incr[2:] = -(chapman(np.asarray(pressure)[2:],
                             injection['press_max'], injection['hratio'])
                     * np.asarray(colden)[1:nlevel - 1])
        e_tot = float(injection['total_energy'])
    cum = np.cumsum(incr)
    t_tot = cum[-1]
    return cum * e_tot / t_tot + tide - cum[-1] * e_tot / t_tot


# ---------------------------------------------------------------------------
# convective-zone index bookkeeping
# ---------------------------------------------------------------------------

class ZoneMaps(NamedTuple):
    """Index arrays derived from (nstr, nofczns), host numpy, padded to
    nlevel as in the JAX package.

    pert_levels[k]  : level perturbed for Newton column k (0 pad)
    resid_level[k]  : flux index for residual k
    resid_is_level[k]: 1 -> level net flux, 0 -> layer/midpoint net flux
    n_total         : number of active residuals/columns
    is_conv[j]      : level j follows the adiabat from level j-1
    """
    pert_levels: np.ndarray
    resid_level: np.ndarray
    resid_is_level: np.ndarray
    n_total: int
    is_conv: np.ndarray


def zone_maps(nstr, nofczns, nlevel) -> ZoneMaps:
    """ZoneMaps from the reference nstr convention: nstr = [top_of_atm,
    top_conv1, bot_conv1, top_rad2, top_conv2, bot_conv2]; residual
    packing as climate.py:1005-1052, perturbation columns as
    climate.py:1094-1115."""
    nstr = [int(i) for i in nstr]
    pert, rlev, risl = [], [], []
    # zone 1 (reaches the top of the atmosphere)
    pert += list(range(nstr[0], nstr[1] + 1))
    rlev += [nstr[0]] + list(range(nstr[0], nstr[1]))
    risl += [True] + [False] * (nstr[1] - nstr[0])
    if nofczns == 2:
        pert += list(range(nstr[3] + 1, nstr[4] + 1))
        rlev += list(range(nstr[3], nstr[4]))
        risl += [False] * (nstr[4] - nstr[3])
    n_total = len(pert)

    is_conv = np.zeros(nlevel, bool)
    is_conv[nstr[1] + 1: nstr[2] + 2] = True
    if nofczns == 2:
        is_conv[nstr[4] + 1: nstr[5] + 2] = True

    def pad(x, fill):
        out = np.full(nlevel, fill, np.int32)
        out[:len(x)] = x
        return out

    return ZoneMaps(pert_levels=pad(pert, 0), resid_level=pad(rlev, 0),
                    resid_is_level=pad(np.asarray(risl, np.int32), 0),
                    n_total=n_total, is_conv=is_conv)


def reconstruct_profile(beta, zones: ZoneMaps, plevel, adiabat: AdiabatGrid,
                        pconv=1e6, moist_args=None):
    """Radiative levels take beta; convective levels follow the adiabat:
    t[j] = exp(ln t[j-1] + grad(t[j-1], sqrt(p[j-1] p[j])) dlnp)
    (climate.py:1122-1152).

    beta is [nlevel] or [P, nlevel] (P profiles at once).  The JAX scan
    visits every level and selects; the levels outside the zones keep
    beta there, so this loops over the convective levels alone, with the
    scan's arithmetic at each.  With ``moist_args = (cond_abunds [nlayer,
    ncond], condensables, weights)`` the gradient is the moist adiabat at
    the layer's condensable row (climate.py:1147-1150).
    """
    p_bar = plevel / pconv
    p_mid = torch.sqrt(p_bar[:-1] * p_bar[1:])
    dlnp = torch.log(p_bar[1:]) - torch.log(p_bar[:-1])
    # per-layer views, taken once (each index would be a dispatch)
    pos_p, factkp = (x.unbind(0) for x in pressure_cells(p_mid, adiabat))
    dlnp = dlnp.unbind(0)
    if moist_args is not None:
        cond_abunds, condensables, weights = moist_args
        cond_rows = cond_abunds.unbind(0)
    t = beta.reshape(-1, beta.shape[-1]).clone()
    cols = t.T.unbind(0)
    for j in np.flatnonzero(zones.is_conv[1:]) + 1:
        t_prev = cols[j - 1]
        grad_x = did_grad(t_prev, (pos_p[j - 1], factkp[j - 1]), adiabat)
        if moist_args is not None:
            grad_x = moist_grad_from_dry(t_prev, grad_x, cond_rows[j - 1],
                                         condensables, weights)
        cols[j].copy_(torch.exp(torch.log(t_prev) + grad_x * dlnp[j - 1]))
    return t.reshape(beta.shape)


# ---------------------------------------------------------------------------
# climate fluxes
# ---------------------------------------------------------------------------

def _columns(x):
    """[ngauss, nlayer, nwno] -> [nlayer, 1, ngauss, nwno]: one optics
    array shared by every perturbed profile of a flux evaluation."""
    return x.permute(1, 0, 2)[:, None]


def thermal_level_fluxes(tlevel, props: RTProps, plevel,
                         geom: ClimateGeometry, wno, dwno, gauss_wts,
                         surf_reflect):
    """The level and midpoint thermal fluxes of tlevel [P, nlevel]:
    (F+, F-, F+ midpoint, F- midpoint), each [nlevel, P, nwno], weight-
    summed over the gauss points and disk-compressed (climate.py:1873-1938;
    the JAX package's order of sums).

    One level-flux solve covers every (profile, gauss point, wavenumber)
    column, with the bin-integrated blackbody sources (calc_type=1).
    """
    nprof, nlevel = tlevel.shape
    nwno = wno.shape[0]
    all_b = toon.blackbody_integrated(tlevel.reshape(-1), wno, dwno).to(
        props.dtau_og.dtype).reshape(nprof, nlevel, nwno)
    all_b = all_b.permute(1, 0, 2)[:, :, None, :]     # [nlevel, P, 1, nwno]
    dtau = _columns(props.dtau_og)
    tau_top = dtau[0] * plevel[0] / (plevel[1] - plevel[0])
    lvl = toon.thermal_levels(all_b, dtau, _columns(props.w0_no_raman),
                              _columns(props.cosb_og), tau_top, surf_reflect,
                              geom.ubar1)
    # weight-sum the gauss axis: [ng, nt, nlevel, P, ngauss, nwno]
    w = gauss_wts[:, None]
    return tuple(disco_mod.compress_thermal((x * w).sum(-2), geom.gweight,
                                            geom.tweight)
                 for x in (lvl.plus, lvl.minus, lvl.plus_mdpt,
                           lvl.minus_mdpt))


def thermal_fluxes(tlevel, props: RTProps, plevel, geom: ClimateGeometry,
                   wno, dwno, gauss_wts, surf_reflect):
    """IR net fluxes: (flux_net_ir [P, nlevel], flux_net_ir_layer
    [P, nlevel], flux_plus_ir_top [P, nwno]) for tlevel [P, nlevel] (or
    [nlevel], and then without the P axis): the level fluxes of
    :func:`thermal_level_fluxes`, differenced and summed over the bins
    with dwni (climate.py:1939-1942)."""
    batched = tlevel.dim() == 2
    fp, fm, fpm, fmm = thermal_level_fluxes(
        tlevel if batched else tlevel[None], props, plevel, geom, wno, dwno,
        gauss_wts, surf_reflect)
    flux_net_ir = ((fp - fm) * dwno).sum(-1).T
    flux_net_ir_layer = ((fpm - fmm) * dwno).sum(-1).T
    flux_plus_ir_top = fp[0] * dwno
    if not batched:
        return flux_net_ir[0], flux_net_ir_layer[0], flux_plus_ir_top[0]
    return flux_net_ir, flux_net_ir_layer, flux_plus_ir_top


def _visible_levels(props: RTProps, F0PI, surf_reflect, controls):
    """The reflected FluxSet at the climate angle ubar0 = ubar1 = 0.5, each
    [1, 1, nlevel, ngauss, nwno]: one solve covers every (gauss point,
    wavenumber) column."""
    ubar = torch.full((1, 1), 0.5, dtype=props.dtau.dtype,
                      device=props.dtau.device)
    cols = [p.permute(1, 0, 2) for p in (
        props.dtau, props.tau, props.w0, props.cosb, props.gcos2,
        props.ftau_cld, props.ftau_ray, props.dtau_og, props.tau_og,
        props.w0_og, props.cosb_og)]
    return toon.reflected_1d(*cols, surf_reflect, ubar, ubar, 1.0, F0PI,
                             controls=controls, get_lvl_flux=True)


def visible_level_fluxes(props: RTProps, plevel, F0PI, gauss_wts,
                         surf_reflect, controls: toon.ScatteringControls):
    """The level and midpoint reflected fluxes (climate.py:1795-1868):
    (F+, F-, F+ midpoint, F- midpoint), each [nlevel, nwno], weight-summed
    over the gauss points."""
    lvl = _visible_levels(props, F0PI, surf_reflect, controls)
    w = gauss_wts[:, None]
    return tuple((x * w).sum(-2)[0, 0] for x in (
        lvl.plus, lvl.minus, lvl.plus_mdpt, lvl.minus_mdpt))


def visible_fluxes(props: RTProps, plevel, F0PI, gauss_wts, surf_reflect,
                   controls: toon.ScatteringControls):
    """Reflected net fluxes (flux_net_v [nlevel], flux_net_v_layer
    [nlevel]) summed over the bins WITHOUT dwni, because the climate
    stellar flux is already bin-integrated (justdoit.py:1843-1879); the
    JAX package's order: difference, gauss sum, bin sum."""
    lvl = _visible_levels(props, F0PI, surf_reflect, controls)
    w = gauss_wts[:, None]
    net_layer = ((lvl.plus_mdpt - lvl.minus_mdpt) * w).sum(-2)[0, 0].sum(-1)
    net_level = ((lvl.plus - lvl.minus) * w).sum(-2)[0, 0].sum(-1)
    return net_level, net_layer


def _pack_residual(flux_net, flux_net_midpt, zones: ZoneMaps):
    """f_vec [..., nlevel] (zero-padded) per the reference packing
    (climate.py:1005-1052)."""
    device = flux_net.device
    rl = torch.as_tensor(zones.resid_level, device=device).long()
    is_level = torch.as_tensor(zones.resid_is_level, device=device).bool()
    lev = flux_net[..., rl]
    mid = flux_net_midpt[..., rl]
    vals = torch.where(is_level, lev, mid)
    k = torch.arange(vals.shape[-1], device=device)
    return torch.where(k < zones.n_total, vals, torch.zeros_like(vals))
