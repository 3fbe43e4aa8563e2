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

The host Newton solver ``t_start`` (core.py:256-537 of the JAX package:
``climate_fluxes``, ``_pack_residual``, ``_flux_state``, ``_jacobian``,
``_apply_step``, ``TStartResult``) drives the same level fluxes from the
host, one numpy decision per line-search trial; ``run_climate`` uses the
device-resident ``fused.newton_solve`` instead.
"""

from __future__ import annotations

import dataclasses
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
           'visible_level_fluxes', 'visible_fluxes', 'climate_fluxes',
           'TStartResult', 't_start']

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


def climate_fluxes(tlevel, props: RTProps, plevel, geom: ClimateGeometry,
                   wno, dwno, gauss_wts, surf_reflect, F0PI, controls,
                   compute_reflected):
    """get_fluxes (climate.py:1687-1952): (flux_net_ir, flux_net_ir_layer,
    flux_plus_ir_top, flux_net_v, flux_net_v_layer) at tlevel [nlevel];
    the visible pair is zero unless ``compute_reflected``."""
    fni, fnil, fpit = thermal_fluxes(tlevel, props, plevel, geom, wno, dwno,
                                     gauss_wts, surf_reflect)
    if compute_reflected:
        fnv, fnvl = visible_fluxes(props, plevel, F0PI, gauss_wts,
                                   surf_reflect, controls)
    else:
        fnv = torch.zeros_like(fni)
        fnvl = torch.zeros_like(fni)
    return fni, fnil, fpit, fnv, fnvl


# ---------------------------------------------------------------------------
# the host Newton solver (t_start)
# ---------------------------------------------------------------------------

def _flux_state(temp, props, plevel, geom, wno, dwno, gauss_wts,
                surf_reflect, F0PI, controls, zones: ZoneMaps, rfaci, rfacv,
                tidal, compute_reflected, fnv_fixed=None, fnvl_fixed=None):
    """The fluxes at ``temp`` and the packed residual f_vec
    (core.py:287-308 of the JAX package).  With fixed optical properties
    the visible fluxes do not depend on temperature: Newton trials pass
    the ones of t_start's entry as ``fnv_fixed``/``fnvl_fixed``
    (the reference's carried flux_net_v, climate.py:1425-1427)."""
    fni, fnil, fpit, fnv, fnvl = climate_fluxes(
        temp, props, plevel, geom, wno, dwno, gauss_wts, surf_reflect,
        F0PI, controls, compute_reflected)
    if fnv_fixed is not None:
        fnv, fnvl = fnv_fixed, fnvl_fixed
    flux_net = rfaci * fni + rfacv * fnv + tidal
    flux_net_mid = rfaci * fnil + rfacv * fnvl + tidal
    return dict(flux_net_ir=fni, flux_net_ir_layer=fnil,
                flux_plus_ir_top=fpit, flux_net_v=fnv, flux_net_v_layer=fnvl,
                f_vec=_pack_residual(flux_net, flux_net_mid, zones))


# perturbed profiles per flux evaluation of ``_jacobian``
JAC_BATCH = 8


def _jacobian(beta, temp_old, flux_ir_old, flux_ir_layer_old,
              zones: ZoneMaps, props, plevel, geom, wno, dwno, gauss_wts,
              surf_reflect, adiabat: AdiabatGrid):
    """A[k, m] = d resid_k / d T_pert_m by finite differences, del_t =
    max(1e-4 T, 3 K), opacities held fixed (core.py:311-341 of the JAX
    package; the reference's serial re-runs, climate.py:1106-1250):
    ``JAC_BATCH`` perturbed profiles per flux evaluation, as the JAX
    ``lax.map(batch_size=8)``; the identity outside the active
    n_total x n_total block."""
    nlevel = beta.shape[0]
    n = zones.n_total
    device = beta.device
    rl = torch.as_tensor(zones.resid_level, device=device).long()
    is_level = torch.as_tensor(zones.resid_is_level, device=device).bool()
    pert = torch.as_tensor(zones.pert_levels, device=device).long()
    A = torch.eye(nlevel, dtype=beta.dtype, device=device)
    for start in range(0, n, JAC_BATCH):
        stop = min(start + JAC_BATCH, n)
        jm = pert[start:stop]
        rows = torch.arange(stop - start, device=device)
        del_t = torch.clamp(1e-4 * temp_old[jm], min=3.0)
        beta_p = beta.expand(stop - start, nlevel).clone()
        beta_p[rows, jm] = beta_p[rows, jm] + del_t
        temp_p = reconstruct_profile(beta_p, zones, plevel, adiabat)
        fni, fnil, _ = thermal_fluxes(temp_p, props, plevel, geom, wno, dwno,
                                      gauss_wts, surf_reflect)
        dlev = fni[:, rl] - flux_ir_old[rl]
        dmid = fnil[:, rl] - flux_ir_layer_old[rl]
        col = torch.where(is_level, dlev, dmid) / del_t[:, None]
        A[:n, start:stop] = col[:, :n].T
    return A


def _apply_step(beta, p_step, alam, zones: ZoneMaps, plevel, adiabat,
                tmin, tmax):
    """temp_rad = beta + alam*p on the perturbed levels, the adiabat
    re-stitch, the tmin/tmax clamp (climate.py:1364-1392; core.py:344-356
    of the JAX package)."""
    n = zones.n_total
    pert = torch.as_tensor(zones.pert_levels[:n], device=beta.device).long()
    add = torch.zeros_like(beta).index_add_(0, pert, alam * p_step[:n])
    temp = reconstruct_profile(beta + add, zones, plevel, adiabat)
    return torch.clamp(temp, tmin + 0.1, tmax - 0.1)


@dataclasses.dataclass
class TStartResult:
    temp: np.ndarray
    dtdp: np.ndarray
    converged: bool
    flux_net_ir: np.ndarray
    flux_net_v: np.ndarray
    flux_plus_ir_top: np.ndarray
    profiles: list
    iterations: int = 0
    flux_evaluations: int = 0


def t_start(temp, plevel, nstr, nofczns, props: RTProps,
            geom: ClimateGeometry, wno, dwno, gauss_wts, surf_reflect,
            F0PI, controls: toon.ScatteringControls, adiabat: AdiabatGrid,
            rfaci, rfacv, tidal, tmin, tmax, it_max=10, conv=5.0,
            x_max_mult=7.0, egp_stepmax=False, verbose=False,
            save_profiles=False) -> TStartResult:
    """Newton-Raphson T(P) solve with fixed opacities (climate.py:805-1553;
    core.py:371-537 of the JAX package), the host driving the scalar
    control flow as there: Numerical Recipes' lnsrch with the reference's
    compounding step_max, the cubic backtracking, tolf/tolx/tolmin.

    The fluxes, the Jacobian (8 perturbed profiles per evaluation), the
    profile reconstruction and the line-search trials run on the device of
    ``props`` in its dtype; numpy arguments (wno, dwno, gauss_wts,
    surf_reflect, F0PI, tidal, temp, plevel in dyn/cm^2) move there.  The
    visible fluxes are computed once at entry and carried through every
    trial (core.py:398-399 of the JAX package).  The result's
    ``iterations`` counts the Newton steps taken (the JAX package's
    ``len(profiles)`` with ``save_profiles``) and ``flux_evaluations`` the
    flux evaluations (a Jacobian batch of 8 profiles is one).
    """
    like = props.dtau
    dtype, device = like.dtype, like.device

    def t(x):
        if not torch.is_tensor(x):
            x = np.array(x, dtype=np.float64)
        return torch.as_tensor(x, dtype=dtype, device=device)

    nlevel = len(temp)
    zones = zone_maps(nstr, nofczns, nlevel)
    n_total = int(zones.n_total)
    compute_reflected = rfacv != 0.0
    plevel, wno, dwno, gauss_wts, surf_reflect, F0PI = (
        t(x) for x in (plevel, wno, dwno, gauss_wts, surf_reflect, F0PI))
    tidal_np = np.asarray(tidal, np.float64)
    tidal = t(tidal_np)
    temp = t(temp)
    n_eval = 0

    def state_at(temp, reflected, **fixed):
        nonlocal n_eval
        n_eval += 1
        return _flux_state(temp, props, plevel, geom, wno, dwno, gauss_wts,
                           surf_reflect, F0PI, controls, zones, rfaci, rfacv,
                           tidal, reflected, **fixed)

    # numerical-recipes knobs (climate.py:905-912)
    alf, tolmin, tolf, tolx = 1e-4, 1e-5, 5e-3, 5e-3
    step_max = 0.01        # compounds across iterations (climate.py:907)

    profiles = []
    state = state_at(temp, compute_reflected)
    # the visible fluxes of fixed props, carried through every trial
    fixed = dict(fnv_fixed=state['flux_net_v'],
                 fnvl_fixed=state['flux_net_v_layer'])

    converged = False
    steps = 0
    for its in range(it_max):
        f_vec = state['f_vec'].cpu().numpy().astype(np.float64)[:n_total]
        temp_old = temp.cpu().numpy().astype(np.float64)
        flux_ir_old = state['flux_net_ir']
        flux_ir_layer_old = state['flux_net_ir_layer']

        ssum = float((f_vec ** 2).sum())
        sum_1 = float((temp_old[:n_total] ** 2).sum())
        test = float(np.abs(f_vec).max())
        f = 0.5 * ssum

        if test / abs(float(tidal_np[0])) < 0.01 * tolf:
            converged = True
            break

        if egp_stepmax:
            step_max = 0.005 * max(np.sqrt(sum_1), n_total * 1.0)
        else:
            # the reference compounds step_max across Newton iterations
            # (climate.py:907, :1082); kept for trace parity
            iteration_factor = max(0.01, (it_max - its) / it_max)
            step_max = (step_max * max(np.sqrt(sum_1), n_total * 1.0)
                        * iteration_factor)

        A = _jacobian(temp, t(temp_old), flux_ir_old, flux_ir_layer_old,
                      zones, props, plevel, geom, wno, dwno, gauss_wts,
                      surf_reflect, adiabat)
        n_eval += -(-n_total // JAC_BATCH)
        A_np = A.cpu().numpy().astype(np.float64)[:n_total, :n_total]
        g = A_np.T @ f_vec
        try:
            p_step = np.linalg.solve(A_np, -f_vec)
        except np.linalg.LinAlgError:
            p_step = -f_vec / np.maximum(np.abs(np.diag(A_np)), 1e-30)

        dflux = f_vec.copy()
        norm = float(np.sqrt((p_step[2:] ** 2).sum()))
        if norm > step_max:
            p_step *= step_max / norm
            dflux = -p_step
        slope = float(g @ p_step)
        test = float(np.max(np.abs(p_step) / temp_old[:n_total]))
        alamin = tolx / test
        alam, alam2, f2 = 1.0, 0.0, f
        f_old = f
        check = False

        beta = temp  # the radiative anchor of this Newton iteration
        p_dev = torch.zeros(nlevel, dtype=dtype, device=device)
        p_dev[:n_total] = t(p_step)

        flag_converge = 0
        while flag_converge == 0:
            temp_trial = _apply_step(beta, p_dev, alam, zones, plevel,
                                     adiabat, tmin, tmax)
            state = state_at(temp_trial, False, **fixed)
            f_vec_new = state['f_vec'].cpu().numpy().astype(
                np.float64)[:n_total]
            f = 0.5 * float((f_vec_new ** 2).sum())
            tt = temp_trial.cpu().numpy().astype(np.float64)

            def _check():
                # check_convergence (climate.py:1555-1631)
                t1 = float(np.abs(f_vec_new).max())
                if t1 < tolf:
                    return 2, False
                if check:
                    den1 = max(f, 0.5 * n_total)
                    t2 = float(np.max(g * dflux / den1)) if n_total else 0.0
                    return 2, t2 < tolmin
                t3 = float(np.max(np.abs(tt[:n_total] - temp_old[:n_total])
                                  / temp_old[:n_total]))
                if t3 < tolx:
                    return 2, check
                return 1, check

            if alam < alamin:
                check = True
                flag_converge, check = _check()
            elif f <= f_old + alf * alam * slope:
                flag_converge, check = _check()
            else:
                if alam == 1.0:
                    tmplam = -slope / (2 * (f - f_old - slope))
                else:
                    rhs_1 = f - f_old - alam * slope
                    rhs_2 = f2 - f_old - alam2 * slope
                    anr = ((rhs_1 / alam ** 2 - rhs_2 / alam2 ** 2)
                           / (alam - alam2))
                    b = ((-alam2 * rhs_1 / alam ** 2
                          + alam * rhs_2 / alam2 ** 2) / (alam - alam2))
                    if anr == 0:
                        tmplam = -slope / (2.0 * b)
                    else:
                        disc = b * b - 3.0 * anr * slope
                        if disc < 0.0:
                            tmplam = 0.5 * alam
                        elif b <= 0.0:
                            tmplam = (-b + np.sqrt(disc)) / (3.0 * anr)
                        else:
                            tmplam = -slope / (b + np.sqrt(disc))
                    tmplam = min(tmplam, 0.5 * alam)
                alam2, f2 = alam, f
                alam = max(tmplam, 0.1 * alam)
            if np.isnan(tt).any():
                flag_converge = 1
                temp_trial = t(temp_old + 0.5)

        temp = temp_trial
        steps += 1
        if save_profiles:
            profiles.append(temp_old)
        if verbose:
            print(f'  t_start it {its}: Tmin/max '
                  f'{float(temp.min()):.1f}/{float(temp.max()):.1f} '
                  f'balance {float(state["f_vec"][0]) / abs(tidal_np[0]):.2e}')
        if flag_converge == 2:
            converged = True
            break

    # the visible and IR state at the result, for the returned fluxes
    state = state_at(temp, compute_reflected)
    temp_np = temp.cpu().numpy().astype(np.float64)
    p_np = plevel.cpu().numpy().astype(np.float64)
    dtdp = np.diff(np.log(temp_np)) / np.diff(np.log(p_np))

    def host(x):
        return x.cpu().numpy().astype(np.float64)

    return TStartResult(
        temp=temp_np, dtdp=dtdp, converged=converged,
        flux_net_ir=host(state['flux_net_ir_layer']),
        flux_net_v=host(state['flux_net_v_layer']),
        flux_plus_ir_top=host(state['flux_plus_ir_top']),
        profiles=profiles, iterations=steps, flux_evaluations=n_eval)
