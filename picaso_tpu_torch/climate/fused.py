"""One climate profile iteration: chemistry, opacities, Newton solve.

Port of ``picaso_tpu/climate/fused.py`` (reference climate.py:805-1553
``t_start`` around the ``calculate_atm`` opacity update).  The JAX package
compiles the whole iteration to one XLA program driven by two
``lax.while_loop``s; here the device work is torch operations and the two
loops (Newton iterations, backtracking line search) are Python loops on
the host.  The host reads the loop-control scalars once per line-search
step, as one stacked tensor, and never inside a flux evaluation.

The Jacobian's perturbation columns are a batch axis of the flux
evaluation (all of them in one evaluation, or ``config.jac_batch`` at a
time, the JAX ``lax.map`` batch size): each column's arithmetic is the JAX
one, so the chunk size changes no number.  The padded columns of the JAX program
(index >= n_total, masked to the identity there) are not computed.

All reference numerics preserved, including the deliberate quirks: the
compounding non-EGP ``step_max`` (climate.py:907, :1082), the NaN rescue
(:1523-1527).  With ``config.moist`` the adiabat re-stitch follows the
moist adiabat at ``data.cond_abunds`` (held fixed through a Newton solve;
``profile_step`` refreshes it from the chemistry at the incoming
structure).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..chemistry import ChemGrid, chem_interp
from ..constants import PCONV
from ..opacities import assemble
from ..opacities.ck import CKArrays, ck_continuum, interp_premix
from ..optics import combine_optics
from ..rt import toon
from .adiabat import AdiabatGrid
from .core import (ClimateGeometry, ZoneMaps, _pack_residual,
                   reconstruct_profile, thermal_fluxes, visible_fluxes)

__all__ = ['ClimateConfig', 'ClimateData', 'ClimateCounts',
           'build_opacities', 'jacobian', 'newton_solve', 'profile_step']


@dataclasses.dataclass(frozen=True)
class ClimateConfig:
    """Static climate options (fused.py:40-63 of the JAX package)."""
    species: tuple                 # chem-grid species order
    weights: tuple                 # molecular weights (amu), same order
    continuum_specs: tuple         # assemble.ContinuumSpec list
    cont_indices: tuple            # row of cont_opa per spec
    ray_species_rows: tuple        # chem-species row per rayleigh species
    controls: toon.ScatteringControls
    delta_eddington: bool = True
    stream: int = 2
    compute_reflected: bool = True
    moist: bool = False
    condensables: tuple = ()
    cond_weights: tuple = ()
    alf: float = 1e-4
    tolmin: float = 1e-5
    tolf: float = 5e-3
    tolx: float = 5e-3
    # cap on the Jacobian's perturbation columns per flux evaluation (each
    # evaluation covers jac_batch*ngauss*nwno RT columns): None puts all
    # n_total in one evaluation; a cap saves device memory
    jac_batch: Optional[int] = None


class ClimateData(NamedTuple):
    """Per-run arrays and scalars.  The cloud arrays (None: cloud-free) are
    what ``build_opacities`` combines; the cloudy mode builds its optics on
    the host instead (``api._ClimateState.build_props_host``), as in the
    JAX package."""
    plevel: torch.Tensor           # [nlevel] dyne/cm^2
    gravity: float                 # cm/s^2
    tidal: torch.Tensor            # [nlevel]
    rfaci: float
    rfacv: float
    tmin: float
    tmax: float
    F0PI: torch.Tensor             # [nwno]
    surf_reflect: torch.Tensor     # [nwno]
    sigma_ray: torch.Tensor        # [nray, nwno]
    it_max: int = 10               # Newton-iteration cap
    egp_stepmax: bool = False      # step-max rule
    cld_opd: Optional[torch.Tensor] = None   # [nlayer, nwno]
    cld_g0: Optional[torch.Tensor] = None
    cld_w0: Optional[torch.Tensor] = None
    cond_abunds: Optional[torch.Tensor] = None  # [nlayer, ncond]: moist


@dataclasses.dataclass
class ClimateCounts:
    """What a solve did, for measurement: profile steps, Newton
    iterations, Jacobians, flux evaluations (one thermal solve each) and
    the temperature profiles those evaluations covered."""
    profile_steps: int = 0
    newton_iterations: int = 0
    jacobians: int = 0
    flux_evaluations: int = 0
    flux_profiles: int = 0


def build_opacities(temp, data: ClimateData, chem: ChemGrid, ck: CKArrays,
                    config: ClimateConfig):
    """Chemistry + opacity assembly at T(P), the calculate_atm equivalent:
    RTProps [ngauss, nlayer, nwno]."""
    plevel = data.plevel
    p_bar = plevel / PCONV
    tlayer = 0.5 * (temp[1:] + temp[:-1])
    player_bar = torch.sqrt(p_bar[1:] * p_bar[:-1])

    mix_level = chem_interp(chem, temp, p_bar)          # [nlevel, nspecies]
    w = torch.tensor(config.weights, dtype=temp.dtype, device=temp.device)
    mmw_level = mix_level @ w
    mmw_layer = 0.5 * (mmw_level[1:] + mmw_level[:-1])
    mix_layer = 0.5 * (mix_level[1:] + mix_level[:-1])  # [nlayer, nspecies]
    colden = (plevel[1:] - plevel[:-1]) / data.gravity

    nwno = ck.wno.shape[0]
    nlayer = tlayer.shape[0]
    ngauss = ck.gauss_wts.shape[0]

    kappa = interp_premix(ck, tlayer, player_bar)
    taugas = (kappa * (colden / mmw_layer)[:, None, None]).permute(2, 0, 1)

    if config.continuum_specs:
        cont = ck_continuum(ck, tlayer)
        cont_kappa = {s.name: cont[ci] for s, ci in
                      zip(config.continuum_specs, config.cont_indices)}
        coef1 = assemble.amagat_coef1(temp, p_bar, tlayer, player_bar,
                                      data.gravity, mmw_layer)
        sp_index = {s: i for i, s in enumerate(config.species)}
        zeros = torch.zeros_like(tlayer)
        mix_named = {}
        for s in config.continuum_specs:
            for m in (s.mol1, s.mol2):
                if m:
                    mix_named[m] = (mix_layer[:, sp_index[m]]
                                    if m in sp_index else zeros)
        electrons = (mix_layer[:, sp_index['e-']] if 'e-' in sp_index
                     else zeros)
        taugas = taugas + assemble.continuum_tau(
            config.continuum_specs, cont_kappa, mix_named, electrons, coef1,
            player_bar * PCONV, tlayer, colden, mmw_layer)[None]

    if config.ray_species_rows:
        mix_ray = mix_layer[:, list(config.ray_species_rows)].T
        tauray = assemble.rayleigh_tau(data.sigma_ray, mix_ray, colden,
                                       mmw_layer)
    else:
        tauray = torch.zeros((nlayer, nwno), dtype=temp.dtype,
                             device=temp.device)
    shape = (ngauss, nlayer, nwno)
    zero = torch.zeros((), dtype=temp.dtype, device=temp.device).expand(
        shape)
    opd, w0, g0 = (zero if x is None else x[None].expand(shape)
                   for x in (data.cld_opd, data.cld_w0, data.cld_g0))
    rf = torch.full(shape, 0.99999, dtype=taugas.dtype, device=temp.device)
    return combine_optics(taugas, tauray[None].expand(shape), opd, w0,
                          g0, rf, test_mode=None,
                          delta_eddington=config.delta_eddington,
                          stream=config.stream)


def _device_zones(zones: ZoneMaps, device):
    """The zone index arrays as device tensors (is_conv stays host numpy:
    the profile reconstruction loops over it)."""
    return zones._replace(
        pert_levels=torch.as_tensor(zones.pert_levels, device=device).long(),
        resid_level=torch.as_tensor(zones.resid_level, device=device).long(),
        resid_is_level=torch.as_tensor(zones.resid_is_level,
                                       device=device).bool())


def _moist_args(data: ClimateData, config: ClimateConfig):
    return ((data.cond_abunds, config.condensables, config.cond_weights)
            if config.moist else None)


def _ir_fluxes(temp, props, data, geom, ck, counts):
    if counts is not None:
        counts.flux_evaluations += 1
        counts.flux_profiles += temp.shape[0] if temp.dim() == 2 else 1
    return thermal_fluxes(temp, props, data.plevel, geom, ck.wno,
                          ck.delta_wno, ck.gauss_wts, data.surf_reflect)


def jacobian(beta, temp_old, fni_old, fnil_old, props, zones: ZoneMaps,
             data: ClimateData, geom, ck: CKArrays, adiabat: AdiabatGrid,
             config: ClimateConfig, counts=None):
    """A[k, m] = d resid_k / d T_pert_m by finite differences (del_t =
    max(1e-4 T, 3 K), opacities held fixed), all perturbed profiles in one
    flux evaluation or ``config.jac_batch`` at a time; the identity
    outside the active n_total x n_total block (fused.py:188-205 of the
    JAX package)."""
    zones = _device_zones(zones, beta.device)
    nlevel = beta.shape[0]
    n = zones.n_total
    rl = zones.resid_level
    A = torch.eye(nlevel, dtype=beta.dtype, device=beta.device)
    chunk = config.jac_batch or max(n, 1)
    for start in range(0, n, chunk):
        stop = min(start + chunk, n)
        jm = zones.pert_levels[start:stop]
        rows = torch.arange(stop - start, device=beta.device)
        del_t = torch.clamp(1e-4 * temp_old[jm], min=3.0)
        beta_p = beta.expand(stop - start, nlevel).clone()
        beta_p[rows, jm] = beta_p[rows, jm] + del_t
        temp_p = reconstruct_profile(beta_p, zones, data.plevel, adiabat,
                                     moist_args=_moist_args(data, config))
        fni, fnil, _ = _ir_fluxes(temp_p, props, data, geom, ck, counts)
        dlev = fni[:, rl] - fni_old[rl]
        dmid = fnil[:, rl] - fnil_old[rl]
        col = torch.where(zones.resid_is_level, dlev, dmid) / del_t[:, None]
        A[:n, start:stop] = col[:, :n].T
    return A


def _apply_step(beta, p_step, alam, zones: ZoneMaps, data: ClimateData,
                adiabat: AdiabatGrid, config: ClimateConfig):
    """temp_rad = beta + alam*p on the perturbed levels, the adiabat
    re-stitch, the tmin/tmax clamp (climate.py:1364-1392)."""
    n = zones.n_total
    add = torch.zeros_like(beta).index_add_(
        0, zones.pert_levels[:n], p_step[:n] * float(alam))
    t = reconstruct_profile(beta + add, zones, data.plevel, adiabat,
                            moist_args=_moist_args(data, config))
    return torch.clamp(t, data.tmin + 0.1, data.tmax - 0.1)


def _host(*scalars):
    """The device scalars as numpy float64s, in one read."""
    return [np.float64(x) for x in torch.stack(
        [s.to(torch.float64) for s in scalars]).tolist()]


def _next_lambda(alam, alam2, f, f2, f_old, slope):
    """Backtracking lambda of the cubic line search (climate.py:1486-1521),
    in IEEE arithmetic as the JAX where-chains compute it: only the branch
    taken is evaluated, divisions by zero give inf or nan."""
    with np.errstate(all='ignore'):
        if alam == 1.0:
            return -slope / (2 * (f - f_old - slope))
        rhs_1 = f - f_old - alam * slope
        rhs_2 = f2 - f_old - alam2 * slope
        denom = np.float64(1.0) if alam == alam2 else alam - alam2
        a2sq = np.float64(1.0) if alam2 == 0 else alam2 ** 2
        anr = (rhs_1 / alam ** 2 - rhs_2 / a2sq) / denom
        b = (-alam2 * rhs_1 / alam ** 2 + alam * rhs_2 / a2sq) / denom
        disc = b * b - 3.0 * anr * slope
        if anr == 0:
            later = -slope / (2.0 * b)
        elif disc < 0.0:
            later = 0.5 * alam
        elif b <= 0.0:
            later = (-b + np.sqrt(np.abs(disc))) / (3.0 * anr)
        else:
            later = -slope / (b + np.sqrt(np.abs(disc)))
        return np.minimum(later, 0.5 * alam)


def newton_solve(temp, props, zones: ZoneMaps, data: ClimateData,
                 geom: ClimateGeometry, ck: CKArrays, adiabat: AdiabatGrid,
                 config: ClimateConfig, counts: ClimateCounts = None):
    """t_start with fixed opacities: Newton-Raphson with a backtracking
    line search (fused.py:153-361 of the JAX package).

    Returns (temp, converged, flux_net_ir_layer, flux_net_v_layer,
    flux_plus_ir_top).
    """
    device, dtype = temp.device, temp.dtype
    zones = _device_zones(zones, device)
    nlevel = temp.shape[0]
    n_total = zones.n_total
    active = torch.arange(nlevel, device=device) < n_total
    k2 = (torch.arange(nlevel, device=device) >= 2) & active
    tidal0 = abs(float(data.tidal[0]))

    if config.compute_reflected:
        fnv, fnvl = visible_fluxes(props, data.plevel, data.F0PI,
                                   ck.gauss_wts, data.surf_reflect,
                                   config.controls)
    else:
        fnv = torch.zeros(nlevel, dtype=dtype, device=device)
        fnvl = torch.zeros(nlevel, dtype=dtype, device=device)

    def residual(fni, fnil):
        return _pack_residual(data.rfaci * fni + data.rfacv * fnv
                              + data.tidal,
                              data.rfaci * fnil + data.rfacv * fnvl
                              + data.tidal, zones)

    fni, fnil, fpit = _ir_fluxes(temp, props, data, geom, ck, counts)
    its, done = 0, False
    step_max_c = np.float64(0.01)
    while its < data.it_max and not done:
        if counts is not None:
            counts.newton_iterations += 1
        f_vec = residual(fni, fnil)
        temp_old = temp
        test, sum_1, f_old = _host(
            torch.max(torch.abs(f_vec)),
            torch.sum(torch.where(active, temp_old ** 2, 0.0)),
            0.5 * torch.sum(f_vec ** 2))
        if test / tidal0 < 0.01 * config.tolf:
            # at a root: the incoming state is kept
            its, done = its + 1, True
            break

        # both step-max rules; the non-EGP one COMPOUNDS across Newton
        # iterations like the reference (climate.py:907 initial 0.01,
        # :1082 `step_max *= ...`): a deliberate quirk kept for parity
        n_tot_f = np.float64(n_total)
        iteration_factor = max(np.float64(0.01),
                               (data.it_max - its) / np.float64(data.it_max))
        step_cmp = (step_max_c * max(np.sqrt(sum_1), n_tot_f)
                    * iteration_factor)
        if data.egp_stepmax:
            step_max = 0.005 * max(np.sqrt(sum_1), n_tot_f)
        else:
            step_max = step_max_c = step_cmp

        if counts is not None:
            counts.jacobians += 1
        A = jacobian(temp, temp_old, fni, fnil, props, zones, data, geom,
                     ck, adiabat, config, counts)
        g = A.T @ f_vec
        p_step = torch.linalg.solve_ex(A, -f_vec)[0]
        (norm,) = _host(torch.sqrt(torch.sum(torch.where(k2, p_step ** 2,
                                                         0.0))))
        dflux = f_vec
        if norm > step_max:
            p_step = p_step * float(step_max / norm)
            dflux = -p_step
        slope, tmax_rel = _host(
            torch.sum(g * p_step),
            torch.max(torch.where(active, torch.abs(p_step)
                                  / torch.clamp(temp_old, min=1e-30), 0.0)))
        with np.errstate(divide='ignore'):
            alamin = config.tolx / tmax_rel

        # backtracking line search (climate.py:1394-1527)
        flag, check = 0, False
        alam, alam2, f2 = np.float64(1.0), np.float64(0.0), f_old
        den_floor = 0.5 * n_total
        while flag == 0:
            t_try = _apply_step(temp_old, p_step, alam, zones, data, adiabat,
                                config)
            fni_n, fnil_n, fpit_n = _ir_fluxes(t_try, props, data, geom, ck,
                                               counts)
            f_vec_n = residual(fni_n, fnil_n)
            f_dev = 0.5 * torch.sum(f_vec_n ** 2)
            f, test1, test2, test3, has_nan = _host(
                f_dev, torch.max(torch.abs(f_vec_n)),
                torch.max(torch.where(
                    active, g * dflux / torch.clamp(f_dev, min=den_floor),
                    -math.inf)),
                torch.max(torch.where(
                    active, torch.abs(t_try - temp_old)
                    / torch.clamp(temp_old, min=1e-30), 0.0)),
                torch.isnan(t_try).any())

            small_step = alam < alamin
            decreased = f <= f_old + config.alf * alam * slope
            # check_convergence (climate.py:1555-1631)
            check_in = True if small_step else check
            if test1 < config.tolf:
                cflag, ncheck = 2, False
            elif check_in:
                cflag, ncheck = 2, bool(test2 < config.tolmin)
            else:
                cflag, ncheck = (2 if test3 < config.tolx else 1), check_in
            flag = cflag if (small_step or decreased) else 0
            if flag == 0:
                tmplam = _next_lambda(alam, alam2, f, f2, f_old, slope)
                alam2, f2 = alam, f
                alam = np.maximum(tmplam, 0.1 * alam)
            else:
                check = ncheck
            if has_nan:   # NaN rescue (climate.py:1523-1527)
                flag = 1
                t_try = temp_old + 0.5
        temp, fni, fnil, fpit = t_try, fni_n, fnil_n, fpit_n
        its += 1
        done = flag == 2
    return temp, done, fnil, fnvl, fpit


def profile_step(temp, zones: ZoneMaps, data: ClimateData, chem: ChemGrid,
                 ck: CKArrays, geom: ClimateGeometry, adiabat: AdiabatGrid,
                 config: ClimateConfig, counts: ClimateCounts = None):
    """One profile iteration: adiabat re-stitch -> chemistry -> opacities
    -> Newton solve.  Returns (temp, converged, dtdp, flux_net_ir_layer,
    flux_net_v_layer, flux_plus_ir_top)."""
    if counts is not None:
        counts.profile_steps += 1
    if config.moist:
        # the condensable abundances at the incoming structure feed the
        # moist adiabat, held fixed through the Newton solve
        # (climate.py:3038-3054)
        mix_level = chem_interp(chem, temp, data.plevel / PCONV)
        mix_layer = 0.5 * (mix_level[1:] + mix_level[:-1])
        cols = [chem.species.index(c) for c in config.condensables]
        data = data._replace(cond_abunds=mix_layer[:, cols])
    temp = reconstruct_profile(temp, zones, data.plevel, adiabat,
                               moist_args=_moist_args(data, config))
    props = build_opacities(temp, data, chem, ck, config)
    temp_new, converged, fnil, fnvl, fpit = newton_solve(
        temp, props, zones, data, geom, ck, adiabat, config, counts)
    dtdp = (torch.diff(torch.log(temp_new))
            / torch.diff(torch.log(data.plevel)))
    return temp_new, converged, dtdp, fnil, fnvl, fpit
