"""Climate orchestration: profile iteration, convective-zone search, the
user entry point.

Port of the chemical-equilibrium half of ``picaso_tpu/climate/api.py``
(reference climate.py:126-330 workflows, :2542-2839 ``find_strat``,
:2926-3249 ``profile``).  The zone bookkeeping stays host Python (a few
ints per iteration); everything touching [nlayer, nwno, ngauss] arrays is
device work, through ``climate/fused.py``.

The port has no ``justdoit`` facade, so :func:`run_climate` takes a
:class:`ClimateInputs` holding what the JAX ``run_climate`` and its state
read from the facade's bundle, with the facade's defaults
(``picaso_tpu/justdoit.py:996-1018``, ``:1041-1046``, ``:1451-1472``).
Not ported yet, and raising ``NotImplementedError`` (ROADMAP Queue 1, "the
climate modes still to port"): disequilibrium chemistry, clouds (virga),
the moist adiabat, energy injection, the spectrum of the result
(``with_spec``), device meshes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import checked_device, molmass
from ..chemistry import chem_grid_from_table, chem_interp
from ..constants import PCONV
from ..opacities import assemble
from ..opacities.ck import CKTable
from ..rayleigh import RAYLEIGH_MOLECULES, rayleigh_sigma_table
from ..rt import toon
from . import core, fused
from .adiabat import did_grad_cp, load_adiabat_grid

__all__ = ['ClimateInputs', 'climate_state', 'run_climate']


@dataclasses.dataclass
class ClimateInputs:
    """What a climate run reads from the JAX facade's bundle.

    nstr = [top_of_atm, top_conv1, bot_conv1, top_rad2, top_conv2,
    bot_conv2]; the facade's ``inputs_climate`` starts from
    ``[0, rcb_guess, nlevel - 2, 0, 0, 0]`` with one zone.  ``F0PI`` is the
    bin-integrated stellar flux on the table's grid (the facade's
    ``opannection.relative_flux``); None means no star, and then rfacv is
    0 (``setup_nostar``).
    """
    t_eff: float                   # K
    gravity: float                 # cm/s^2
    pressure: np.ndarray           # [nlevel] bar, top first
    guess: np.ndarray              # [nlevel] K
    nstr: tuple
    nofczns: int = 1
    rfaci: float = 1.0
    rfacv: float = 0.0
    F0PI: Optional[np.ndarray] = None
    controls: toon.ScatteringControls = toon.ScatteringControls()
    delta_eddington: bool = True
    stream: int = 2


class _ClimateState:
    """Everything profile()/find_strat() thread through iterations."""

    def __init__(self, inputs: ClimateInputs, ck: CKTable, F0PI, tidal,
                 rfaci, rfacv, tmin, tmax, device, dtype, verbose=True,
                 counts=None):
        self.ck = ck
        self.tidal = tidal
        self.rfaci = rfaci
        self.rfacv = rfacv
        self.chem_grid = chem_grid_from_table(ck.full_abunds, device, dtype)
        self.adiabat = load_adiabat_grid(device, dtype)
        self.geom = core.make_climate_geometry(device, dtype)
        self.verbose = verbose
        self.counts = counts
        self.all_profiles = []
        self.profile = None     # the chemistry profile of the last premix

        def dev(x):
            return torch.tensor(np.asarray(x), dtype=dtype, device=device)

        species = self.chem_grid.species
        weights = tuple(molmass.molecular_weight(s) for s in species)
        # continuum pair matching on the chem species (atmsetup.py:248-277),
        # with the special H-bf / H-ff / H2- continua
        avail = ck.continuum_molecules
        pairs = [(m1, m2) for m1 in species for m2 in species
                 if m1 + m2 in avail]
        if 'H-' in species and 'H-bf' in avail:
            pairs.append(('H-', 'bf'))
        if 'H' in species and 'e-' in species and 'H-ff' in avail:
            pairs.append(('H-', 'ff'))
        if 'H2' in species and 'e-' in species and 'H2-' in avail:
            pairs.append(('H2-', ''))
        specs = tuple(assemble.classify_continuum(pairs))
        cont_indices = tuple(list(avail).index(s.name) for s in specs)
        ray_species = [s for s in species if s in RAYLEIGH_MOLECULES]
        sig = rayleigh_sigma_table(ck.wno, ray_species)
        sigma_ray = (np.stack([sig[s] for s in ray_species]) if ray_species
                     else np.zeros((0, ck.nwno)))
        self._config_base = dict(
            species=species, weights=weights, continuum_specs=specs,
            cont_indices=cont_indices,
            ray_species_rows=tuple(species.index(s) for s in ray_species),
            controls=inputs.controls,
            delta_eddington=inputs.delta_eddington, stream=inputs.stream,
            compute_reflected=(rfacv != 0.0))
        self.data = fused.ClimateData(
            plevel=dev(np.asarray(inputs.pressure, float) * PCONV),
            gravity=float(inputs.gravity), tidal=dev(tidal),
            rfaci=float(rfaci), rfacv=float(rfacv), tmin=float(tmin),
            tmax=float(tmax), F0PI=dev(F0PI), surf_reflect=dev(
                np.zeros(ck.nwno)), sigma_ray=dev(sigma_ray))

    def fused_config(self, it_max, egp_stepmax, jac_batch=None):
        self.data = self.data._replace(it_max=int(it_max),
                                       egp_stepmax=bool(egp_stepmax))
        return fused.ClimateConfig(**self._config_base, jac_batch=jac_batch)

    def premix(self, temp, pressure_bar):
        """Equilibrium-chemistry refresh at the current T(P): the profile
        as a dict of numpy columns (pressure, temperature, species)."""
        like = self.data.plevel
        abunds = chem_interp(self.chem_grid, *(
            torch.as_tensor(x, dtype=like.dtype, device=like.device)
            for x in (temp, pressure_bar))).cpu().numpy()
        profile = {'pressure': np.asarray(pressure_bar),
                   'temperature': np.asarray(temp)}
        for i, sp in enumerate(self.chem_grid.species):
            profile[sp] = abunds[:, i]
        self.profile = profile
        return profile


def profile(state: _ClimateState, nofczns, nstr, temp, pressure_bar,
            it_max, itmx, conv, convt, x_max_mult, final, jac_batch,
            save_profile=False):
    """One opacity-refresh loop around the Newton solve
    (climate.py:2926-3249): ``itmx`` profile steps, each ending in one
    host read of its results."""
    temp = np.asarray(temp, float).copy()
    egp_stepmax = bool(temp.min() <= 250)
    zones = core.zone_maps(nstr, nofczns, len(temp))
    config = state.fused_config(it_max, egp_stepmax, jac_batch)
    data = state.data
    nlevel = len(temp)

    temp_old = temp.copy()
    conv_flag = 0
    result = None
    # the cloud-stability gate (climate.py:3227) of the cloudy mode, which
    # waits: cloud-free, taudif stays 0 and the `taudif == 0.0` bypass
    # decides, as in the JAX package
    taudif, taudif_tol = 0.0, 1.0
    temp_dev = torch.as_tensor(temp, dtype=data.plevel.dtype,
                               device=data.plevel.device)
    for iii in range(itmx):
        temp_dev, _, dtdp, fnil, fnvl, fpit = fused.profile_step(
            temp_dev, zones, data, state.chem_grid, state.ck.arrays,
            state.geom, state.adiabat, config, state.counts)
        host = torch.cat([temp_dev, dtdp, fnil, fnvl, fpit]).cpu().numpy()
        temp, dtdp, fnil, fnvl, fpit = np.split(
            host.astype(np.float64),
            np.cumsum([nlevel, nlevel - 1, nlevel, nlevel]))
        if save_profile:
            state.all_profiles.append(temp.copy())

        ert = float(np.abs(temp - temp_old).sum()) / (len(temp) * 1.5)
        temp_old = temp.copy()
        if state.verbose:
            print(f' profile it {iii}: mean|dT| {ert:.3f} K (conv {convt})')
        result = (dtdp, fnil, fnvl, fpit)
        if iii > 0 and ert < convt and (taudif < taudif_tol
                                        or taudif == 0.0):
            conv_flag = 1
            break

    # refresh the chemistry at the converged structure
    state.premix(temp, pressure_bar)
    dtdp, fnil, fnvl, fpit = result
    return conv_flag, temp, dtdp, fnil, fnvl, fpit


def find_strat(state: _ClimateState, nofczns, nstr, temp, pressure_bar,
               dtdp, jac_batch, save_profile=False):
    """Convective-zone growth/merge search (climate.py:2542-2839)."""
    subad = 0.98
    ifirst = 10 - 1
    nstr = list(nstr)

    def conv_grad(temp):
        """convec (climate.py:570-608): the dry adiabatic gradient per
        layer."""
        tbar = 0.5 * (temp[1:] + temp[:-1])
        pbar = np.sqrt(pressure_bar[1:] * pressure_bar[:-1])
        like = state.data.plevel
        grad_x, _ = did_grad_cp(
            torch.as_tensor(tbar, dtype=like.dtype, device=like.device),
            torch.as_tensor(pbar, dtype=like.dtype, device=like.device),
            state.adiabat)
        return grad_x.cpu().numpy().astype(np.float64)

    args = dict(it_max=8, itmx=5, conv=5.0, convt=3.0, x_max_mult=7.0,
                final=False, jac_batch=jac_batch, save_profile=save_profile)

    # grad_x is computed ONCE at entry (reference climate.py:2647 never
    # refreshes it through the growth loops, only dtdp updates); kept for
    # zone-boundary trace parity with the reference
    grad_x = conv_grad(temp)
    while dtdp[nstr[1] - 1] >= subad * grad_x[nstr[1] - 1]:
        ratio = dtdp[nstr[1] - 1] / grad_x[nstr[1] - 1]
        nstr[1] -= 2 if ratio > 1.8 else 1
        if nstr[1] < 5:
            raise ValueError('Convection zone grew to the top of the '
                             'atmosphere; stopping')
        if state.verbose:
            print('find_strat: grow upper zone ->', nstr)
        (flag, temp, dtdp, fni, fnv, fpit) = profile(
            state, nofczns, nstr, temp, pressure_bar, **args)

    # detect a detached second zone by superadiabaticity (climate.py:2679)
    dt_max, i_max = 0.0, 0
    for i in range(nstr[1] - 1, ifirst - 1, -1):
        add = dtdp[i] - grad_x[i]
        if add > dt_max and add / grad_x[i] >= 0.02:
            dt_max, i_max = add, i
            break

    if not (i_max == 0 or dt_max / grad_x[i_max] < 0.02):
        if state.verbose:
            print('find_strat: detached zone at', i_max)
        nofczns = 2
        nstr[4], nstr[5] = nstr[1], nstr[2]
        nstr[1] = nstr[2] = nstr[3] = i_max
        if nstr[3] >= nstr[4]:
            raise ValueError('Convective-zone overlap')
        (flag, temp, dtdp, fni, fnv, fpit) = profile(
            state, nofczns, nstr, temp, pressure_bar, **args)

        i_change = 1
        while i_change == 1:
            i_change = 0
            d1, d2 = dtdp[nstr[1] - 1], dtdp[nstr[3]]
            c1, c2 = grad_x[nstr[1] - 1], grad_x[nstr[3]]
            while (d1 > subad * c1) or (d2 > subad * c2):
                if ((d1 - c1) >= (d2 - c2)) or (nofczns == 1):
                    nstr[1] -= 1
                    if nstr[1] < 3:
                        raise ValueError('Convection zone grew to the top')
                else:
                    nstr[2] += 1
                    nstr[3] += 1
                    if nstr[2] == nstr[4]:
                        nofczns = 1
                        nstr[2] = nstr[5]
                        nstr[3] = 0
                        i_change = 1
                if state.verbose:
                    print('find_strat: adjust ->', nstr)
                (flag, temp, dtdp, fni, fnv, fpit) = profile(
                    state, nofczns, nstr, temp, pressure_bar, **args)
                d1, d2 = dtdp[nstr[1] - 1], dtdp[nstr[3]]
                c1, c2 = grad_x[nstr[1] - 1], grad_x[nstr[3]]
            while (nofczns > 1
                   and dtdp[nstr[4] - 1] >= subad * grad_x[nstr[4] - 1]):
                nstr[4] -= 1
                if nstr[2] == nstr[4]:
                    nofczns = 1
                    nstr[2] = nstr[5]
                    nstr[3] = 0
                    i_change = 1
                if state.verbose:
                    print('find_strat: grow lower zone ->', nstr)
                (flag, temp, dtdp, fni, fnv, fpit) = profile(
                    state, nofczns, nstr, temp, pressure_bar, **args)

    # final strict-tolerance pass (climate.py:2798-2819)
    final_args = dict(args, it_max=10, itmx=6, conv=2.0, convt=2.0,
                      x_max_mult=3.5, final=True)
    if state.verbose:
        print('find_strat: final pass', nstr)
    (flag, temp, dtdp, fni, fnv, fpit) = profile(
        state, nofczns, nstr, temp, pressure_bar, **final_args)
    return flag, temp, dtdp, nstr, fni, fnv, fpit, state.profile


def _not_ported(name):
    raise NotImplementedError(
        f'{name} is not ported yet: ROADMAP Queue 1, "the climate modes '
        'still to port"')


def climate_state(inputs: ClimateInputs, ck: CKTable, device='cuda',
                  dtype=torch.float64, verbose=True,
                  counts=None) -> _ClimateState:
    """What a solve threads through its iterations, as :func:`run_climate`
    sets it up: the table moved to ``device`` (default ``'cuda'``; raises
    where there is none) in ``dtype`` (float64 unless asked, see
    :func:`run_climate`), the chemistry grid, the adiabat table, the
    angles, the per-run arrays (``.data``) and the static options
    (``.fused_config``)."""
    device = checked_device(device)
    ck = ck.to(device, dtype)
    teff = inputs.t_eff
    min_temp, max_temp = float(ck.temps.min()), float(ck.temps.max())
    tmin = min_temp * 0.7 if teff > 300 else 10.0
    tmax = 10000.0 if teff > 1600 else max_temp * 1.3
    if inputs.F0PI is None:     # no star (setup_nostar)
        rfacv = 0.0
        F0PI = np.zeros(ck.nwno) + 1.0
    else:
        rfacv = inputs.rfacv
        F0PI = np.asarray(inputs.F0PI, float)
    tidal = core.tidal_flux(teff, len(inputs.pressure))
    return _ClimateState(inputs, ck, F0PI, tidal, inputs.rfaci, rfacv, tmin,
                         tmax, device, dtype, verbose=verbose, counts=counts)


def run_climate(inputs: ClimateInputs, ck: CKTable, save_all_profiles=False,
                with_spec=False, diseq_chem=False, verbose=True,
                counts: fused.ClimateCounts = None, jac_batch=None,
                cloudy=False, virga_kwargs=None, moistgrad=False,
                inject_energy=False, mesh=None, device='cuda',
                dtype=torch.float64):
    """Radiative-convective equilibrium solve in chemical equilibrium
    (justdoit.climate, :4982-5281 of the reference; ``run_climate`` of the
    JAX package without its diseq, cloudy, moist, injection and
    ``with_spec`` branches, which raise here).

    Runs on ``device`` (default ``'cuda'``; raises where there is none) in
    ``dtype``, float64 on every device unless asked: the solve is bound by
    the host's dispatch, so float64 costs the card no wall time, and a
    float32 solve at 91 levels misses the float64 one by hundreds of K
    (the thin upper layers' thermal fluxes, ROADMAP Queue 3).  float32 is
    an explicit choice, as close as float64 at 41 levels.  The table is
    moved there.  ``counts``, a
    :class:`~picaso_tpu_torch.climate.fused.ClimateCounts`, is filled with
    what the solve did; ``jac_batch`` caps the Jacobian's perturbed
    profiles per flux evaluation (default None: all in one evaluation; a
    cap saves device memory and changes no number).  Returns the JAX
    package's keys; ``ptchem_df`` is a dict of numpy columns.
    """
    for name, value in (('diseq_chem', diseq_chem), ('cloudy', cloudy),
                        ('virga_kwargs', virga_kwargs),
                        ('moistgrad', moistgrad),
                        ('inject_energy', inject_energy),
                        ('with_spec', with_spec), ('mesh', mesh)):
        if value:
            _not_ported(name)
    state = climate_state(inputs, ck, device, dtype, verbose=verbose,
                          counts=counts)
    pressure = np.asarray(inputs.pressure, float)
    temp = np.asarray(inputs.guess, float).copy()
    nstr = list(inputs.nstr)
    nofczns = inputs.nofczns
    loop = dict(jac_batch=jac_batch, save_profile=save_all_profiles)

    # STEP 1: loose-tolerance profile (climate.py:270-290)
    flag, temp, dtdp, fni, fnv, fpit = profile(
        state, nofczns, nstr, temp, pressure, it_max=10, itmx=7, conv=10.0,
        convt=5.0, x_max_mult=7.0, final=False, **loop)
    # STEP 2: stricter profile
    flag, temp, dtdp, fni, fnv, fpit = profile(
        state, nofczns, nstr, temp, pressure, it_max=7, itmx=5, conv=5.0,
        convt=4.0, x_max_mult=7.0, final=False, **loop)
    # STEP 3: convective-zone search + final pass
    flag, temp, dtdp, nstr, fni, fnv, fpit, chem_df = find_strat(
        state, nofczns, nstr, temp, pressure, dtdp, **loop)

    tidal, rfaci, rfacv = state.tidal, state.rfaci, state.rfacv
    flux_net = rfacv * fnv + rfaci * fni + tidal
    out = {
        'pressure': pressure, 'temperature': temp, 'ptchem_df': chem_df,
        'dtdp': dtdp, 'cvz_locs': nstr, 'flux_ir_attop': fpit,
        'converged': flag,
        'fnet/fnetir': flux_net / np.where(fni != 0, fni, np.nan),
        'flux_balance': dict(flux_net_ir=fni, flux_net_v=fnv, tidal=tidal,
                             rfacv=rfacv, rfaci=rfaci, flux_net=flux_net),
    }
    if save_all_profiles:
        out['all_profiles'] = (np.stack(state.all_profiles)
                               if state.all_profiles
                               else np.zeros((0, len(pressure))))
    return out
