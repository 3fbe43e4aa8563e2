"""Climate orchestration: profile iteration, convective-zone search, the
user entry point.

Port of ``picaso_tpu/climate/api.py`` (reference climate.py:126-330
workflows, :2542-2839 ``find_strat``, :2926-3249 ``profile``) in every
mode: chemical equilibrium, disequilibrium chemistry (self-consistent Kzz,
Zahnle & Marley quenching, resort-rebin mixing of per-gas CK tables, or
photochemical kinetics through the front door's ``pc``), virga clouds in
the loop, the moist adiabat, energy injection, the spectrum of the result
(``with_spec``), and any of them over a device mesh (``mesh=``,
``parallel.shard_climate_state``).  The zone
bookkeeping stays host Python (a few ints per iteration); everything
touching [nlayer, nwno, ngauss] arrays is device work, through
``climate/fused.py``.

The equilibrium solve runs one ``fused.profile_step`` per profile
iteration.  Diseq and cloudy runs take the host-assembled path, as in the
JAX package: each iteration re-stitches the adiabat, runs the chemistry,
Kzz, the quench levels and virga on the host, builds the optics on the
device (``ck_rtprops``: resort-rebin or premixed molecular opacity,
continuum, Rayleigh, the clouds) and runs the Newton solve there.

:func:`run_climate` takes a :class:`ClimateInputs` holding what the JAX
``run_climate`` and its state read from the facade's bundle, with the
facade's defaults (``picaso_tpu/justdoit.py:996-1018``, ``:1041-1046``,
``:1451-1472``); ``justdoit.inputs.climate`` builds one from its bundle.
The JAX state writes the adjusted chemistry and the Kzz back into the
bundle; here they come back in the output (``ptchem_df``, ``kzz``) and the
facade writes them back.  The kinetics branch (a ``pc`` in the bundle's
``inputs['climate']``) hands the quench-adjusted profile to the bundle's
``premix_atmosphere_photochem`` each host iteration, as the JAX package
does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import chemistry, checked_device, molmass
from ..atmosphere import build_atmosphere
from ..chemistry import chem_grid_from_table, chem_interp
from ..constants import PCONV
from ..opacities import assemble
from ..opacities.ck import CKTable, ck_taugas, interp_premix
from ..optics import combine_optics
from ..rayleigh import RAYLEIGH_MOLECULES, rayleigh_sigma_table
from ..rt import toon
from . import core, fused
from .adiabat import did_grad_cp, load_adiabat_grid
from .moist import COND_CONSTANTS, moist_grad

__all__ = ['ClimateInputs', 'climate_state', 'run_climate', 'ck_rtprops']


@dataclasses.dataclass
class ClimateInputs:
    """What a climate run reads from the JAX facade's bundle.

    nstr = [top_of_atm, top_conv1, bot_conv1, top_rad2, top_conv2,
    bot_conv2]; the facade's ``inputs_climate`` starts from
    ``[0, rcb_guess, nlevel - 2, 0, 0, 0]`` with one zone.  ``F0PI`` is the
    bin-integrated stellar flux on the table's grid (the facade's
    ``opannection.relative_flux``); None means no star, and then rfacv is
    0 (``setup_nostar``).

    The modes' fields: ``chem_params`` (the facade's
    ``approx['chem_params']``: 'vol_rainout', 'cold_trap'), ``kzz`` (the
    Kzz profile [cm^2/s] the facade's ``find_kzz`` gives at the start,
    used until a self-consistent one exists; None: 1e9), ``cloudy`` and
    ``virga_kwargs`` (virga in the loop), ``moistgrad`` (the moist
    adiabat), ``injection`` (energy injection, ``core.tidal_flux``'s
    dict: total_energy, press_max, hratio, inject_beam, beam_profile) and
    ``p_reference`` (bar, the host path's atmosphere).
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
    chem_params: dict = dataclasses.field(default_factory=dict)
    kzz: Optional[np.ndarray] = None
    cloudy: bool = False
    virga_kwargs: Optional[dict] = None
    moistgrad: bool = False
    injection: Optional[dict] = None
    p_reference: float = 1.0


def ck_rtprops(profile_df, ck: CKTable, gravity, p_reference=1.0,
               delta_eddington=True, stream=2, cld=None,
               molecular_kappa_fn=None):
    """Atmosphere + CK table -> RTProps [ngauss, nlayer, nwno] on the
    table's device in its dtype (api.py:32-109 of the JAX package).

    The climate analog of calculate_atm (climate.py:1969-2134): premixed
    molecular kappa (no mixing-ratio weighting, optics.py:257-262), or
    ``molecular_kappa_fn(atm)`` (resort-rebin), + CIA continuum +
    Rayleigh + optional clouds (``cld``: flat opd/g0/w0 columns on the
    table's grid), fused by combine_optics.  Returns (props, atm).
    """
    a = ck.arrays
    dtype, device = a.ln_kappa.dtype, a.ln_kappa.device

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    wno = np.asarray(ck.wno)
    nwno = len(wno)
    atm = build_atmosphere(profile_df, gravity=gravity,
                           p_reference=p_reference, wno=wno,
                           cld_profile=cld,
                           cld_wno=None if cld is None else wno)
    nlayer = atm.nlayer
    kappa = (molecular_kappa_fn(atm) if molecular_kappa_fn is not None
             else interp_premix(a, t(atm.t_layer), t(atm.p_layer / PCONV)))
    taugas = ck_taugas(ck, atm, kappa=kappa)

    ray_species = atm.rayleigh_species(RAYLEIGH_MOLECULES)
    if ray_species:
        sig = rayleigh_sigma_table(wno, ray_species)
        tauray = assemble.rayleigh_tau(
            t(np.stack([sig[m] for m in ray_species])),
            t(np.stack([atm.mixing_ratio_layer(m) for m in ray_species])),
            t(atm.colden), t(atm.mmw_layer))
    else:
        tauray = t(np.zeros((nlayer, nwno)))
    shape = (ck.ngauss, nlayer, nwno)
    zeros = np.zeros((nlayer, nwno))
    opd, g0, w0 = (t(x if x is not None else zeros)[None].expand(shape)
                   for x in (atm.cld_opd, atm.cld_g0, atm.cld_w0))
    rf = torch.full(shape, 0.99999, dtype=dtype, device=device)
    props = combine_optics(taugas, tauray[None].expand(shape), opd, w0, g0,
                           rf, test_mode=None,
                           delta_eddington=delta_eddington, stream=stream)
    return props, atm


class _ClimateState:
    """Everything profile()/find_strat() thread through iterations."""

    def __init__(self, inputs: ClimateInputs, ck: CKTable, F0PI, tidal,
                 rfaci, rfacv, tmin, tmax, device, dtype, verbose=True,
                 counts=None):
        self.inputs = inputs
        self.ck = ck
        self.tidal = tidal
        self.rfaci = rfaci
        self.rfacv = rfacv
        self.gravity = float(inputs.gravity)
        self.chem_grid = chem_grid_from_table(ck.full_abunds, device, dtype)
        self.adiabat = load_adiabat_grid(device, dtype)
        self.geom = core.make_climate_geometry(device, dtype)
        self.verbose = verbose
        self.counts = counts
        # the front door's case (run_climate's bundle=): its 'pc' drives
        # photochemical kinetics in update_diseq_chem
        self.bundle = None
        self.all_profiles = []
        self.profile = None     # the chemistry profile of the last refresh
        # host-driven workflow flags (set by run_climate)
        self.diseq = False
        self.cloudy = False
        self.self_consistent_kzz = True
        self.virga_kwargs = {}
        self.last_fluxes = None
        self.last_nstr = list(inputs.nstr)
        self.sc_kzz = None          # the facade's kzz['sc_kzz']
        self.quench = None          # the last quench levels
        # 4-deep cloud OPD/W0/G0 history (climate.py:2882-2915): the RT
        # sees the equal-weight average of the last 4 virga results and
        # the taudif gate compares consecutive averages
        self.cld_hist = None
        self.last_taudif = 0.0
        self.last_taudif_tol = 1.0

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
        nlayer = len(inputs.pressure) - 1
        moist = inputs.moistgrad
        condensables = (tuple(c for c in species if c in COND_CONSTANTS)
                        if moist else ())
        self.condensables = condensables
        self.moist = bool(moist and condensables)
        self._config_base = dict(
            species=species, weights=weights, continuum_specs=specs,
            cont_indices=cont_indices,
            ray_species_rows=tuple(species.index(s) for s in ray_species),
            controls=inputs.controls,
            delta_eddington=inputs.delta_eddington, stream=inputs.stream,
            compute_reflected=(rfacv != 0.0), moist=self.moist,
            condensables=condensables,
            cond_weights=tuple(molmass.molecular_weight(c)
                               for c in condensables))
        self.data = fused.ClimateData(
            plevel=dev(np.asarray(inputs.pressure, float) * PCONV),
            gravity=self.gravity, tidal=dev(tidal),
            rfaci=float(rfaci), rfacv=float(rfacv), tmin=float(tmin),
            tmax=float(tmax), F0PI=dev(F0PI), surf_reflect=dev(
                np.zeros(ck.nwno)), sigma_ray=dev(sigma_ray),
            cond_abunds=dev(np.zeros((nlayer, max(len(condensables), 1)))))

    def fused_config(self, it_max, egp_stepmax, jac_batch=None):
        self.data = self.data._replace(it_max=int(it_max),
                                       egp_stepmax=bool(egp_stepmax))
        return fused.ClimateConfig(**self._config_base, jac_batch=jac_batch)

    def _tensor(self, x):
        like = self.data.plevel
        return torch.tensor(np.asarray(x), dtype=like.dtype,
                            device=like.device)

    def premix(self, temp, pressure_bar):
        """Equilibrium-chemistry refresh at the current T(P): the profile
        as a dict of numpy columns (pressure, temperature, species)."""
        abunds = chem_interp(self.chem_grid, self._tensor(temp),
                             self._tensor(pressure_bar)).cpu().numpy()
        profile = {'pressure': np.asarray(pressure_bar),
                   'temperature': np.asarray(temp)}
        for i, sp in enumerate(self.chem_grid.species):
            profile[sp] = abunds[:, i]
        self.profile = profile
        return profile

    def find_kzz(self):
        """The facade's ``find_kzz`` during the run: the self-consistent
        profile once one exists, else the one the run started with."""
        return self.sc_kzz if self.sc_kzz is not None else self.inputs.kzz

    def opacities(self, profile_df):
        """RTProps and the atmosphere of a chemistry profile on the premixed
        table (api.py:253-259 of the JAX package), the optics options of
        the run: the fixed opacities a host ``core.t_start`` takes."""
        return ck_rtprops(profile_df, self.ck, self.gravity,
                          p_reference=self.inputs.p_reference,
                          delta_eddington=self.inputs.delta_eddington,
                          stream=self.inputs.stream)

    # ---- host-assembled path (diseq chemistry / virga clouds) -------------
    def update_diseq_chem(self, temp, pressure_bar):
        """Kzz -> quench levels -> chemistry adjustments (climate.py:
        3083-3109 semantics), returning the adjusted profile."""
        from . import kzz as kzz_mod

        df = self.premix(temp, pressure_bar)
        grav_si = self.gravity / 100.0
        mmw_layer = self._mmw_layer(df)
        dtdp = np.diff(np.log(temp)) / np.diff(np.log(pressure_bar))
        if self.self_consistent_kzz and self.last_fluxes is not None:
            fnil, fpit = self.last_fluxes
            kz = kzz_mod.get_kzz(pressure_bar, temp, grav_si,
                                 np.asarray(self.tidal), fnil, fpit,
                                 self.adiabat, self.last_nstr, mmw_layer,
                                 dtdp)
        else:
            kz = self.find_kzz()
            if kz is None:
                kz = np.zeros(len(temp)) + 1e9
        self.sc_kzz = kz

        scale_h = (1.38e-16 * temp[:-1]
                   / (mmw_layer * 1.66e-24 * self.gravity))
        qlv, _ = chemistry.quench_levels(
            pressure_bar, temp, dtdp, kz, mmw_layer, scale_h, grav_si,
            x_h2o=np.asarray(df.get('H2O', np.zeros(len(temp)))),
            x_h2=np.asarray(df.get('H2', np.ones(len(temp)))),
            strict=False)
        self.quench = qlv
        pc = (self.bundle.inputs['climate'].get('pc')
              if self.bundle is not None else None)
        if pc is not None:
            # full kinetics: the kinetics' steady state each iteration from
            # the quench-adjusted guess (climate.py:3107-3109; the JAX
            # package's api.py:292-296), on the bundle's profile and Kzz
            atmo = self.bundle.inputs['atmosphere']
            atmo['profile'] = df
            store = atmo.get('kzz')
            if not isinstance(store, dict):
                store = atmo['kzz'] = {}
            store['sc_kzz'] = kz
            df = self.bundle.premix_atmosphere_photochem(quench_levels=qlv)
            self.profile = df
            return df
        chem_params = self.inputs.chem_params or {}
        df = chemistry.adjust_quench_chemistry(df, qlv)
        if chem_params.get('vol_rainout'):
            df = chemistry.volatile_rainout(df, qlv)
        if chem_params.get('cold_trap'):
            df = chemistry.cold_trap(df)
        self.profile = df
        return df

    def update_clouds(self, temp, pressure_bar):
        """virga microphysics at the current structure (climate.py:
        2842-2925 semantics); returns (.cld columns, virga output)."""
        from .. import virga as vj
        kz = self.sc_kzz
        if kz is None:
            kz = np.zeros(len(temp)) + 1e9
        ptk = {'pressure': pressure_bar, 'temperature': temp,
               'kz': np.asarray(kz)[:len(temp)]}
        vkw = dict(self.virga_kwargs)
        directory = vkw.pop('directory', None)
        condensates = vkw.pop('condensates', None) or vj.recommend_gas(
            pressure_bar, temp, mh=vkw.get('mh', 1.0),
            mmw=vkw.get('mmw', 2.2))
        atmo = vj.Atmosphere(condensates, **{k: v for k, v in vkw.items()
                                             if k in ('fsed', 'mh', 'mmw',
                                                      'sig', 'b', 'eps',
                                                      'param', 'supsat',
                                                      'gas_mmr')})
        atmo.gravity = self.gravity
        atmo.ptk(df=ptk, kz_min=vkw.get('kz_min', 1e5),
                 alpha_pressure=vkw.get('alpha_pressure'))
        out = vj.compute(atmo, directory=directory,
                         do_virtual=vkw.get('do_virtual', False))
        # 4-step history average (climate.py:2885-2907): shift, insert,
        # average OPD with equal weights; W0/G0 are OPD-weighted means
        opd_now = np.asarray(out['opd_per_layer'], float)
        w0_now = np.asarray(out['single_scattering'], float)
        g0_now = np.asarray(out['asymmetry'], float)
        if self.cld_hist is None or self.cld_hist[0].shape[:2] != \
                opd_now.shape:
            self.cld_hist = [np.zeros(opd_now.shape + (4,))
                             for _ in range(3)]
        opd_h, g0_h, w0_h = self.cld_hist
        opd_prev_step = opd_h.mean(axis=2)
        for a in (opd_h, g0_h, w0_h):
            a[:, :, 1:] = a[:, :, :3]
        opd_h[:, :, 0], g0_h[:, :, 0], w0_h[:, :, 0] = opd_now, g0_now, \
            w0_now
        opd_avg = opd_h.mean(axis=2)
        with np.errstate(invalid='ignore', divide='ignore'):
            g0_avg = np.nan_to_num(
                (opd_h * g0_h).mean(axis=2) / opd_avg, nan=0.0)
            w0_avg = np.nan_to_num(
                (opd_h * w0_h).mean(axis=2) / opd_avg, nan=0.0)
        opd_avg = np.where(opd_avg <= 1e-5, 0.0, opd_avg)
        self.last_taudif = float(np.max(np.abs(opd_avg - opd_prev_step)))
        self.last_taudif_tol = float(
            0.4 * np.max(0.5 * (opd_avg + opd_prev_step)))
        # the solver's wave grid rides along, so build_props_host regrids
        # from the true source coordinates
        return vj.picaso_format(opd_avg, w0_avg, g0_avg,
                                wavenumber=1e4 / out['wave']), out

    def _mmw_layer(self, df):
        cols = [c for c in df.keys()
                if c not in ('pressure', 'temperature', 'kz', 'e-')]
        w = np.array([molmass.molecular_weight(c) for c in cols])
        mix = np.stack([np.asarray(df[c]) for c in cols], axis=1)
        mmw = mix @ w
        return 0.5 * (mmw[1:] + mmw[:-1])

    def build_props_host(self, profile_df, cld_df=None):
        """RTProps from the current chemistry: resort-rebin per-gas CK
        mixing when the table has per-gas tables (diseq), else premixed;
        optional clouds regridded onto the CK wavenumber grid."""
        from ..opacities import resortrebin as rr
        from ..wavelength import get_cld_input_grid, regrid as regrid_rows

        cld = None
        if cld_df is not None:
            nlayer = len(profile_df['pressure']) - 1
            wno = np.asarray(self.ck.wno)
            cld = {}
            if 'wavenumber' in cld_df:
                src_wno = np.reshape(np.asarray(cld_df['wavenumber']),
                                     (nlayer, -1))[0]
            else:
                src_wno = get_cld_input_grid()
            for k in ('opd', 'g0', 'w0'):
                m = np.reshape(np.asarray(cld_df[k]), (nlayer, -1))
                if m.shape[1] != len(wno) or not np.allclose(
                        src_wno, wno):
                    m = regrid_rows(m, src_wno, wno)
                cld[k] = m.ravel()

        kappa_fn = None
        if self.diseq and self.ck.per_gas is not None:
            mixes = self._tensor(np.stack([
                0.5 * (np.asarray(profile_df[m])[1:]
                       + np.asarray(profile_df[m])[:-1])
                for m in self.ck.per_gas_molecules]))
            a = self.ck.arrays

            def kappa_fn(atm):
                return rr.resortrebin_kappa(
                    self.ck.per_gas, a.t_inv_grid, a.p_log_grid, a.nc_p,
                    self._tensor(self.ck.gauss_pts),
                    self._tensor(self.ck.gauss_wts), mixes,
                    self._tensor(atm.t_layer),
                    self._tensor(atm.p_layer / PCONV))

        return ck_rtprops(profile_df, self.ck, self.gravity,
                          p_reference=self.inputs.p_reference,
                          delta_eddington=self.inputs.delta_eddington,
                          stream=self.inputs.stream, cld=cld,
                          molecular_kappa_fn=kappa_fn)


def _reconstruct_host(state, temp, nstr, nofczns):
    """Adiabatic re-stitch of convective zones (climate.py:3037-3067);
    with moist set, the stitch follows the moist adiabat at the current
    chemistry (climate.py:3053).  The JAX package's ``_reconstruct_jitted``
    (api.py:417) only wraps the same ``reconstruct_profile`` in a cached
    jit; here it runs eagerly, so this one function covers both."""
    zones = core.zone_maps(nstr, nofczns, len(temp))
    moist_args = ((state.data.cond_abunds, state.condensables,
                   state._config_base['cond_weights'])
                  if state.moist else None)
    t = core.reconstruct_profile(state._tensor(temp), zones,
                                 state.data.plevel, state.adiabat,
                                 moist_args=moist_args)
    return t.cpu().numpy().astype(np.float64)


def _update_cond_abunds(state, df):
    """Refresh the condensable layer abundances the moist adiabat reads
    (``ClimateData.cond_abunds``) from a host-side chemistry profile."""
    if not state.moist:
        return
    lvl = np.stack([np.asarray(df[c], float) for c in state.condensables],
                   axis=1)
    lay = 0.5 * (lvl[1:] + lvl[:-1])
    state.data = state.data._replace(cond_abunds=state._tensor(lay))


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
    nlevel = len(temp)

    temp_old = temp.copy()
    conv_flag = 0
    result = None
    # the cloud-stability gate (climate.py:2913-2915/3227): taudif and
    # taudif_tol come from update_clouds' 4-step OPD-history averages
    taudif, taudif_tol = 0.0, 1.0
    host_path = state.diseq or state.cloudy
    state.last_nstr = list(nstr)
    temp_dev = state._tensor(temp)
    for iii in range(itmx):
        if host_path:
            # chemistry, Kzz, quench levels and virga on the host, the
            # optics rebuilt on the device, then the Newton solve
            # (climate.py:3083-3151 order of operations)
            if state.counts is not None:
                state.counts.profile_steps += 1
            temp = _reconstruct_host(state, temp, nstr, nofczns)
            if state.diseq:
                df = state.update_diseq_chem(temp, pressure_bar)
            else:
                df = state.premix(temp, pressure_bar)
            _update_cond_abunds(state, df)
            cld_df = None
            if state.cloudy:
                if state.last_fluxes is None and not state.diseq:
                    state.sc_kzz = np.zeros(len(temp)) + 1e9
                cld_df, _ = state.update_clouds(temp, pressure_bar)
                taudif = state.last_taudif
                taudif_tol = state.last_taudif_tol
            props, _ = state.build_props_host(df, cld_df=cld_df)
            props = state.data.wave.split_props(props)
            temp_dev, _, fnil, fnvl, fpit = fused.newton_solve(
                state._tensor(temp), props, zones, state.data, state.geom,
                state.ck.arrays, state.adiabat, config, state.counts)
            dtdp = (torch.diff(torch.log(temp_dev))
                    / torch.diff(torch.log(state.data.plevel)))
            del props
        else:
            temp_dev, _, dtdp, fnil, fnvl, fpit = fused.profile_step(
                temp_dev, zones, state.data, state.chem_grid,
                state.ck.arrays, state.geom, state.adiabat, config,
                state.counts)
        host = torch.cat([temp_dev, dtdp, fnil, fnvl, fpit]).cpu().numpy()
        temp, dtdp, fnil, fnvl, fpit = np.split(
            host.astype(np.float64),
            np.cumsum([nlevel, nlevel - 1, nlevel, nlevel]))
        state.last_fluxes = (fnil, fpit)
        if save_profile:
            state.all_profiles.append(temp.copy())

        ert = float(np.abs(temp - temp_old).sum()) / (len(temp) * 1.5)
        temp_old = temp.copy()
        if state.verbose:
            print(f' profile it {iii}: mean|dT| {ert:.3f} K (conv {convt})')
        result = (dtdp, fnil, fnvl, fpit)
        # the reference's strict `taudif < taudif_tol` (climate.py:3228)
        # never passes with an identically zero cloud (0 < 0); the
        # `taudif == 0.0` bypass decides only then, as in the JAX package
        if iii > 0 and ert < convt and (taudif < taudif_tol
                                        or taudif == 0.0):
            conv_flag = 1
            break

    # refresh the chemistry at the converged structure through the same
    # pathway the loop used (climate.py:3153-3209)
    if state.diseq:
        state.update_diseq_chem(temp, pressure_bar)
    else:
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
        """convec (climate.py:570-608): the dry or moist adiabatic
        gradient per layer at the current chemistry."""
        tbar = state._tensor(0.5 * (temp[1:] + temp[:-1]))
        pbar = state._tensor(np.sqrt(pressure_bar[1:] * pressure_bar[:-1]))
        if state.moist:
            mix = chem_interp(state.chem_grid, tbar, pbar)
            cols = [state.chem_grid.species.index(c)
                    for c in state.condensables]
            grad_x, _ = moist_grad(tbar, pbar, state.adiabat,
                                   mix[:, cols].T, state.condensables,
                                   state._config_base['cond_weights'])
        else:
            grad_x, _ = did_grad_cp(tbar, pbar, state.adiabat)
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


def _tidal(inputs: ClimateInputs):
    """The level sink/source profile, with the energy injection of
    ``inputs.injection`` (justdoit.py:4953-4980, fluxes.py:3671-3751)."""
    nlevel = len(inputs.pressure)
    if not inputs.injection:
        return core.tidal_flux(inputs.t_eff, nlevel)
    pr = np.asarray(inputs.pressure, float)
    colden = np.diff(pr) * 1e6 / inputs.gravity      # g/cm^2 per layer
    inj = inputs.injection
    return core.tidal_flux(
        inputs.t_eff, nlevel, pressure=pr, colden=colden,
        injection=dict(total_energy=inj.get('total_energy', 0.0),
                       press_max=inj.get('press_max', 1.0),
                       hratio=inj.get('hratio', 1.0),
                       inject_beam=inj.get('inject_beam', False),
                       beam_profile=inj.get('beam_profile', 0.0)))


def climate_state(inputs: ClimateInputs, ck: CKTable, device='cuda',
                  dtype=torch.float64, verbose=True,
                  counts=None) -> _ClimateState:
    """What a solve threads through its iterations, as :func:`run_climate`
    sets it up: the table (its per-gas tables too) moved to ``device``
    (default ``'cuda'``; raises where there is none) in ``dtype`` (float64
    unless asked, see :func:`run_climate`), the chemistry grid, the
    adiabat table, the angles, the per-run arrays (``.data``) and the
    static options (``.fused_config``)."""
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
    return _ClimateState(inputs, ck, F0PI, _tidal(inputs), inputs.rfaci,
                         rfacv, tmin, tmax, device, dtype, verbose=verbose,
                         counts=counts)


def run_climate(inputs: ClimateInputs, ck: CKTable, save_all_profiles=False,
                with_spec=False, diseq_chem=False, verbose=True,
                counts: fused.ClimateCounts = None, jac_batch=None,
                mesh=None, device='cuda', dtype=torch.float64,
                self_consistent_kzz=True, bundle=None, opacity=None):
    """Radiative-convective equilibrium solve (justdoit.climate,
    :4982-5281 of the reference; ``run_climate`` of the JAX package).

    Modes: chemical equilibrium (default); ``diseq_chem`` (self-consistent
    MLT Kzz unless ``self_consistent_kzz=False``, Zahnle & Marley
    quenching, resort-rebin mixing when the table has per-gas tables);
    and, as ``inputs`` says, clouds (``cloudy`` or ``virga_kwargs``: virga
    in the loop), the moist adiabat (``moistgrad``) and energy injection
    (``injection``).  ``with_spec`` adds the thermal spectrum of the result
    (``spectrum_output``) through the front door: ``bundle`` (the
    ``justdoit.inputs`` case) on ``opacity`` (its connection, which holds a
    CUDA table in float32, the front door's spectra's dtype); both are
    required with ``with_spec``; ``bundle``'s ``inputs['climate']['pc']``
    (``inputs.photochem_init``, or any object with its ``run_for_picaso``)
    turns the diseq chemistry into photochemical kinetics.  ``mesh`` (a
    ``parallel.make_mesh`` mesh whose first device is ``device``) runs the
    solve over the mesh (``parallel.shard_climate_state``): the CK bins
    over 'wave', the Jacobian's perturbed profiles over 'batch'; the wave
    sums then add in another order, so the result moves by rounding only.

    Runs on ``device`` (default ``'cuda'``; raises where there is none) in
    ``dtype``, float64 on every device unless asked: the solve is bound by
    the host's dispatch, so float64 costs the card no wall time, and a
    float32 solve at 91 levels misses the float64 one by hundreds of K
    (the thin upper layers' thermal fluxes, ROADMAP Queue 3).  The table is
    moved there.  ``counts``, a
    :class:`~picaso_tpu_torch.climate.fused.ClimateCounts`, is filled with
    what the solve did; ``jac_batch`` caps the Jacobian's perturbed
    profiles per flux evaluation (default None: all in one evaluation; a
    cap saves device memory and changes no number).  Returns the JAX
    package's keys (``ptchem_df`` a dict of numpy columns), with
    ``quench_levels`` for diseq runs.
    """
    if with_spec and (bundle is None or opacity is None):
        raise ValueError('with_spec needs the front door\'s case (bundle=) '
                         'and connection (opacity=): justdoit.inputs.'
                         'climate passes both')
    state = climate_state(inputs, ck, device, dtype, verbose=verbose,
                          counts=counts)
    state.diseq = bool(diseq_chem)
    state.bundle = bundle
    if mesh is not None:
        from ..parallel import shard_climate_state
        shard_climate_state(state, mesh)
    state.self_consistent_kzz = self_consistent_kzz
    state.virga_kwargs = dict(inputs.virga_kwargs or {})
    state.cloudy = bool(inputs.cloudy or state.virga_kwargs)
    if diseq_chem and state.ck.per_gas is None and verbose:
        print('diseq_chem=True with a premixed-only CK table: quench '
              'adjustments affect continuum/mmw but molecular k stays '
              'premixed; supply per-gas tables for full resort-rebin '
              'mixing.')
    pressure = np.asarray(inputs.pressure, float)
    temp = np.asarray(inputs.guess, float).copy()
    nstr = list(inputs.nstr)
    nofczns = inputs.nofczns
    loop = dict(jac_batch=jac_batch, save_profile=save_all_profiles)

    if diseq_chem:
        # climate.py:126-218 diseq workflow: one loose profile + find_strat
        flag, temp, dtdp, fni, fnv, fpit = profile(
            state, nofczns, nstr, temp, pressure, it_max=10, itmx=7,
            conv=5.0, convt=4.0, x_max_mult=7.0, final=False, **loop)
    else:
        # STEP 1: loose-tolerance profile (climate.py:270-290)
        flag, temp, dtdp, fni, fnv, fpit = profile(
            state, nofczns, nstr, temp, pressure, it_max=10, itmx=7,
            conv=10.0, convt=5.0, x_max_mult=7.0, final=False, **loop)
        # STEP 2: stricter profile
        flag, temp, dtdp, fni, fnv, fpit = profile(
            state, nofczns, nstr, temp, pressure, it_max=7, itmx=5,
            conv=5.0, convt=4.0, x_max_mult=7.0, final=False, **loop)
    # STEP 3: convective-zone search + final pass
    flag, temp, dtdp, nstr, fni, fnv, fpit, chem_df = find_strat(
        state, nofczns, nstr, temp, pressure, dtdp, **loop)
    return _assemble_climate_output(state, pressure, temp, dtdp, nstr, fni,
                                    fnv, fpit, chem_df, flag,
                                    save_all_profiles, with_spec, bundle,
                                    opacity)


def _assemble_climate_output(state, pressure, temp, dtdp, nstr, fni, fnv,
                             fpit, chem_df, flag, save_all_profiles,
                             with_spec, bundle, opacity):
    """api.py:810-842 of the JAX package."""
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
    if state.sc_kzz is not None:
        out['kzz'] = np.asarray(state.sc_kzz)
    if state.quench is not None:
        out['quench_levels'] = dict(state.quench)
    if state.cloudy:
        cld_df, cld_out = state.update_clouds(temp, pressure)
        out['cld_df'] = cld_df
        out['virga_output'] = cld_out
    if save_all_profiles:
        out['all_profiles'] = (np.stack(state.all_profiles)
                               if state.all_profiles
                               else np.zeros((0, len(pressure))))
    if with_spec:
        bundle.atmosphere(df=chem_df)
        if state.cloudy:
            bundle.clouds(df=out['cld_df'])
        out['spectrum_output'] = bundle.spectrum(
            opacity, calculation='thermal', full_output=True)
    return out
