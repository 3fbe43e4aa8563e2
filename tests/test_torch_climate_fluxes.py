"""The port's climate fluxes and profile machinery against the JAX package.

Same inputs (numpy, from a seed, and a 24-bin slice of the synthetic CK
table) go through the JAX functions in float64 and through
picaso_tpu_torch on the CPU in float64, rtol 1e-10 (with an atol of 1e-10
of each array's scale):
- ``blackbody_integrated``, the level-flux thermal solve (``thermal_1d``
  with calc_type=1 in the JAX package, ``thermal_levels`` here) and
  ``reflected_1d(get_lvl_flux=True)``;
- ``build_opacities`` (with and without cloud arrays), ``thermal_fluxes``
  (one profile, and several perturbed profiles in one evaluation),
  ``visible_fluxes``,
  ``tidal_flux`` (with and without energy injection), ``zone_maps`` with
  one and two convective zones, and ``reconstruct_profile``;
- the Newton Jacobian against the JAX host solver's ``_jacobian``, and
  computed with ``jac_batch`` 1, 8, nlevel and None (all at once): the
  same numbers;
- ``fused.newton_solve`` at fixed opacities, irradiated (the visible
  fluxes in the residual): the same temperatures and fluxes and the same
  convergence flag.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu.climate import core as jcore
from picaso_tpu.climate import fused as jfused
from picaso_tpu.climate.adiabat import load_adiabat_grid as j_adiabat
from picaso_tpu.chemistry import chem_grid_from_table as j_chem_grid
from picaso_tpu.opacities import assemble as jassemble
from picaso_tpu.opacities import ck as jck
from picaso_tpu.optics import combine_optics as j_combine_optics
from picaso_tpu.rt import toon as jtoon

from picaso_tpu_torch import convert
from picaso_tpu_torch import optics as t_optics
from picaso_tpu_torch.climate import api as tapi
from picaso_tpu_torch.climate import core as tcore
from picaso_tpu_torch.climate import fused as tfused
from picaso_tpu_torch.rt import toon as ttoon

torch.set_num_threads(1)

RTOL = 1e-10
NLAYER, NWNO, NANG = 14, 40, 5
NLEVEL = 21


def close(port, ref, rtol=RTOL, scale=None):
    """rtol, with an atol of rtol times ``scale`` (default: the largest
    magnitude of ref)."""
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=rtol * scale)


# ---------------------------------------------------------------------------
# the Toon level fluxes on random optics
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def optics():
    rng = np.random.default_rng(21)
    shape = (NLAYER, NWNO)
    d = dict(taugas=rng.uniform(1e-4, 1.5, shape),
             tauray=rng.uniform(1e-5, 0.3, shape),
             copd=rng.uniform(0.0, 1.0, shape),
             cw0=rng.uniform(0.3, 0.99, shape),
             cg0=rng.uniform(0.0, 0.9, shape),
             rf=np.full(shape, 0.99999))
    keys = ('taugas', 'tauray', 'copd', 'cw0', 'cg0', 'rf')
    jp = j_combine_optics(*(jnp.asarray(d[k]) for k in keys))
    tp = t_optics.combine_optics(*(torch.tensor(d[k]) for k in keys))
    return dict(jp=jp, tp=tp,
                tlevel=np.linspace(300.0, 2200.0, NLAYER + 1),
                plevel=np.logspace(-4, 2, NLAYER + 1) * 1e6,
                wno=np.linspace(300.0, 20000.0, NWNO),
                dwno=rng.uniform(50.0, 600.0, NWNO),
                ubar1=rng.uniform(0.1, 1.0, (NANG, 1)),
                surf=np.full(NWNO, 0.2), F0PI=rng.uniform(0.5, 1.5, NWNO))


def test_blackbody_integrated(optics):
    o = optics
    j = jtoon.blackbody_integrated(jnp.asarray(o['tlevel']),
                                   jnp.asarray(o['wno']),
                                   jnp.asarray(o['dwno']))
    t = ttoon.blackbody_integrated(torch.tensor(o['tlevel']),
                                   torch.tensor(o['wno']),
                                   torch.tensor(o['dwno']))
    close(t, j)


@pytest.mark.parametrize('hard_surface', [False, True])
def test_thermal_levels(optics, hard_surface):
    o = optics
    jp, tp = o['jp'], o['tp']
    _, jl = jtoon.thermal_1d(
        jnp.asarray(o['tlevel']), jp.dtau_og, jp.w0_no_raman, jp.cosb_og,
        jnp.asarray(o['plevel']), jnp.asarray(o['ubar1']),
        jnp.asarray(o['surf']), jnp.asarray(o['wno']),
        dwno=jnp.asarray(o['dwno']), hard_surface=hard_surface, calc_type=1)
    all_b = ttoon.blackbody_integrated(torch.tensor(o['tlevel']),
                                       torch.tensor(o['wno']),
                                       torch.tensor(o['dwno']))
    plevel = o['plevel']
    tau_top = tp.dtau_og[0] * plevel[0] / (plevel[1] - plevel[0])
    tl = ttoon.thermal_levels(all_b, tp.dtau_og, tp.w0_no_raman, tp.cosb_og,
                              tau_top, torch.tensor(o['surf']),
                              torch.tensor(o['ubar1']),
                              hard_surface=hard_surface)
    for name in ttoon.FluxSet._fields:
        close(getattr(tl, name), getattr(jl, name))


@pytest.mark.parametrize('toon_coefficients', [0, 1])
def test_reflected_level_fluxes(optics, toon_coefficients):
    o = optics
    jp, tp = o['jp'], o['tp']
    jc = jtoon.ScatteringControls(toon_coefficients=toon_coefficients)
    tc = ttoon.ScatteringControls(toon_coefficients=toon_coefficients)
    u0 = np.array([[0.5], [0.8]])
    u1 = np.array([[0.5], [0.3]])
    _, jl = jtoon.reflected_1d(
        *(getattr(jp, k) for k in t_optics.RTProps._fields[:11]),
        jnp.asarray(o['surf']), jnp.asarray(u0), jnp.asarray(u1), 1.0,
        jnp.asarray(o['F0PI']), controls=jc, get_toa_intensity=False,
        get_lvl_flux=True)
    tl = ttoon.reflected_1d(
        *(getattr(tp, k) for k in t_optics.RTProps._fields[:11]),
        torch.tensor(o['surf']), torch.tensor(u0), torch.tensor(u1), 1.0,
        torch.tensor(o['F0PI']), controls=tc, get_lvl_flux=True)
    for name in ttoon.FluxSet._fields:
        close(getattr(tl, name), getattr(jl, name))


# ---------------------------------------------------------------------------
# the climate solve's pieces on a 24-bin CK slice
# ---------------------------------------------------------------------------

def sliced_tables(stride, stop=None):
    """The JAX synthetic CK table (float64) with every ``stride``-th bin
    below ``stop``, and the port's copy of it."""
    jt = jck.synthetic_ck_table(dtype=np.float64)
    a = jt.arrays
    sl = np.s_[:stop:stride]
    js = jck.CKTable(
        a._replace(wno=a.wno[sl], delta_wno=a.delta_wno[sl],
                   ln_kappa=a.ln_kappa[:, :, sl, :],
                   cont_opa=a.cont_opa[:, :, sl]),
        jt.molecules, jt.full_abunds, jt.gauss_pts, jt.temps, jt.pressures,
        wno=jt.wno[sl], delta_wno=jt.delta_wno[sl], gauss_wts=jt.gauss_wts)
    arrays = {k: np.asarray(v) for k, v in js.arrays._asdict().items()
              if k != 'continuum_molecules'}
    arrays['continuum_molecules'] = js.arrays.continuum_molecules
    ts = convert.ck_table_from_numpy(
        arrays, js.molecules,
        {c: js.full_abunds[c].values for c in js.full_abunds.columns},
        js.gauss_pts, js.temps, js.pressures, device='cpu')
    return js, ts


def port_state(ts, pressure, guess, nstr, rfacv=0.0, F0PI=None):
    """The port's solve state for a 700 K object at 100 m/s^2, as
    run_climate builds it."""
    inputs = tapi.ClimateInputs(t_eff=700.0, gravity=1e4,
                                pressure=pressure, guess=guess, nstr=nstr,
                                rfacv=rfacv, F0PI=F0PI)
    return tapi.climate_state(inputs, ts, device='cpu', verbose=False)


def jax_twins(state, js, it_max=10, egp_stepmax=False):
    """The JAX package's (ClimateData, ClimateConfig, ChemGrid, adiabat,
    geometry) holding the same values as the port's state."""
    d = state.data
    nlayer, nwno = d.plevel.shape[0] - 1, d.F0PI.shape[0]
    zeros = jnp.zeros((nlayer, nwno))
    jdata = jfused.ClimateData(
        plevel=jnp.asarray(d.plevel.numpy()), gravity=jnp.asarray(d.gravity),
        tidal=jnp.asarray(d.tidal.numpy()), rfaci=jnp.asarray(d.rfaci),
        rfacv=jnp.asarray(d.rfacv), tmin=jnp.asarray(d.tmin),
        tmax=jnp.asarray(d.tmax), F0PI=jnp.asarray(d.F0PI.numpy()),
        surf_reflect=jnp.asarray(d.surf_reflect.numpy()),
        sigma_ray=jnp.asarray(d.sigma_ray.numpy()), cld_opd=zeros,
        cld_g0=zeros, cld_w0=zeros, cond_abunds=jnp.zeros((nlayer, 1)),
        it_max=jnp.asarray(it_max, jnp.int32),
        egp_stepmax=jnp.asarray(egp_stepmax))
    base = dict(state._config_base)
    base['continuum_specs'] = tuple(jassemble.ContinuumSpec(*s)
                                    for s in base['continuum_specs'])
    base['controls'] = jtoon.ScatteringControls(
        *dataclasses.astuple(base['controls']))
    jconfig = jfused.ClimateConfig(**base)
    return (jdata, jconfig, j_chem_grid(js.full_abunds), j_adiabat(),
            jcore.make_climate_geometry())


@pytest.fixture(scope='module')
def solve_case():
    js, ts = sliced_tables(stride=8)
    pressure = np.logspace(-4, 2.5, NLEVEL)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    nstr = (0, NLEVEL - 6, NLEVEL - 2, 0, 0, 0)
    rng = np.random.default_rng(9)
    F0PI = rng.uniform(1e2, 1e4, ts.nwno)
    state = port_state(ts, pressure, guess, nstr, rfacv=0.5, F0PI=F0PI)
    jdata, jconfig, jchem, jadb, jgeom = jax_twins(state, js)
    zones = tcore.zone_maps(nstr, 1, NLEVEL)
    jzones = jcore.zone_maps(nstr, 1, NLEVEL)
    temp = tcore.reconstruct_profile(torch.tensor(guess), zones,
                                     state.data.plevel, state.adiabat)
    config = state.fused_config(10, False, jac_batch=8)
    props = tfused.build_opacities(temp, state.data, state.chem_grid,
                                   ts.arrays, config)
    jtemp = jnp.asarray(temp.numpy())
    jprops = jfused.build_opacities(jtemp, jdata, jchem, js.arrays, jconfig)
    return dict(js=js, ts=ts, state=state, config=config, zones=zones,
                jzones=jzones, temp=temp, props=props, jtemp=jtemp,
                jprops=jprops, jdata=jdata, jconfig=jconfig, jadb=jadb,
                jgeom=jgeom)


def test_build_opacities(solve_case):
    c = solve_case
    for name in t_optics.RTProps._fields:
        close(getattr(c['props'], name), getattr(c['jprops'], name))


def test_build_opacities_with_clouds(solve_case):
    """ClimateData's cloud arrays, combined into the optics."""
    c = solve_case
    d = c['state'].data
    rng = np.random.default_rng(10)
    shape = (NLEVEL - 1, d.F0PI.shape[0])
    cld = dict(cld_opd=rng.uniform(0.0, 2.0, shape),
               cld_g0=rng.uniform(0.0, 0.9, shape),
               cld_w0=rng.uniform(0.3, 0.99, shape))
    props = tfused.build_opacities(
        c['temp'], d._replace(**{k: torch.tensor(v) for k, v in cld.items()}),
        c['state'].chem_grid, c['ts'].arrays, c['config'])
    jprops = jfused.build_opacities(
        c['jtemp'], c['jdata']._replace(**{k: jnp.asarray(v)
                                          for k, v in cld.items()}),
        j_chem_grid(c['js'].full_abunds), c['js'].arrays, c['jconfig'])
    assert (props.w0 - c['props'].w0).abs().max() > 1e-3
    for name in t_optics.RTProps._fields:
        close(getattr(props, name), getattr(jprops, name))


def test_thermal_fluxes(solve_case):
    c = solve_case
    ts, js, state = c['ts'], c['js'], c['state']
    a, ja = ts.arrays, js.arrays
    d = state.data
    perturbed = c['temp'][None] * torch.tensor([[1.0], [1.01], [0.97]])
    batched = tcore.thermal_fluxes(perturbed, c['props'], d.plevel,
                                   state.geom, a.wno, a.delta_wno,
                                   a.gauss_wts, d.surf_reflect)
    for i in range(3):
        ref = jcore.thermal_fluxes(
            jnp.asarray(perturbed[i].numpy()), c['jprops'],
            c['jdata'].plevel, c['jgeom'], ja.wno, ja.delta_wno,
            ja.gauss_wts, c['jdata'].surf_reflect)
        one = tcore.thermal_fluxes(perturbed[i], c['props'], d.plevel,
                                   state.geom, a.wno, a.delta_wno,
                                   a.gauss_wts, d.surf_reflect)
        # the nets are differences of upward and downward fluxes of order
        # sigma T^4 at depth: XLA's and torch's exp differ by an ulp, which
        # the layer recursions carry to ~4e-11 of those fluxes and so to
        # ~3e-8 of the deep nets; held to 1e-10 of sigma T_max^4
        scale = tcore.SIGMA_SB * float(perturbed[i].max()) ** 4
        for port, port_one, jax in zip(batched, one, ref):
            close(port[i], jax, scale=max(scale, np.abs(jax).max()))
            close(port_one, jax, scale=max(scale, np.abs(jax).max()))


def test_visible_fluxes(solve_case):
    c = solve_case
    d = c['state'].data
    ref = jcore.visible_fluxes(c['jprops'], c['jdata'].plevel,
                               c['jdata'].F0PI, c['js'].arrays.gauss_wts,
                               c['jdata'].surf_reflect,
                               c['jconfig'].controls)
    out = tcore.visible_fluxes(c['props'], d.plevel, d.F0PI,
                               c['ts'].arrays.gauss_wts, d.surf_reflect,
                               c['config'].controls)
    for port, jax in zip(out, ref):
        close(port, jax)


INJECTIONS = {
    'none': None,
    'chapman': dict(total_energy=3e5, press_max=0.1, hratio=0.8),
    'beam': dict(inject_beam=True,
                 beam_profile=np.linspace(0.0, 2e4, NLEVEL))}


@pytest.mark.parametrize('injection', INJECTIONS, ids=list(INJECTIONS))
def test_tidal_flux(injection):
    pressure = np.logspace(-4, 2.5, NLEVEL)
    colden = np.diff(pressure) * 1e6 / 1e4
    kw = dict(pressure=pressure, colden=colden,
              injection=INJECTIONS[injection])
    np.testing.assert_array_equal(tcore.tidal_flux(700.0, NLEVEL, **kw),
                                  jcore.tidal_flux(700.0, NLEVEL, **kw))


ZONES = {'one zone': ([0, 5, 20, 0, 0, 0], 1),
         'two zones': ([0, 5, 8, 12, 15, 28], 2),
         'top zone': ([0, 12, 28, 0, 0, 0], 1)}


@pytest.mark.parametrize('zone', ZONES, ids=list(ZONES))
def test_zone_maps(zone):
    nstr, nofczns = ZONES[zone]
    j = jcore.zone_maps(nstr, nofczns, 30)
    t = tcore.zone_maps(nstr, nofczns, 30)
    for name in tcore.ZoneMaps._fields:
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)))


@pytest.mark.parametrize('zone', ZONES, ids=list(ZONES))
def test_reconstruct_profile(zone):
    nstr, nofczns = ZONES[zone]
    nlevel = 30
    plevel = np.logspace(-4, 2.5, nlevel) * 1e6
    rng = np.random.default_rng(4)
    betas = np.linspace(300.0, 1400.0, nlevel) * rng.uniform(
        0.9, 1.1, (3, nlevel))
    jad = j_adiabat()
    tad = convert.adiabat_from_numpy(
        {k: np.asarray(v) for k, v in jad._asdict().items()}, device='cpu')
    zones = tcore.zone_maps(nstr, nofczns, nlevel)
    batched = tcore.reconstruct_profile(torch.tensor(betas), zones,
                                        torch.tensor(plevel), tad)
    for i, beta in enumerate(betas):
        ref = jcore.reconstruct_profile(
            jnp.asarray(beta), jcore.zone_maps(nstr, nofczns, nlevel),
            jnp.asarray(plevel), jad)
        close(batched[i], ref, rtol=1e-12)


def test_jacobian_matches_jax_at_every_chunk_size(solve_case):
    c = solve_case
    ts, js, state = c['ts'], c['js'], c['state']
    a, ja = ts.arrays, js.arrays
    d = state.data
    fni, fnil, _ = tcore.thermal_fluxes(c['temp'], c['props'], d.plevel,
                                        state.geom, a.wno, a.delta_wno,
                                        a.gauss_wts, d.surf_reflect)
    jfni, jfnil, _ = jcore.thermal_fluxes(
        c['jtemp'], c['jprops'], c['jdata'].plevel, c['jgeom'], ja.wno,
        ja.delta_wno, ja.gauss_wts, c['jdata'].surf_reflect)
    ref = np.asarray(jcore._jacobian(
        c['jtemp'], c['jtemp'], jfni, jfnil, c['jzones'], c['jprops'],
        c['jdata'].plevel, c['jgeom'], ja.wno, ja.delta_wno, ja.gauss_wts,
        c['jdata'].surf_reflect, c['jadb']))
    out = {}
    n = c['zones'].n_total
    for jac_batch in (1, 8, NLEVEL, None):
        config = dataclasses.replace(c['config'], jac_batch=jac_batch)
        counts = tfused.ClimateCounts()
        out[jac_batch] = tfused.jacobian(
            c['temp'], c['temp'], fni, fnil, c['props'], c['zones'], d,
            state.geom, a, state.adiabat, config, counts)
        assert counts.flux_evaluations == -(-n // (jac_batch or n))
        assert counts.flux_profiles == n
        close(out[jac_batch], ref)
    assert torch.equal(out[1], out[8]) and torch.equal(out[8], out[NLEVEL])
    assert torch.equal(out[NLEVEL], out[None])


def test_newton_solve_matches_jax():
    js, ts = sliced_tables(stride=8)
    nlevel = NLEVEL
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    nstr = (0, nlevel - 6, nlevel - 2, 0, 0, 0)
    F0PI = np.random.default_rng(2).uniform(1e2, 1e4, ts.nwno)
    state = port_state(ts, pressure, guess, nstr, rfacv=0.5, F0PI=F0PI)
    config = state.fused_config(it_max=10, egp_stepmax=False, jac_batch=8)
    jdata, jconfig, jchem, jadb, jgeom = jax_twins(state, js)
    zones = tcore.zone_maps(nstr, 1, nlevel)
    temp = tcore.reconstruct_profile(torch.tensor(guess), zones,
                                     state.data.plevel, state.adiabat)
    props = tfused.build_opacities(temp, state.data, state.chem_grid,
                                   ts.arrays, config)
    jtemp = jnp.asarray(temp.numpy())
    jprops = jfused.build_opacities(jtemp, jdata, jchem, js.arrays, jconfig)
    counts = tfused.ClimateCounts()
    out = tfused.newton_solve(temp, props, zones, state.data, state.geom,
                              ts.arrays, state.adiabat, config, counts)
    ref = jfused.newton_solve(jtemp, jprops, jcore.zone_maps(nstr, 1, nlevel),
                              jdata, jgeom, js.arrays, jadb, jconfig)
    assert out[1] == bool(ref[1])
    assert counts.newton_iterations >= 2 and counts.jacobians >= 1
    close(out[0], ref[0])
    for port, jax in zip(out[2:], ref[2:]):
        close(port, jax, scale=tcore.SIGMA_SB * float(temp.max()) ** 4)
