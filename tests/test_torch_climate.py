"""The port's climate solve against the JAX package, end to end.

On the CPU in float64, with the same tables (the JAX synthetic CK table in
float64, sliced, carried across by ``convert``):
- a whole ``run_climate`` of the 700 K brown dwarf of
  tests/test_resonant_clip.py:64-95 (the stride-4, 48-bin slice of the
  196-bin table), at nlevel 31: the same ``converged`` and ``cvz_locs``,
  max |dT| <= 1e-6 K (measured: ~1e-10 K);
- an irradiated ``run_climate`` (rfacv 0.5, the stellar flux of
  tests/test_climate.py:116-141 from the JAX ``opannection``), on a
  stride-8, 24-bin slice at nlevel 25: the same bounds (in
  tests/test_torch_climate_irradiated.py, which runs it, so that each
  file stays under a minute on one CPU thread; ``fused.newton_solve`` at
  fixed opacities is in tests/test_torch_climate_fluxes.py);
- each mode's option runs one profile step against the JAX package's
  (``mesh`` alone raises, naming the ROADMAP); the cloud history over five
  virga refreshes; the stellar flux's climate binning.  Whole solves of
  the modes are in tests/test_torch_climate_solve_*.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from picaso_tpu import justdoit as jdi

from picaso_tpu_torch.climate import api as tapi
from picaso_tpu_torch.climate import core as tcore
from picaso_tpu_torch.climate import fused as tfused

from test_torch_climate_fluxes import close, sliced_tables

torch.set_num_threads(1)

DT_MAX = 1e-6   # K


def _jax_case(nlevel, irradiated, F0PI_from=None):
    case = jdi.inputs(calculation='planet' if irradiated else 'brown',
                      climate=True)
    case.phase_angle(0)
    case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.effective_temp(700.0)
    if irradiated:
        case.star(F0PI_from, temp=5600, radius=1.0,
                  radius_unit=jdi.u.Unit('Rsun'), semi_major=0.05,
                  semi_major_unit=jdi.u.Unit('au'))
    else:
        case.setup_nostar()
    case.setup_climate()
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    case.inputs_climate(temp_guess=guess, pressure=pressure,
                        rcb_guess=nlevel - 8,
                        rfacv=0.5 if irradiated else 0.0)
    return case, pressure, guess


def run_climate_against_jax(irradiated):
    # the brown dwarf on tests/test_resonant_clip.py:75-77's 48-bin slice
    stride, stop, nlevel = (8, None, 25) if irradiated else (4, 192, 31)
    js, ts = sliced_tables(stride, stop)
    assert irradiated or ts.nwno == 48
    opa = jdi.opannection(ck_table=js, method='preweighted')
    case, pressure, guess = _jax_case(nlevel, irradiated, opa)
    ref = case.climate(opa, verbose=False)

    F0PI = np.asarray(opa.relative_flux) if irradiated else None
    inputs = tapi.ClimateInputs(
        t_eff=700.0, gravity=case.inputs['planet']['gravity'],
        pressure=pressure, guess=guess,
        nstr=(0, nlevel - 8, nlevel - 2, 0, 0, 0),
        rfacv=0.5 if irradiated else 0.0, F0PI=F0PI)
    counts = tfused.ClimateCounts()
    out = tapi.run_climate(inputs, ts, verbose=False, device='cpu',
                           counts=counts, save_all_profiles=True)

    assert out['converged'] == ref['converged'] == 1
    assert list(out['cvz_locs']) == [int(i) for i in ref['cvz_locs']]
    d_t = np.abs(out['temperature'] - np.asarray(ref['temperature'])).max()
    assert d_t <= DT_MAX, d_t
    assert counts.profile_steps == len(out['all_profiles'])
    assert set(ref) <= set(out) | {'kzz'}
    chem = ref['ptchem_df']
    assert list(out['ptchem_df']) == list(chem.columns)
    for col in chem.columns:
        np.testing.assert_allclose(out['ptchem_df'][col], chem[col].values,
                                   rtol=1e-8)
    fb, jfb = out['flux_balance'], ref['flux_balance']
    scale = tcore.SIGMA_SB * float(out['temperature'].max()) ** 4
    for key in ('flux_net_ir', 'flux_net_v', 'flux_net'):
        close(fb[key], jfb[key], rtol=1e-8, scale=scale)
    return d_t


def test_run_climate_matches_jax():
    run_climate_against_jax(irradiated=False)


UNPORTED = {'diseq_chem': True, 'cloudy': True,
            'virga_kwargs': {'fsed': 3.0}, 'moistgrad': True,
            'inject_energy': True, 'with_spec': True, 'mesh': object()}
# the recorded small case each option runs (tests/climate_modes_record.py)
OPTION_CASE = {'diseq_chem': 'diseq_31', 'cloudy': 'cloudy_31',
               'virga_kwargs': 'cloudy_31', 'moistgrad': 'moist_31',
               'inject_energy': 'inject_31', 'with_spec': 'inject_31'}


def one_profile_step(option):
    """One profile step (itmx 1, at most 4 Newton iterations) of an
    option's mode from the case's guess, in the JAX package and in the
    port: (JAX state, JAX result, port state, port result)."""
    from picaso_tpu.climate import api as japi
    from climate_modes_record import CASES, jax_facade_case, profile_guess
    from torch_climate_modes_cases import port_inputs, tables

    spec = dict(CASES[OPTION_CASE[option]])
    if option == 'cloudy':          # no virga kwargs: recommended gases
        spec['virga_kwargs'] = None
    js, ts = tables(spec)
    opa = jdi.opannection(ck_table=js)
    opa.relative_flux = np.ones(js.nwno)
    case = jax_facade_case(jdi, spec)
    if option == 'cloudy':
        case.inputs['climate']['cloudy'] = True
    inputs = port_inputs(spec)
    if option == 'cloudy':
        inputs.cloudy = True
    pressure, guess = profile_guess(spec)
    tst = tapi.climate_state(inputs, ts, device='cpu', verbose=False)
    jst = japi._ClimateState(case, opa, tst.tidal, 1.0, 0.0,
                             tst.data.tmin, tst.data.tmax,
                             moist=spec['moistgrad'], verbose=False)
    for st in (jst, tst):
        st.diseq = spec['diseq_chem']
        st.cloudy = inputs.cloudy
        st.virga_kwargs = dict(inputs.virga_kwargs or {})
    nstr = [0, spec['rcb_guess'], spec['nlevel'] - 2, 0, 0, 0]
    step = dict(it_max=4, itmx=1, conv=10.0, convt=5.0, x_max_mult=7.0,
                final=False)
    jres = japi.profile(jst, 1, nstr, guess, pressure, **step)
    tres = tapi.profile(tst, 1, nstr, guess, pressure, jac_batch=None,
                        **step)
    return jst, jres, tst, tres


@pytest.mark.parametrize('option', UNPORTED)
def test_unported_options_raise(option):
    """``mesh`` raises; each other option runs one profile step of its
    mode (with_spec: the spectrum of the step's structure) against the
    JAX package's: temperatures rtol 1e-8 (a Newton step of a stiff solve
    amplifies last-bit differences: measured <= 4.3e-9 rel), the fluxes,
    chemistry, Kzz, cloud history and spectrum rtol 1e-6."""
    if option == 'mesh':
        inputs = tapi.ClimateInputs(t_eff=700.0, gravity=1e4,
                                    pressure=np.logspace(-4, 2, 11),
                                    guess=np.full(11, 700.0),
                                    nstr=(0, 5, 9, 0, 0, 0))
        with pytest.raises(NotImplementedError, match='item 8.1'):
            tapi.run_climate(inputs, None, device='cpu', mesh=object())
        return
    jst, jres, tst, tres = one_profile_step(option)
    flag, temp, dtdp, fnil, fnvl, fpit = tres
    assert flag == jres[0]
    np.testing.assert_allclose(temp, jres[1], rtol=1e-8)
    for got, ref in zip((dtdp, fnil, fnvl, fpit), jres[2:]):
        close(got, ref, rtol=1e-6)
    chem = jst.bundle.inputs['atmosphere']['profile']
    assert list(tst.profile) == list(chem.columns)
    for col in chem.columns:
        np.testing.assert_allclose(tst.profile[col], chem[col].values,
                                   rtol=1e-6)
    if option == 'diseq_chem':
        np.testing.assert_allclose(
            tst.sc_kzz, jst.bundle.inputs['atmosphere']['kzz']['sc_kzz'],
            rtol=1e-6)
    if option in ('cloudy', 'virga_kwargs'):
        for got, ref in zip(tst.cld_hist, jst.cld_hist):
            np.testing.assert_allclose(got, ref, rtol=1e-6)
        assert tst.cld_hist[0].max() > 0
    if option == 'moistgrad':
        assert tst.moist and tst.condensables == jst.condensables
    if option == 'inject_energy':
        np.testing.assert_allclose(
            tst.tidal, jst.data.tidal, rtol=1e-12)
        assert tst.tidal[0] < tst.tidal[-1]
    if option == 'with_spec':
        from picaso_tpu.climate import api as japi
        from picaso_tpu_torch import justdoit as tdi
        from climate_modes_record import CASES, jax_facade_case
        jout = japi._assemble_climate_output(
            jst.bundle, jst, jst.opa, jst.bundle.inputs['climate']
            ['pressure'], jres[1], *jres[2:3], list(jst.last_nstr),
            *jres[3:], chem, jst.tidal, 1.0, 0.0, False, True,
            len(temp))
        tout = tapi._assemble_climate_output(
            tst, jst.bundle.inputs['climate']['pressure'], temp, dtdp,
            list(tst.last_nstr), fnil, fnvl, fpit, tst.profile, flag,
            False, True, jax_facade_case(tdi, CASES['inject_31']),
            tdi.opannection(ck_table=tst.ck, device='cpu'))
        np.testing.assert_allclose(
            np.asarray(tout['spectrum_output']['thermal']),
            np.asarray(jout['spectrum_output']['thermal']), rtol=1e-6)


def test_update_clouds_history():
    """Five virga refreshes at five structures: the 4-deep OPD history,
    the averaged cloud table and the taudif gate's numbers, rtol 1e-12."""
    jst, _, tst, _ = one_profile_step('virga_kwargs')
    pressure = np.asarray(jst.bundle.inputs['climate']['pressure'])
    base = np.asarray(jst.bundle.inputs['climate']['guess_temp'])
    for i, scale in enumerate((1.0, 1.05, 0.97, 1.02, 1.0)):
        temp = base * scale
        jdf, jout = jst.update_clouds(temp, pressure)
        tdf, tout = tst.update_clouds(temp, pressure)
        assert list(tdf) == list(jdf.columns)
        for k in jdf.columns:
            np.testing.assert_allclose(tdf[k], jdf[k].values, rtol=1e-12)
        assert tst.last_taudif == pytest.approx(jst.last_taudif, rel=1e-12)
        assert tst.last_taudif_tol == pytest.approx(jst.last_taudif_tol,
                                                    rel=1e-12)
        for got, ref in zip(tst.cld_hist, jst.cld_hist):
            np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert tst.last_taudif > 0


def test_star_climate_binning():
    """star() of a climate case: the trapezoid bin integration of the
    stellar flux onto the CK grid (justdoit.py:360-377), rtol 1e-12."""
    from picaso_tpu_torch import justdoit as tdi
    js, ts = sliced_tables(4, 192)
    out = []
    for module, table, kw in ((jdi, js, {}), (tdi, ts, dict(device='cpu'))):
        opa = module.opannection(ck_table=table, **kw)
        case = module.inputs(calculation='planet', climate=True)
        case.star(opa, temp=5600, radius=1.0,
                  radius_unit=module.u.Unit('Rsun'), semi_major=0.05,
                  semi_major_unit=module.u.Unit('au'))
        out.append((np.asarray(opa.relative_flux),
                    np.asarray(opa.unshifted_stellar_spec)))
        with pytest.raises(ValueError, match='semi_major'):
            case.star(opa, temp=5600)
    for got, ref in zip(out[1], out[0]):
        np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_climate_inputs_defaults_are_the_facades():
    """ClimateInputs' defaults: one zone, rfaci 1, no star, the facade's
    approx() defaults (TTHG_ray, N=2, quadrature, delta-Eddington, 2
    streams)."""
    case = jdi.inputs(calculation='brown', climate=True)
    tp = case.inputs['approx']['rt_params']['toon']
    common = case.inputs['approx']['rt_params']['common']
    frac = common['TTHG_params']['fraction']
    inputs = tapi.ClimateInputs(t_eff=700.0, gravity=1e4,
                                pressure=np.ones(3), guess=np.ones(3),
                                nstr=(0, 1, 1, 0, 0, 0))
    assert dataclasses.astuple(inputs.controls) == (
        tp['single_phase'], tp['multi_phase'], tp['toon_coefficients'],
        float(frac[0]), float(frac[1]), float(frac[2]),
        float(common['TTHG_params']['constant_back']),
        float(common['TTHG_params']['constant_forward']))
    assert inputs.delta_eddington == common['delta_eddington']
    assert inputs.stream == common['stream']
    assert (inputs.nofczns, inputs.rfaci, inputs.F0PI) == (1, 1.0, None)
