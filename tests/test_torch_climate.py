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
- every option the port does not run yet raises, naming the ROADMAP.
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


@pytest.mark.parametrize('option', UNPORTED)
def test_unported_options_raise(option):
    inputs = tapi.ClimateInputs(t_eff=700.0, gravity=1e4,
                                pressure=np.logspace(-4, 2, 11),
                                guess=np.full(11, 700.0),
                                nstr=(0, 5, 9, 0, 0, 0))
    with pytest.raises(NotImplementedError,
                       match='ROADMAP Queue 1, "the climate modes'):
        tapi.run_climate(inputs, None, device='cpu',
                         **{option: UNPORTED[option]})


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
