"""The climate modes' cases for the port's CPU tests.

tests/climate_modes_record.py runs the JAX package's float64 solves and
writes tests/climate_modes_reference.json; each case there carries its
parameters.  This module builds the same problem for the port: the JAX
synthetic CK table (float64, per-gas tables, sliced where the case says)
carried across by ``convert``, and the port's ``ClimateInputs``.
"""

import json
import os

import numpy as np

from climate_modes_record import jax_table, profile_guess

from picaso_tpu_torch import convert
from picaso_tpu_torch.climate import api as tapi

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(HERE, 'climate_modes_reference.json')


def reference():
    with open(REFERENCE) as f:
        return json.load(f)


def port_table(js, device='cpu'):
    """The port's copy of the JAX CKTable ``js`` (per-gas tables too)."""
    arrays = {k: np.asarray(v) for k, v in js.arrays._asdict().items()
              if k != 'continuum_molecules'}
    arrays['continuum_molecules'] = js.arrays.continuum_molecules
    return convert.ck_table_from_numpy(
        arrays, js.molecules,
        {c: js.full_abunds[c].values for c in js.full_abunds.columns},
        js.gauss_pts, js.temps, js.pressures, device=device,
        per_gas=None if js.per_gas is None else np.asarray(js.per_gas),
        per_gas_molecules=js.per_gas_molecules)


def tables(spec):
    """(the JAX table, the port's copy on the CPU) of a case."""
    js = jax_table(spec)
    return js, port_table(js)


def port_inputs(spec):
    """The port's ClimateInputs of a case (the JAX facade's bundle as
    tests/climate_modes_record.py sets it up)."""
    pressure, guess = profile_guess(spec)
    nlevel = spec['nlevel']
    inj = spec['injection']
    return tapi.ClimateInputs(
        t_eff=spec['teff'], gravity=spec['gravity'] * 100.0,
        pressure=pressure, guess=guess,
        nstr=(0, spec['rcb_guess'], nlevel - 2, 0, 0, 0),
        chem_params={'quench': True} if spec['diseq_chem'] else {},
        cloudy=bool(spec['virga_kwargs']),
        virga_kwargs=spec['virga_kwargs'], moistgrad=spec['moistgrad'],
        injection=None if not inj else dict(
            total_energy=inj['total_energy_injection'],
            press_max=inj['press_max_energy'],
            hratio=inj['injection_scalehight']))


DT_MAX = 2.0   # K, the chip's gate (TPU_PARITY.json:9 climate_max_dT)
BALANCE = 1e-3  # of sigma Teff^4 (tests/test_climate.py:97-104)


def flux_balance(out, teff):
    """max |flux_net| / (sigma Teff^4) over the radiative zone of a
    climate output or a recorded solve."""
    from picaso_tpu_torch.climate import core
    net = (out['flux_balance']['flux_net'] if 'flux_balance' in out
           else out['flux_net'])
    resid = np.asarray(net)[:max(int(out['cvz_locs'][1]), 1)]
    return float(np.abs(resid).max() / (core.SIGMA_SB * teff ** 4))


def check_solve(name):
    """A whole solve of the recorded case ``name`` through the port's front
    door on the CPU, held against the JAX package's float64 solve: the same
    converged and cvz_locs, max |dT| <= 2 K, the flux balance <= 1e-3
    where the JAX solve converged and balanced; diseq: the same quench
    levels, at least one, and a finite Kzz within rtol 1e-6; cloudy: the column optical depth within
    rtol 1e-6; with_spec: the thermal spectrum within rtol 1e-6.  Returns
    (the output, the case)."""
    from climate_modes_record import jax_facade_case
    from picaso_tpu_torch import justdoit as tdi
    from picaso_tpu_torch.climate import fused

    rec = reference()[name]
    spec = rec['case']
    _, ts = tables(spec)
    opa = tdi.opannection(ck_table=ts, device='cpu')
    case = jax_facade_case(tdi, spec)
    counts = fused.ClimateCounts()
    out = case.climate(opa, diseq_chem=spec['diseq_chem'],
                       with_spec=spec['with_spec'], verbose=False,
                       counts=counts, save_all_profiles=True)
    assert out['converged'] == rec['converged']
    assert [int(i) for i in out['cvz_locs']] == rec['cvz_locs']
    d_t = np.abs(out['temperature'] - np.asarray(rec['temperature'])).max()
    assert d_t <= DT_MAX, d_t
    assert counts.profile_steps == len(out['all_profiles']) > 0
    if rec['converged'] and flux_balance(rec, spec['teff']) <= BALANCE:
        assert flux_balance(out, spec['teff']) <= BALANCE
    if spec['diseq_chem']:
        assert out['quench_levels'] == rec['quench_levels']
        assert out['quench_levels'] and np.isfinite(out['kzz']).all()
        np.testing.assert_allclose(out['kzz'], rec['kzz'], rtol=1e-6)
        np.testing.assert_array_equal(
            case.inputs['atmosphere']['kzz']['sc_kzz'], out['kzz'])
    if spec['virga_kwargs']:
        col = np.reshape(out['cld_df']['opd'],
                         (spec['nlevel'] - 1, -1)).sum(0)
        np.testing.assert_allclose(col, rec['column_opd'], rtol=1e-6)
        assert col.max() > 0
    if spec['with_spec']:
        np.testing.assert_allclose(
            np.asarray(out['spectrum_output']['thermal']), rec['thermal'],
            rtol=1e-6)
    prof = case.inputs['atmosphere']['profile']
    for col in out['ptchem_df']:
        np.testing.assert_array_equal(prof[col], out['ptchem_df'][col])
    return out, case
