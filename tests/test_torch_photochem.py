"""The port's photochemistry coupling (picaso_tpu_torch.photochem and the
front door's hooks) against the JAX package's, on the CPU in float64.

The ``photochem`` package (Fortran) is on neither machine, so, as
tests/test_photochem_climate.py does, the coupled loop runs with a mock
kinetics object with the wrapper's ``run_for_picaso`` interface, here
duck-typed to the port's profile (a dict of numpy columns, where the JAX
mock takes a DataFrame), and the wrapper itself runs over a fake base
class.  Ported: the mock drives kinetics cold then warm; the kinetics
need ``photochem_init``; the coupled climate (slow, as its namesake); the
save file restores its newest record.  Added: the coupled climate of the
T dwarf at 31 levels on the 48-bin slice against the JAX package's
(tests/photochem_reference.json, tests/photochem_record.py) within
1e-6 K; the wrapper's calls into a fake base class and its outputs
against the JAX wrapper's; ``photochem_init`` against the JAX one; and
the missing package's ImportError, the JAX package's text.
"""

import json
import os
import pickle

import numpy as np
import pandas as pd
import pytest
import torch

from picaso_tpu import justdoit as jdi
from picaso_tpu import photochem as jpc

from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import photochem as tpc
from picaso_tpu_torch.opacities.ck import synthetic_ck_table
from picaso_tpu_torch.photochem import MockKinetics

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(HERE, 'photochem_reference.json')
DT_MAX = 1e-6   # K, the port's whole solves against the JAX package's


def _setup_case(teff=700, nlevel=31):
    ck = synthetic_ck_table(with_per_gas=True, device='cpu')
    opa = tdi.opannection(ck_table=ck, device='cpu')
    case = tdi.inputs(calculation='browndwarf', climate=True)
    case.effective_temp(teff)
    case.gravity(gravity=100, gravity_unit=tdi.u.Unit('m/(s**2)'))
    pressure = np.logspace(-4, 2.5, nlevel)
    temp_guess = np.clip(teff * 1.2 * (pressure / 30) ** 0.1, 250, None)
    case.inputs_climate(temp_guess=temp_guess, pressure=pressure,
                        rcb_guess=28, rfacv=0.0)
    return opa, case


def test_premix_atmosphere_photochem_drives_kinetics():
    _, case = _setup_case()
    nlevel = 21
    case.inputs['atmosphere']['profile'] = {
        'pressure': np.logspace(-4, 2, nlevel),
        'temperature': np.zeros(nlevel) + 900.0,
        'H2': np.zeros(nlevel) + 0.84, 'He': np.zeros(nlevel) + 0.155,
        'CH4': np.linspace(1e-4, 5e-4, nlevel)}
    case.inputs['atmosphere'].setdefault('kzz', {})['sc_kzz'] = \
        np.zeros(nlevel) + 1e9
    pc = MockKinetics()
    case.inputs['climate']['pc'] = pc
    df = case.premix_atmosphere_photochem()
    assert pc.calls == 1
    assert pc.guesses == [False]                 # cold start
    assert np.allclose(df['CH4'], df['CH4'][-1])
    assert case.inputs['atmosphere']['profile'] is df
    stored = case.inputs['photochemistry']['initial_guess']
    np.testing.assert_array_equal(stored['CH4'], df['CH4'])
    # second call warm-starts from the stored steady state
    case.premix_atmosphere_photochem()
    assert pc.guesses[1] is True


def test_premix_atmosphere_photochem_requires_pc():
    _, case = _setup_case()
    nlevel = 11
    case.inputs['atmosphere']['profile'] = {
        'pressure': np.logspace(-4, 2, nlevel),
        'temperature': np.zeros(nlevel) + 900.0}
    with pytest.raises(ValueError, match='photochem_init'):
        case.premix_atmosphere_photochem()
    case.inputs['climate']['pc'] = MockKinetics()
    with pytest.raises(ValueError, match='kzz'):
        case.premix_atmosphere_photochem()


@pytest.mark.slow
def test_photochem_coupled_climate_converges():
    """The full RCE loop with per-iteration kinetics (mocked) converges
    and carries the kinetic abundances into the converged profile."""
    opa, case = _setup_case()
    pc = MockKinetics()
    case.inputs['climate']['pc'] = pc
    out = case.climate(opa, diseq_chem=True, verbose=False)
    temp = out['temperature']
    assert np.isfinite(temp).all()
    assert (np.diff(temp[5:]) > -1e-6).all()
    # kinetics ran every host iteration and warm-started after the first
    assert pc.calls >= 2
    assert pc.guesses[0] is False
    assert all(pc.guesses[1:])
    # the converged chemistry bears the kinetic signature
    prof = case.inputs['atmosphere']['profile']
    assert np.allclose(prof['CH4'], prof['CH4'][-1])


def _write_log(path):
    with open(path, 'ab') as f:
        for scale in (1.0, 2.0, 3.0):     # three appended records
            pickle.dump({'pressure': np.array([1e6, 1e5]),
                         'temperature': np.array([900.0, 700.0]),
                         'Kzz': np.array([1e9, 1e9]),
                         'alt': np.array([0.0, 1e7]),
                         'H2O': np.array([1e-4, 2e-4]) * scale}, f)


def test_save_file_restores_newest_record(tmp_path, monkeypatch):
    """The save_file is an append-log (reference photochem.py:172-180);
    a new adapter must warm-start from the NEWEST steady state, exposed
    as a top-down profile that reinitialize_* can consume."""

    class FakeBase:
        def __init__(self, *a, **k):
            self.gdat = None

    monkeypatch.setattr(tpc, '_require_photochem', lambda: FakeBase)
    fn = tmp_path / 'photochem_log.pkl'
    _write_log(fn)
    pc = tpc.EvoAtmosphereGasGiantPicaso(save_file=str(fn))
    g = pc.initial_guess
    assert g is not None and 'alt' not in g
    # newest record (scale=3), flipped to top-down order
    np.testing.assert_allclose(g['H2O'], [6e-4, 3e-4])
    np.testing.assert_allclose(g['pressure'], [1e5, 1e6])
    missing = tpc.EvoAtmosphereGasGiantPicaso(
        save_file=str(tmp_path / 'none.pkl'))
    assert missing.initial_guess is None


class FakeKinetics:
    """A stand-in for photochem's EvoAtmosphereGasGiant: records each call
    and returns a steady state on its bottom-up climate grid."""

    def __init__(self, *args, **kwargs):
        self.init = (args, kwargs)
        self.log = []
        n = 4
        self.gdat = type('G', (), {})()
        self.gdat.P_clima_grid = np.logspace(2, -3, n) * 1e6
        self.dat = type('D', (), {'species_names': ['H2', 'H2O', 'CH4']})()
        self.sol = {'pressure': self.gdat.P_clima_grid,
                    'temperature': np.linspace(1500.0, 600.0, n),
                    'Kzz': np.full(n, 1e9), 'alt': np.linspace(0, 1e7, n),
                    'H2': np.full(n, 0.9), 'H2O': np.linspace(1e-3, 5e-4, n),
                    'CH4': np.linspace(2e-4, 1e-4, n)}

    def initialize_to_climate_equilibrium_PT(self, *args):
        self.log.append(('init', args))

    def reinitialize_to_new_climate_PT(self, *args):
        self.log.append(('reinit', args))

    def find_steady_state(self):
        return True

    def return_atmosphere_climate_grid(self):
        return self.sol


def _same(port, ref):
    if isinstance(ref, dict):
        assert sorted(port) == sorted(ref)
        for k in ref:
            _same(port[k], ref[k])
    elif isinstance(ref, (tuple, list)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _same(a, b)
    else:
        np.testing.assert_array_equal(np.asarray(port), np.asarray(ref))


def test_adapter_matches_jax(tmp_path, monkeypatch):
    """run_for_picaso cold and warm, and add_concentrations_to_picaso_df,
    through the port's and the JAX package's wrappers over the same fake
    base class: the same calls into it (flipped bottom-up, bar ->
    dyn/cm^2, the warm start's mixing ratios normalised), the same
    profiles out, the same records appended to the save file."""
    monkeypatch.setattr(tpc, '_require_photochem', lambda: FakeKinetics)
    monkeypatch.setattr(jpc, '_require_photochem', lambda: FakeKinetics)
    n = 4
    prof = {'pressure': np.logspace(-3, 2, n),
            'temperature': np.linspace(600.0, 1500.0, n),
            'H2': np.full(n, 0.85), 'H2O': np.full(n, 1e-3),
            'CH4': np.full(n, 2e-4), 'kz': np.full(n, 1e8)}
    kzz = np.logspace(7, 9, n)
    outs, logs, files = [], [], []
    for module, table in ((tpc, dict), (jpc, pd.DataFrame)):
        save = tmp_path / f'{module.__name__}.pkl'
        pc = module.EvoAtmosphereGasGiantPicaso('a', b=2,
                                                save_file=str(save))
        df = table(prof)
        cold = pc.run_for_picaso(df, np.log10(3.0), 0.55, kzz)
        warm = pc.run_for_picaso(df, np.log10(3.0), 0.55, kzz,
                                 df_comp_guess=table(prof))
        norm = pc.add_concentrations_to_picaso_df(df)
        outs.append([{k: np.asarray(v) for k, v in o.items()}
                     for o in (cold, warm, norm)])
        logs.append((pc._pc.init, pc._pc.log))
        with open(save, 'rb') as f:
            files.append([pickle.load(f), pickle.load(f)])
        assert pc.initial_guess is None
    _same(outs[0], outs[1])
    _same(logs[0], logs[1])
    _same(files[0], files[1])
    assert logs[0][1][0][0] == 'init' and logs[0][1][1][0] == 'reinit'


def test_photochem_init_matches_jax(monkeypatch):
    """photochem_init builds the wrapper from atmosphere()'s stored
    arguments, the planet's mass and radius and the TOA pressure, as the
    JAX package's does; without them it raises the same errors."""
    monkeypatch.setattr(tpc, '_require_photochem', lambda: FakeKinetics)
    monkeypatch.setattr(jpc, '_require_photochem', lambda: FakeKinetics)
    prof = {'pressure': np.logspace(-4, 2, 11),
            'temperature': np.linspace(500.0, 1500.0, 11)}
    got = []
    for module, table in ((tdi, dict), (jdi, pd.DataFrame)):
        case = module.inputs()
        case.atmosphere(df=table(prof))
        with pytest.raises(ValueError, match='photochem_init_args'):
            case.photochem_init()
        case.atmosphere(df=table(prof), photochem_init_args={
            'mechanism_file': 'x.yaml', 'nz': 100},
            photochem_TOA_pressure=2e-1)
        case.gravity(gravity=25, gravity_unit=module.u.Unit('m/(s**2)'))
        with pytest.raises(ValueError, match='mass and radius'):
            case.photochem_init()
        case.gravity(mass=1.0, mass_unit=module.u.Unit('M_jup'),
                     radius=1.2, radius_unit=module.u.Unit('R_jup'))
        pc = case.photochem_init()
        assert case.inputs['climate']['pc'] is pc
        got.append((pc._pc.init, pc.gdat.TOA_pressure_avg))
    assert got[0][0][1]['planet_mass'] == pytest.approx(
        got[1][0][1]['planet_mass'], rel=1e-12)
    assert got[0][0][1]['planet_radius'] == pytest.approx(
        got[1][0][1]['planet_radius'], rel=1e-12)
    assert got[0][0][1]['mechanism_file'] == 'x.yaml'
    assert got[0][1] == got[1][1] == 2e-1


def test_missing_package_raises_the_jax_text():
    """Without the photochem package the wrapper raises the JAX package's
    ImportError, word for word; importing the module does not need it."""
    assert tpc.photochem_available() == jpc.photochem_available() is False
    with pytest.raises(ImportError) as want:
        jpc.EvoAtmosphereGasGiantPicaso()
    with pytest.raises(ImportError) as got:
        tpc.EvoAtmosphereGasGiantPicaso()
    assert str(got.value) == str(want.value)
    assert 'photochem' in str(got.value)
    with pytest.raises(ImportError):
        tpc.generate_photochem_rx_and_thermo_files()


def test_mocked_climate_matches_jax_record():
    """The field T dwarf (900 K, log g 5) at 31 levels on the 48-bin slice
    with per-gas tables, diseq_chem with the mocked kinetics, through the
    port's front door against the JAX package's solve of the same case
    (tests/photochem_reference.json): the same converged and cvz_locs,
    the same kinetics calls (cold, then warm), T within 1e-6 K, the Kzz
    and the frozen CH4 within rtol 1e-6."""
    from climate_modes_record import jax_facade_case
    from torch_climate_modes_cases import tables

    with open(REFERENCE) as f:
        rec = json.load(f)['photochem_t900_31']
    spec = rec['case']
    _, ts = tables(spec)
    opa = tdi.opannection(ck_table=ts, device='cpu')
    case = jax_facade_case(tdi, spec)
    pc = MockKinetics()
    case.inputs['climate']['pc'] = pc
    out = case.climate(opa, diseq_chem=True, verbose=False,
                       save_all_profiles=True)
    assert out['converged'] == rec['converged']
    assert [int(i) for i in out['cvz_locs']] == rec['cvz_locs']
    assert pc.calls == rec['calls'] and pc.guesses == rec['guesses']
    assert pc.guesses[0] is False and all(pc.guesses[1:])
    assert len(out['all_profiles']) == rec['profile_steps']
    d_t = np.abs(out['temperature'] - np.asarray(rec['temperature'])).max()
    assert d_t <= DT_MAX, d_t
    np.testing.assert_allclose(out['kzz'], rec['kzz'], rtol=1e-6)
    prof = case.inputs['atmosphere']['profile']
    np.testing.assert_allclose(prof['CH4'], rec['ch4'], rtol=1e-6)
    assert np.allclose(prof['CH4'], prof['CH4'][-1])
