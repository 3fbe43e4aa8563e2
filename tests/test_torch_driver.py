"""The port's TOML driver (picaso_tpu_torch.driver) against the JAX
package's (picaso_tpu.driver) on the CPU in float64: load_toml, the priors
and their transform exactly; setup_spectrum_class's profiles and clouds for
each temperature, chemistry and cloud kind at rtol 1e-12; MODEL and
log_likelihood at 3 parameter points for each observation type on
tests/torch_facade_cases.py's synthetic database (transit depths at
RTOL_TRANSIT, the thermal and reflected spectra at RTOL); run() in its
spectrum and retrieval modes against the JAX runs (the JAX run is given
the same float64 table, as torch_facade_cases.connections builds it); the
climate mode (``setup_climate_class`` + ``case.climate``) against the JAX
driver's on the same float64 CK table."""

import copy

import numpy as np
import pandas as pd
import pytest

from picaso_tpu import driver as jdrv
from picaso_tpu import justdoit as jdi
from picaso_tpu.opacities import ck as jck
from picaso_tpu_torch import driver as tdrv
from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch.opacities import ck as tck

import torch_facade_cases as fc

RTOL_PROFILE = 1e-12


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    path = fc.synthetic_db(tmp_path_factory)
    jopa, topa = fc.connections(path)
    config = jdrv.load_toml(jdi.refdata_path('input_tomls',
                                             'driver_example.toml'))
    config['OpticalProperties']['opacity_files'] = path
    config['OpticalProperties']['wave_range'] = None
    config['temperature']['pressure']['nlevel'] = 30
    return dict(path=path, jopa=jopa, topa=topa, config=config)


def test_load_toml_and_priors(setup):
    toml = jdi.refdata_path('input_tomls', 'driver_example.toml')
    assert tdrv.load_toml(toml) == jdrv.load_toml(toml)
    config = copy.deepcopy(setup['config'])
    assert tdrv.load_toml(config) is config
    config['object']['radius']['prior'] = 'gaussian'
    config['object']['radius']['gaussian_kwargs'] = {'mean': 1.2,
                                                     'std': 0.1}
    fit = tdrv.prior_finder(config)
    assert fit == jdrv.prior_finder(config)
    assert [p['path'] for p in fit] == [
        'temperature.isothermal.T', 'chemistry.free.H2O.value',
        'object.radius']
    u = np.random.default_rng(0).random((17, 3))
    np.testing.assert_array_equal(tdrv.prior_transform(fit)(u),
                                  jdrv.prior_transform(fit)(u))
    bad = [dict(fit[0], prior='cauchy')]
    with pytest.raises(ValueError, match='unknown prior'):
        tdrv.prior_transform(bad)(u[:, :1])
    assert tdrv._value({'value': 1.0, 'unit': 'Rjup'}) == jdrv._value(
        {'value': 1.0, 'unit': 'Rjup'})
    params = {'temperature.knots.T_knots.0': 5.0, 'a.b': 1}
    cfg = {'temperature': {'knots': {'T_knots': [1, 2]}}}
    assert tdrv._apply_params(cfg, params) == jdrv._apply_params(cfg, params)


def assert_table(port, ref, rtol=RTOL_PROFILE):
    names = list(ref.columns) if isinstance(ref, pd.DataFrame) else list(ref)
    assert list(port) == names
    for k in names:
        np.testing.assert_allclose(np.asarray(port[k], float),
                                   np.asarray(ref[k], float), rtol=rtol,
                                   atol=0, err_msg=k)


TEMPERATURE = {
    'isothermal': {'T': 1100.0},
    'knots': {'P_knots': [1e-6, 1e-3, 1e0, 1e2],
              'T_knots': [700.0, 900.0, 1300.0, 1800.0]},
    'guillot': {'Teq': 1200.0, 'T_int': 200.0, 'logg1': -1.0,
                'logKir': -1.5, 'alpha': 0.5},
    'madhu_seager_09_noinversion': {'alpha_1': 0.6, 'alpha_2': 0.5,
                                    'P_1': 1e-3, 'P_3': 1.0, 'T_3': 1600.0},
    'madhu_seager_09_inversion': {'alpha_1': 0.6, 'alpha_2': 0.5,
                                  'P_1': 1e-3, 'P_2': 1e-2, 'P_3': 1.0,
                                  'T_3': 1600.0},
    'zj_24': {'pressures': [1e-6, 1e-3, 1e0, 1e2], 'dTs': [100, 200, 300],
              'Tbottom': 2000.0},
    'userfile': {'filename': jdi.jupiter_pt()},
}

CLOUDS = {
    'none': {},
    'hard_grey': {'cloud1_type': 'hard_grey', 'cloud1': {'hard_grey': {
        'g0': 0.3, 'w0': 0.8, 'opd': 2.0, 'p': 0.0, 'dp': 1.5}}},
    'brewster_grey_slab': {'cloud1_type': 'brewster_grey', 'cloud1': {
        'brewster_grey': {'decay_type': 'slab', 'alpha': 1.5, 'ssa': 0.9,
                          'reference_wave': 1.5,
                          'slab_kwargs': {'ptop': -2.0, 'dp': 1.0,
                                          'reference_tau': 3.0}}}},
    'brewster_grey_deck': {'cloud1_type': 'brewster_grey', 'cloud1': {
        'brewster_grey': {'decay_type': 'deck', 'ssa': 0.95,
                          'deck_kwargs': {'ptop': -1.0, 'dp': 0.5,
                                          'reference_tau': 5.0}}}},
}


def _both_cases(config, jopa, topa):
    jcase, _, jpar = jdrv.setup_spectrum_class(config, opa=jopa)
    tcase, _, tpar = tdrv.setup_spectrum_class(config, opa=topa)
    # pandas' float parser and numpy's differ in the last bit of some
    # values of a profile file
    np.testing.assert_allclose(tpar.pressure, jpar.pressure,
                               rtol=RTOL_PROFILE, atol=0)
    assert_table(tcase.inputs['atmosphere']['profile'],
                 jcase.inputs['atmosphere']['profile'])
    return jcase, tcase


@pytest.mark.parametrize('kind', TEMPERATURE)
def test_setup_spectrum_class_temperature(setup, kind):
    config = copy.deepcopy(setup['config'])
    config['temperature']['profile'] = kind
    config['temperature'][kind] = TEMPERATURE[kind]
    _both_cases(config, setup['jopa'], setup['topa'])


@pytest.mark.parametrize('kind', CLOUDS)
def test_setup_spectrum_class_clouds(setup, kind):
    config = copy.deepcopy(setup['config'])
    config['clouds'] = CLOUDS[kind]
    jcase, tcase = _both_cases(config, setup['jopa'], setup['topa'])
    jc = jcase.inputs['clouds']['profile']
    tc = tcase.inputs['clouds']['profile']
    if kind == 'none':
        assert jc is None and tc is None
    else:
        assert_table(tc, jc)


def test_setup_spectrum_class_chemistry_userfile(setup):
    config = copy.deepcopy(setup['config'])
    config['chemistry'] = {'method': 'userfile',
                           'userfile': {'filename': jdi.jupiter_pt()}}
    # the file's 61 levels: the temperature of [temperature] replaces its
    # column (a grid of another length takes np.interp arguments that
    # fail in both packages alike)
    config['temperature']['pressure']['nlevel'] = 61
    _both_cases(config, setup['jopa'], setup['topa'])


def test_setup_spectrum_class_chemistry_visscher(setup):
    """'visscher' chemistry: the premixed table of a CK connection."""
    config = copy.deepcopy(setup['config'])
    config['chemistry'] = {'method': 'visscher'}
    config['temperature']['profile'] = 'guillot'
    config['temperature']['guillot'] = TEMPERATURE['guillot']
    jopa = jdi.opannection(ck_table=jck.synthetic_ck_table(dtype=np.float64))
    topa = tdi.opannection(ck_table=tck.synthetic_ck_table(device='cpu'),
                           device='cpu')
    _both_cases(config, jopa, topa)


THETAS = ([900.0, -3.0], [1250.0, -4.5], [700.0, -2.2])


@pytest.mark.parametrize('obs', ['transmission', 'thermal', 'reflected'])
def test_model_and_log_likelihood(setup, obs):
    config = dict(setup['config'], observation_type=obs)
    fit = jdrv.prior_finder(config)
    data_wno = np.linspace(2000.0, 11000.0, 15)
    rtol = fc.RTOL_TRANSIT if obs == 'transmission' else fc.RTOL
    for theta in THETAS:
        ref = jdrv.MODEL(theta, config, setup['jopa'], fit, data_wno)
        port = tdrv.MODEL(theta, config, setup['topa'], fit, data_wno)
        assert port.dtype == np.float64 and port.shape == (15,)
        np.testing.assert_allclose(port, ref, rtol=rtol, atol=0)
        y = ref * (1 + 0.01 * np.sin(np.arange(15)))
        e = np.abs(ref).mean() * 0.01 + 0 * ref
        jl = jdrv.log_likelihood(theta, config, setup['jopa'], fit,
                                 data_wno, y, e)
        tl = tdrv.log_likelihood(theta, config, setup['topa'], fit,
                                 data_wno, y, e)
        np.testing.assert_allclose(tl, jl, rtol=rtol)


@pytest.fixture
def jax_table_f64(setup, monkeypatch):
    """The JAX driver's opannection loads its table in float32; give its
    run() the float64 connection of torch_facade_cases.connections."""
    monkeypatch.setattr(jdrv.jdi, 'opannection',
                        lambda **kw: setup['jopa'])


def test_run_spectrum_mode(setup, jax_table_f64):
    config = dict(setup['config'], calc_type='spectrum',
                  observation_type='transmission')
    jcase, jout = jdrv.run(config)
    tcase, tout = tdrv.run(config, device='cpu')
    assert isinstance(tcase, tdi.inputs)
    np.testing.assert_array_equal(tout['wavenumber'], jout['wavenumber'])
    np.testing.assert_allclose(tout['transit_depth'], jout['transit_depth'],
                               rtol=fc.RTOL_TRANSIT, atol=0)


def test_run_retrieval_mode(setup, jax_table_f64, tmp_path):
    """tests/test_retrieval.py's temperature recovery at a smaller run:
    the same dead points and samples as the JAX run; the observation CSV
    read through [InputOutput]."""
    config = copy.deepcopy(setup['config'])
    case, opa, _ = tdrv.setup_spectrum_class(config, opa=setup['topa'])
    truth = case.spectrum(opa, calculation='transmission')
    wl = 1e4 / np.asarray(truth['wavenumber'])
    y = np.asarray(truth['transit_depth'])
    e = y * 0 + y.std() * 0.05
    csv = tmp_path / 'data.csv'
    pd.DataFrame({'central_wavelength': wl, 'transit_depth': y,
                  'transit_depth_error': e}).to_csv(csv, index=False)
    config['InputOutput']['observation_data'] = str(csv)
    kw = dict(sampler='nested', nlive=12, max_iter=25, verbose=False,
              dlogz=5.0, walks=3)
    ref = jdrv.run(config, **kw)
    port = tdrv.run(config, device='cpu', **kw)
    assert port['niter'] == ref['niter']
    assert port['fitpars'] == ref['fitpars']
    for key in ('samples', 'logl', 'samples_equal'):
        np.testing.assert_allclose(port[key], ref[key], rtol=1e-6,
                                   err_msg=key)
    t_med = np.median(port['samples_equal'][:, 0])
    assert 600 < t_med < 1400
    # the ensemble sampler from data given directly
    kw = dict(sampler='ensemble', nsteps=3, verbose=False, seed=4)
    ref = jdrv.run(config, data=(wl, y, e), **kw)
    port = tdrv.run(config, data=(wl, y, e), device='cpu', **kw)
    np.testing.assert_allclose(port['chain'], ref['chain'], rtol=1e-6)
    np.testing.assert_allclose(port['log_probs'], ref['log_probs'],
                               rtol=1e-6)


def test_unported_modes_raise(setup):
    """The climate mode: ``setup_climate_class`` given a CK connection (the
    same float64 table, a stride-8 24-bin slice), then ``case.climate`` as
    ``run`` calls it, against the JAX driver's (the same temperatures,
    cvz_locs and chemistry to rtol 1e-8); without a connection ``run``
    opens ``ck_db`` (a missing file raises the loader's error;
    test_climate_mode_opens_ck_db runs one).  ``viz`` draws the JAX
    driver's dashboard of the solved case (Agg backend: the same lines;
    tests/test_torch_plots.py compares every plot)."""
    from test_torch_climate_fluxes import sliced_tables
    config = {'calc_type': 'climate',
              'object': {'gravity': {'value': 100.0, 'unit': 'm/(s**2)'}},
              'climate': {'teff': 700.0, 'nlevel': 25, 'rcb_guess': 18,
                          'run_kwargs': {}}}
    js, ts = sliced_tables(8)
    jcase, jopa = jdrv.setup_climate_class(config,
                                           opa=jdi.opannection(ck_table=js))
    tcase, topa = tdrv.setup_climate_class(
        config, opa=tdi.opannection(ck_table=ts, device='cpu'))
    for key, val in jcase.inputs['climate'].items():
        np.testing.assert_array_equal(tcase.inputs['climate'][key], val)
    ref = jcase.climate(jopa, verbose=False)
    out = tcase.climate(topa, verbose=False)
    assert out['converged'] == ref['converged'] == 1
    assert [int(i) for i in out['cvz_locs']] == [int(i)
                                                 for i in ref['cvz_locs']]
    np.testing.assert_allclose(out['temperature'], ref['temperature'],
                               rtol=1e-8)
    chem = jcase.inputs['atmosphere']['profile']
    prof = tcase.inputs['atmosphere']['profile']
    for col in chem.columns:
        np.testing.assert_allclose(prof[col], chem[col].values, rtol=1e-8)
    with pytest.raises(OSError):
        tdrv.run(dict(config, OpticalProperties={'ck_db': 'x.hdf5'}),
                 device='cpu')
    import matplotlib
    matplotlib.use('Agg')
    spec = {'wavenumber': np.linspace(1000.0, 5000.0, 20),
            'thermal': np.linspace(1.0, 2.0, 20)}
    figs = [drv.viz(case, spec) for drv, case in ((tdrv, tcase),
                                                   (jdrv, jcase))]
    lines = [[np.asarray(line.get_xydata()) for ax in fig.axes
              for line in ax.get_lines()] for fig in figs]
    assert len(lines[0]) == len(lines[1]) > 2
    for a, b in zip(*lines):
        np.testing.assert_allclose(a, b, rtol=1e-8)
    matplotlib.pyplot.close('all')


def test_climate_mode_opens_ck_db(tmp_path):
    """The climate mode with no connection passed: ``run`` opens the TOML's
    ``[OpticalProperties] ck_db`` itself, in each package (a premixed hdf5
    of the stride-8 slice of the synthetic table, written by the port's
    ``write_ck_hdf5``; ``opacity_kwargs`` give the loaders float64 and a
    continuum database on the same 25 bins), and the two solves agree as
    in test_unported_modes_raise."""
    import sqlite3

    from test_torch_climate_fluxes import sliced_tables
    from picaso_tpu_torch.opacities import factory as tfac
    from picaso_tpu_torch.opacities.db import _adapt_array, connect

    _, ts = sliced_tables(8)
    cur, conn = connect(tck.CONTINUUM_DB)
    cur.execute('SELECT molecule, temperature, opacity FROM continuum')
    rows = cur.fetchall()
    conn.close()
    idx = np.arange(196)[::8]
    cont_db = str(tmp_path / 'continuum.db')
    sqlite3.register_adapter(np.ndarray, _adapt_array)
    out_conn = sqlite3.connect(cont_db, detect_types=sqlite3.PARSE_DECLTYPES)
    oc = out_conn.cursor()
    oc.execute('CREATE TABLE header (id INTEGER PRIMARY KEY, '
               'wavenumber_grid array)')
    oc.execute('INSERT INTO header (wavenumber_grid) VALUES (?)',
               (np.asarray(ts.wno, np.float64),))
    oc.execute('CREATE TABLE continuum (id INTEGER PRIMARY KEY, '
               'molecule VARCHAR, temperature FLOAT, opacity array)')
    oc.executemany('INSERT INTO continuum (molecule, temperature, opacity) '
                   'VALUES (?,?,?)',
                   [(m, t, np.asarray(op, np.float64)[idx])
                    for m, t, op in rows])
    out_conn.commit()
    out_conn.close()

    ck_file = str(tmp_path / 'premixed.hdf5')
    species = [c for c in ts.full_abunds
               if c not in ('pressure', 'temperature')]
    tfac.write_ck_hdf5(ck_file, dict(
        kcoeffs=ts.arrays.ln_kappa.numpy(), wno=ts.wno,
        delta_wno=ts.delta_wno, temps=ts.temps, pressures=ts.pressures,
        gauss_pts=ts.gauss_pts, gauss_wts=ts.gauss_wts), species,
        ts.full_abunds)
    config = {'calc_type': 'climate',
              'OpticalProperties': {
                  'ck_db': ck_file, 'opacity_method': 'preweighted',
                  'opacity_kwargs': {'dtype': 'float64',
                                     'continuum_db': cont_db}},
              'object': {'gravity': {'value': 100.0, 'unit': 'm/(s**2)'}},
              'climate': {'teff': 700.0, 'nlevel': 25, 'rcb_guess': 18,
                          'run_kwargs': {}}}
    _, ref = jdrv.run(copy.deepcopy(config), verbose=False)
    case, out = tdrv.run(copy.deepcopy(config), device='cpu', verbose=False)
    assert case.inputs['calculation'] == 'climate'
    assert out['converged'] == ref['converged'] == 1
    assert [int(i) for i in out['cvz_locs']] == [int(i)
                                                 for i in ref['cvz_locs']]
    np.testing.assert_allclose(out['temperature'], ref['temperature'],
                               rtol=1e-8)
