"""The port's fitting and posterior tools against the JAX package's:
GridFitter (fits with and without offsets, posteriors, best fits,
gridtrieval interpolation, .h5 and .nc grids on disk), detection_test and
sigma, get_evaluations and get_chisq_max, create_template, and the
wavelength tools conv_non_uniform_R and create_grid_minR."""

import h5py
import numpy as np
import pandas as pd
import pytest

from picaso_tpu import analyze as janalyze
from picaso_tpu import ncio as jncio
from picaso_tpu import retrieval as jretrieval
from picaso_tpu import wavelength as jwave
from picaso_tpu_torch import analyze as tanalyze
from picaso_tpu_torch import retrieval as tretrieval
from picaso_tpu_torch import wavelength as twave

RTOL = 1e-12


def _toy_grid():
    wno = np.linspace(1000, 10000, 150)
    temps = np.repeat([500.0, 700.0, 900.0], 2)
    gravs = np.tile([100.0, 300.0], 3)
    spectra = np.array([t * (1 + 0.2 * np.sin(wno / 1200 + g / 100))
                        for t, g in zip(temps, gravs)])
    return wno, spectra, {'teff': temps, 'grav': gravs}


def _fitters(params=True):
    wno, spectra, grid_params = _toy_grid()
    models = {'wavenumber': wno, 'spectra': spectra}
    j = janalyze.GridFitter('toy', models=models, verbose=False,
                            grid_parameters=pd.DataFrame(grid_params)
                            if params else None)
    t = tanalyze.GridFitter('toy', models=models, verbose=False,
                            grid_parameters=grid_params if params else None)
    return j, t, wno, spectra


def _same(a, b, path=''):
    if isinstance(b, dict):
        assert set(a) == set(b), path
        for k in b:
            _same(a[k], b[k], f'{path}/{k}')
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for x, y in zip(a, b):
            _same(x, y, path)
    elif isinstance(b, str):
        assert a == b, path
    else:
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=RTOL, atol=0, err_msg=path)


@pytest.mark.parametrize('offset', [False, True])
def test_fit_grid_posteriors_best_fit(offset):
    j, t, wno, spectra = _fitters()
    wl = 1e4 / np.linspace(1500, 9500, 40)
    y = np.interp(1e4 / wl, wno, spectra[3]) + 3.0 * offset
    e = y * 0 + 5.0
    _same(t.fit_grid('toy', 'obs', wl, y, e, offset=offset),
          j.fit_grid('toy', 'obs', wl, y, e, offset=offset))
    _same(t.best_fit('toy', 'obs'), j.best_fit('toy', 'obs'))
    assert t.best_fit('toy', 'obs')['parameters'] == {'teff': 700.0,
                                                      'grav': 300.0}
    assert (t.print_best_fit('toy', 'obs', verbose=False)
            == j.print_best_fit('toy', 'obs', verbose=False))
    for par in ('teff', 'grav'):
        _same(t.parameter_posteriors('toy', 'obs', par),
              j.parameter_posteriors('toy', 'obs', par))
        _same(t.get_chi_posteriors('toy', 'obs', par),
              j.get_chi_posteriors('toy', 'obs', par))
    assert t.check_square() == j.check_square() is True


def test_add_data_fit_all_and_as_dict():
    j, t, wno, spectra = _fitters()
    wl = 1e4 / np.linspace(1500, 9500, 30)
    for f in (j, t):
        f.add_data('a', wl, wl * 0 + 0.01,
                   np.interp(1e4 / wl, wno, spectra[1]), wl * 0 + 4.0)
        f.add_data('b', wl[::2], wl[::2] * 0 + 0.01,
                   np.interp(1e4 / wl[::2], wno, spectra[4]),
                   wl[::2] * 0 + 2.0)
    _same(t.fit_all(), j.fit_all())
    _same(t.as_dict(), j.as_dict())


def test_fitter_without_parameters():
    j, t, wno, spectra = _fitters(params=False)
    wl = 1e4 / np.linspace(1500, 9500, 20)
    y = np.interp(1e4 / wl, wno, spectra[2])
    _same(t.fit_grid('toy', 'obs', wl, y, y * 0 + 3.0),
          j.fit_grid('toy', 'obs', wl, y, y * 0 + 3.0))
    assert t.best_fit('toy', 'obs')['parameters'] == {}
    assert t.check_square()


def test_gridtrieval_interpolation():
    j, t, wno, spectra = _fitters()
    _same(t.prep_gridtrieval(['teff', 'grav']),
          j.prep_gridtrieval(['teff', 'grav']))
    for point in ([650.0, 180.0], [10000.0, -5.0], [900.0, 100.0]):
        _same(t.custom_interp(point), j.custom_interp(point))
        _same(t.interp_models(['teff', 'grav'], point),
              j.interp_models(['teff', 'grav'], point))
    wno, spectra, params = _toy_grid()
    part = {k: v[:-1] for k, v in params.items()}
    t2 = tanalyze.GridFitter('p', models={'wavenumber': wno,
                                          'spectra': spectra[:-1]},
                             grid_parameters=part, verbose=False)
    assert not t2.check_square()
    with pytest.raises(ValueError, match='full-factorial'):
        t2.prep_gridtrieval(['teff', 'grav'])


def test_load_grid_h5_and_nc(tmp_path):
    """A directory of .h5 members and xarray-layout .nc members, one of
    them on another wavenumber axis, through add_grid."""
    wno = np.linspace(1000, 10000, 80)
    for i, t in enumerate((600.0, 800.0)):
        with h5py.File(str(tmp_path / f'm{i}.h5'), 'w') as f:
            g = f.create_group('spectra')
            g['wavenumber'] = wno if i == 0 else np.linspace(1000, 10000,
                                                             120)
            g['fpfs_thermal'] = t * (1 + 0.2 * np.sin(
                np.asarray(g['wavenumber']) / 1500))
            f.attrs['teff'] = t
    wl = np.sort(1e4 / wno)
    jncio.write_netcdf(
        str(tmp_path / 'm2.nc'),
        {'fpfs_emission': (('wavelength',),
                           1000.0 * (1 + 0.2 * np.sin(1e4 / wl / 1500)))},
        coords={'wavelength': wl},
        attrs={'teff': 1000.0, 'planet_params': {'mh': 0.5}})
    fitters = []
    for mod, params in ((janalyze, pd.DataFrame({'teff': [1.0]})),
                        (tanalyze, {'teff': [1.0]})):
        f = mod.GridFitter('base', models={'wavenumber': wno,
                                           'spectra': wno[None] * 0 + 1.0},
                           grid_parameters=params, verbose=False)
        f.add_grid('disk', str(tmp_path))
        fitters.append(f)
    j, t = fitters
    _same(t.spectra, j.spectra)
    _same(t.wavenumber, j.wavenumber)
    assert list(t.grid_params) == list(j.grid_params.columns)
    for k in j.grid_params.columns:
        np.testing.assert_array_equal(t.grid_params[k],
                                      np.asarray(j.grid_params[k]))
    assert t.list_of_files == j.list_of_files and 'disk' in t.grids
    wl_obs = 1e4 / np.linspace(1500, 9500, 25)
    y = 800.0 * (1 + 0.2 * np.sin((1e4 / wl_obs) / 1500))
    _same(t.fit_grid('disk', 'obs', wl_obs, y, y * 0 + 5.0),
          j.fit_grid('disk', 'obs', wl_obs, y, y * 0 + 5.0))
    # best_fit of the first grid after another was added
    _same(t.best_fit('disk', 'obs'), j.best_fit('disk', 'obs'))


def test_detection_test_and_sigma():
    wl = np.linspace(1.0, 2.0, 40)
    e = np.full(40, 5.0) / 1e6
    feature = 80.0 * np.exp(-(wl - 1.4) ** 2 / 0.05 ** 2) / 1e6
    kw = dict(nlive=40, max_iter=300, seed=1)
    ref = janalyze.detection_test(wl, feature, e, feature, wl * 0, 1.0, 2.0,
                                  **kw)
    port = tanalyze.detection_test(wl, feature, e, feature, wl * 0, 1.0,
                                   2.0, **kw)
    _same(port, ref)
    assert port['logZ_single'] > port['logZ_line']
    ref = janalyze.detection_test(wl, feature, e, feature, wl * 0, 1.0, 2.0,
                                  molecule_baseline='H2O',
                                  baseline_wavelength=(1.6, 1.9), nlive=30,
                                  max_iter=100, seed=2)
    port = tanalyze.detection_test(wl, feature, e, feature, wl * 0, 1.0,
                                   2.0, molecule_baseline='H2O',
                                   baseline_wavelength=(1.6, 1.9),
                                   nlive=30, max_iter=100, seed=2)
    _same(port, ref)
    for lnz in ((10.0, 0.0), (1.0, 0.0), (0.5, 0.0), (5.0, 2.0)):
        _same(tanalyze.sigma(*lnz), janalyze.sigma(*lnz))
    _same(tanalyze.chi_squared(np.ones(5), np.ones(5) * 2, np.zeros(5)),
          janalyze.chi_squared(np.ones(5), np.ones(5) * 2, np.zeros(5)))


class _Toy:
    def __init__(self, t, table):
        p = np.logspace(-4, 2, 10)
        self.inputs = {'atmosphere': {'profile': table({
            'pressure': p, 'temperature': np.full(10, 500.0 + t[0]),
            'H2O': np.full(10, 1e-3 * (1 + t[0])),
            'CO2': np.full(10, 1e-6)})}}


def _model(table):
    wno = np.linspace(1000, 2000, 30)

    def model(theta, return_ptchem=False):
        if return_ptchem:
            return _Toy(theta, table)
        return wno, 1.0 + theta[0] * np.linspace(0.5, 1.5, 30), {'d1': 0.01}, 0.0
    return model


@pytest.mark.parametrize('regrid', [False, 'wno', 50.0])
def test_get_evaluations_and_chisq_max(regrid):
    samples = np.random.default_rng(0).normal(0, 0.1, (200, 1))
    best = samples[np.argmax(samples[:, 0])]
    if regrid == 'wno':
        regrid = np.linspace(1100, 1900, 12)
    ref = jretrieval.get_evaluations(samples, best, _model(pd.DataFrame), 25,
                                     regrid=regrid)
    port = tretrieval.get_evaluations(samples, best, _model(dict), 25,
                                      regrid=regrid)
    ref['max_logl_ptchem'] = {k: np.asarray(v) for k, v in
                              ref['max_logl_ptchem'].items()}
    _same(port, ref)
    data = {'d1': (np.linspace(1100, 1900, 12), np.full(12, 1.0),
                   np.full(12, 0.1)),
            'd2': (np.linspace(1150, 1850, 7), np.full(7, 1.1),
                   np.full(7, 0.2))}
    _same(tretrieval.get_chisq_max(port, data),
          jretrieval.get_chisq_max(ref, data))


def test_info_summary_and_data_output(tmp_path):
    res = {'samples_equal': np.random.default_rng(1).normal(size=(50, 2)),
           'logz': -3.5, 'weights': np.ones(50) / 50,
           'fitpars': [{'path': 'a'}, {'path': 'b'}]}
    _same(tretrieval.get_info(res), jretrieval.get_info(res))
    assert tretrieval.summary(res) == jretrieval.summary(res)
    fn = tretrieval.data_output(res, str(tmp_path / 'post.npz'))
    saved = np.load(fn)
    np.testing.assert_array_equal(saved['samples'], res['samples_equal'])
    import matplotlib
    matplotlib.use('Agg')
    figs = [mod.plot_pair(res) for mod in (tretrieval, jretrieval)]
    data = [[np.asarray(c.get_array()) for ax in fig.axes
             for c in ax.collections] for fig in figs]
    assert len(data[0]) == len(data[1]) == 1      # the one 2D histogram
    np.testing.assert_array_equal(data[0][0], data[1][0])
    matplotlib.pyplot.close('all')


@pytest.mark.parametrize('kind', ['free', 'grid', 'gridplus', 'line'])
def test_create_template(tmp_path, kind):
    path = tretrieval.create_template(kind, output_dir=str(tmp_path))
    text = open(path).read()
    compile(text, path, 'exec')
    assert 'picaso_tpu_torch' in text
    assert 'pandas' not in text
    assert 'from picaso_tpu import' not in text
    assert 'from picaso_tpu.' not in text
    with pytest.raises(ValueError):
        tretrieval.create_template('other', output_dir=str(tmp_path))


def test_conv_non_uniform_R_and_create_grid_minR():
    import torch
    rng = np.random.default_rng(3)
    model_wl = np.linspace(1.0, 5.0, 600)
    flux = 1.0 + 0.5 * np.sin(8 * model_wl) + 0.05 * rng.standard_normal(600)
    obs_wl = np.linspace(1.2, 4.8, 25)
    R = np.linspace(50.0, 200.0, 25)
    ref = np.asarray(jwave.conv_non_uniform_R(flux, model_wl, R, obs_wl))
    np.testing.assert_array_equal(
        twave.conv_non_uniform_R(flux, model_wl, R, obs_wl), ref)
    out = twave.conv_non_uniform_R(torch.tensor(flux), model_wl, R, obs_wl)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL)
    for args in ((1.0, 5.0, 100.0), (0.3, 14.0, 5000.0)):
        (g, d), (jg, jd) = twave.create_grid_minR(*args), \
            jwave.create_grid_minR(*args)
        np.testing.assert_array_equal(g, jg)
        assert d == jd
