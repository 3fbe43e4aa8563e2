"""picaso_tpu_torch.justplotit and the port's plot methods against the JAX
package's, with matplotlib's Agg backend.

Each function and method runs on the same inputs in both packages (a
DataFrame for the JAX one where it takes one, the port's dict of columns
for the port), and the figures' data are compared: every line's x/y
data, image array, collection array and path vertices, axis by axis.
Equal to rtol 1e-12 (the same numpy arithmetic); 1e-10 for the
contribution functions, whose Planck function and transit depth run in
torch float64 in the port and in jax float64 in the JAX package (and atol
1e-12 on the transmission contribution function, normalised to 1 per
wavelength, where a layer's share is a difference of two equal depths).
"""

import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from picaso_tpu import analyze as janalyze  # noqa: E402
from picaso_tpu import driver as jdriver  # noqa: E402
from picaso_tpu import justdoit as jdi  # noqa: E402
from picaso_tpu import justplotit as jpi  # noqa: E402
from picaso_tpu import retrieval as jretrieval  # noqa: E402

from picaso_tpu_torch import analyze as tanalyze  # noqa: E402
from picaso_tpu_torch import driver as tdriver  # noqa: E402
from picaso_tpu_torch import justdoit as tdi  # noqa: E402
from picaso_tpu_torch import justplotit as tpi  # noqa: E402
from picaso_tpu_torch import retrieval as tretrieval  # noqa: E402

from torch_facade_cases import (connections, egp_clouds, gcm,  # noqa: E402
                                profile, synthetic_db)

RTOL = 1e-12
RTOL_TORCH = 1e-10


def figure_data(fig):
    """[(axis index, kind, float array)] of everything drawn on ``fig``."""
    if not hasattr(fig, 'axes'):          # a FuncAnimation
        fig = fig._fig
    out = []
    for i, ax in enumerate(fig.axes):
        for line in ax.get_lines():
            out.append((i, 'line', np.asarray(line.get_xydata(), float)))
        for im in ax.get_images():
            out.append((i, 'image', np.ma.getdata(im.get_array())))
        for c in ax.collections:
            arr = c.get_array()
            if arr is not None:
                out.append((i, 'array', np.ma.getdata(arr).astype(float)))
            for path in c.get_paths():
                out.append((i, 'path', np.asarray(path.vertices, float)))
    return out


def assert_same_figure(got, want, rtol=RTOL, atol=0.0):
    got, want = figure_data(got), figure_data(want)
    assert [(i, k, a.shape) for i, k, a in got] == [
        (i, k, a.shape) for i, k, a in want]
    assert got, 'nothing was drawn'
    for (i, kind, a), (_, _, b) in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f'axis {i} {kind}')
    plt.close('all')


def figure(result):
    """The figure of a plot function's return value."""
    if isinstance(result, tuple):
        result = result[0]
    return result


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """A JAX float64 thermal + transmission spectrum with full output and
    its contribution functions, on tests/torch_facade_cases.py's DB."""
    jopa, topa = connections(synthetic_db(tmp_path_factory))
    case = jdi.inputs()
    case.phase_angle(0)
    case.gravity(mass=1.0, mass_unit=jdi.u.Unit('M_jup'),
                 radius=1.1, radius_unit=jdi.u.Unit('R_jup'))
    case.star(jopa, 5700, 0.0, 4.4, radius=1.0,
              radius_unit=jdi.u.Unit('R_sun'), semi_major=0.05,
              semi_major_unit=jdi.u.Unit('au'))
    case.approx(p_reference=1.0)
    case.atmosphere(df=pd.DataFrame(profile()))
    df = case.spectrum(jopa, calculation='thermal+transmission',
                       full_output=True)
    fo = dict(df['full_output'])
    fo['wavenumber'] = np.asarray(df['wavenumber'])
    fo = {k: (np.asarray(v) if not isinstance(v, dict) else
              {kk: np.asarray(vv) if not isinstance(vv, dict) else vv
               for kk, vv in v.items()})
          for k, v in fo.items()}
    contrib = jdi.get_contribution(case, jopa, at_tau=1)
    return jopa, topa, df, fo, contrib


def synthetic_inputs():
    rng = np.random.default_rng(0)
    wno = np.linspace(1000, 10000, 50)
    flux = rng.uniform(0.5, 1.0, 50)
    nlayer = 10
    full = {'layer': {'pressure': np.logspace(-4, 2, nlayer),
                      'temperature': np.linspace(500, 1500, nlayer),
                      'cloud': {'opd': rng.uniform(0, 1, (nlayer, 50)),
                                'g0': np.full((nlayer, 50), 0.8),
                                'w0': np.full((nlayer, 50), 0.9)}},
            'level': {'pressure': np.logspace(-4, 2, nlayer + 1),
                      'temperature': np.linspace(480, 1520, nlayer + 1)},
            'wavenumber': wno,
            'taugas': rng.uniform(0, 1, (nlayer, 50)),
            'taucld': rng.uniform(0, 1, (nlayer, 50)),
            'tauray': rng.uniform(0, 1, (nlayer, 50))}
    cube = rng.uniform(0, 1, (6, 4, 50))
    return rng, wno, flux, nlayer, full, cube


def _cases():
    """(name, function name, JAX args, port args, kwargs) for the plot
    functions on synthetic inputs."""
    rng, wno, flux, nlayer, full, cube = synthetic_inputs()
    cld = {'opd': rng.uniform(0, 1, nlayer * 50),
           'g0': np.zeros(nlayer * 50) + 0.8,
           'w0': np.zeros(nlayer * 50) + 0.9}
    evo = {'age_years': np.logspace(6, 9, 10),
           'Teff1Mj': np.linspace(2000, 500, 10),
           'Teff2Mj': np.linspace(2500, 600, 10)}
    heat = {'asy': [0.0, 0.3, 0.6, 0.9], '0.1': rng.normal(size=4),
            '0.5': rng.normal(size=4), '0.9': rng.normal(size=4)}
    heat_df = pd.DataFrame({k: v for k, v in heat.items() if k != 'asy'},
                           index=heat['asy'])
    profile_t = np.linspace(300, 1800, 12)
    climate = {'pressure': np.logspace(-4, 2, 12),
               'temperature': profile_t, 'cvz_locs': [0, 5, 8, 0, 9, 10]}
    allout = {0.0: {'wavenumber': wno, 'thermal': flux},
              1.5: {'wavenumber': wno, 'thermal': flux * 2}}
    same = {}
    return [
        ('spectrum', (wno, flux), same, dict(R=20)),
        ('spectrum_list', (wno, [flux, flux * 2]), same, dict(R=None)),
        ('spectrum_hires', (wno, flux), same, {}),
        ('plot_errorbar', (wno, flux, flux * 0.1), same, {}),
        ('plot_multierror', (wno, flux), same,
         dict(dy_low=flux * 0.1, dy_up=flux * 0.2, dx_low=wno * 0.01,
              dx_up=wno * 0.02)),
        ('brightness_temperature', (wno, flux * 1e9), same, {}),
        ('flux_at_top', ({'wavenumber': wno, 'thermal': flux},), same, {}),
        ('pt', (), same, dict(pressure=climate['pressure'],
                              temperature=profile_t)),
        ('pt_full_output', (full,), same, {}),
        ('mixing_ratio', (pd.DataFrame({
            'pressure': climate['pressure'], 'temperature': profile_t,
            'H2O': np.full(12, 1e-3), 'CH4': np.full(12, 1e-12),
            'CO': np.logspace(-6, -3, 12)}),), ({
                'pressure': climate['pressure'], 'temperature': profile_t,
                'H2O': np.full(12, 1e-3), 'CH4': np.full(12, 1e-12),
                'CO': np.logspace(-6, -3, 12)},), {}),
        ('photon_attenuation', ({'H2O': np.logspace(-3, 1, 50),
                                 'CH4': np.logspace(-2, 0, 50)}, wno),
         same, {}),
        ('taumap', (cube,), same, dict(wno_index=3)),
        ('map', (cube,), same, dict(wno_index=7)),
        ('disco', (cube, wno), same, dict(wavelength=[2.0, 5.0])),
        ('phase_curve', (allout,), same, dict(collapse='mean')),
        ('phase_snaps', (allout,), same, {}),
        ('pt_adiabat', (climate,), same, {}),
        ('plot_cld_input', (50, nlayer), same, dict(df=cld)),
        ('cloud', (full,), same, {}),
        ('all_optics_1d', (full,), same, {}),
        ('create_heat_map', (full['taugas'],), same, {}),
        ('heatmap_taus', ({'H2O': full['taugas'], 'CH4': full['taucld']},),
         same, {}),
        ('species_contribution', ({'wavenumber': wno, 'taus_per_layer': {
            'H2O': full['taugas'], 'CH4': full['taucld'][0]}},), same, {}),
        ('plot_evolution', ({'hot': pd.DataFrame(evo)},), ({'hot': evo},),
         dict(y='Teff')),
        ('rt_heatmap', (heat_df,), (heat,),
         dict(figure_kwargs={'title': 'pct diff'})),
        ('animate_convergence', (np.stack([profile_t, profile_t * 1.1]),
                                 climate['pressure']), same, {}),
        ('map_4d', ([gcm()] * 3, np.radians([0.0, 90.0, 180.0])), same,
         dict(iz_plot=4)),
    ]


CASES = _cases()


@pytest.mark.parametrize('name,jargs,targs,kw', CASES,
                         ids=[c[0] for c in CASES])
def test_plot_matches_jax(name, jargs, targs, kw):
    fn = name.replace('_list', '').replace('_full_output', '')
    targs = jargs if targs == {} else targs
    want = getattr(jpi, fn)(*jargs, **kw)
    got = getattr(tpi, fn)(*targs, **kw)
    assert_same_figure(figure(got), figure(want))


def test_helpers_match_jax():
    rng, wno, flux, *_ = synthetic_inputs()
    np.testing.assert_array_equal(tpi.bin_errors(wno[::5], wno, flux * 0.1),
                                  jpi.bin_errors(wno[::5], wno, flux * 0.1))
    m = rng.uniform(size=(5, 4))
    np.testing.assert_array_equal(tpi.numba_cumsum(m), jpi.numba_cumsum(m))
    arr = np.array([1.0, 2.0, 2.0, 2.0, 5.0])
    assert tpi.find_nearest_1d(arr, 2.1) == jpi.find_nearest_1d(arr, 2.1)
    arr2 = np.stack([arr, arr[::-1]], axis=1)
    assert tpi.find_nearest_2d(arr2, 2.1) == jpi.find_nearest_2d(arr2, 2.1)
    np.testing.assert_array_equal(tpi.find_nearest_old(arr2, 4.0),
                                  jpi.find_nearest_old(arr2, 4.0))
    for a, b in zip(tpi.lon_lat_to_cartesian(0.3, -0.2, R=2),
                    jpi.lon_lat_to_cartesian(0.3, -0.2, R=2)):
        assert a == b
    d = {'a': {'b': {'w0': [1, 2]}}}
    assert tpi.explore(d, 'w0') == jpi.explore(d, 'w0') == [1, 2]
    with pytest.raises(KeyError):
        tpi.explore(d, 'nope')
    xt, yt = tpi.mean_regrid(wno, flux, R=20)
    xj, yj = jpi.mean_regrid(wno, flux, R=20)
    np.testing.assert_array_equal(xt, xj)
    np.testing.assert_array_equal(yt, yj)
    fig_t, ax_t = plt.subplots()
    fig_j, ax_j = plt.subplots()
    tpi.plot_format(ax_t)
    jpi.plot_format(ax_j)
    assert (ax_t.xaxis.label.get_fontsize()
            == ax_j.xaxis.label.get_fontsize() == 14)
    plt.close('all')


def test_contribution_plots_match_jax(run):
    jopa, topa, _, fo, contrib = run
    got, want = (tpi.thermal_contribution(fo, R=20),
                 jpi.thermal_contribution(fo, R=20))
    np.testing.assert_allclose(got[2], want[2], rtol=RTOL_TORCH)
    assert_same_figure(got[0], want[0], rtol=RTOL_TORCH)
    got, want = (tpi.transmission_contribution(fo, R=20),
                 jpi.transmission_contribution(fo, R=20))
    np.testing.assert_allclose(got[3], want[3], rtol=RTOL_TORCH, atol=1e-12)
    sums = got[3].sum(axis=0)           # bins without samples are NaN
    np.testing.assert_allclose(sums[np.isfinite(sums)], 1.0, atol=1e-6)
    assert_same_figure(got[0], want[0], rtol=RTOL_TORCH, atol=1e-12)
    assert_same_figure(
        tpi.molecule_contribution(contrib, topa, min_pressure=1000.0, R=50),
        jpi.molecule_contribution(contrib, jopa, min_pressure=1000.0, R=50))


def test_grid_fitter_plots_match_jax():
    wno = np.linspace(1000, 10000, 150)
    temps = np.repeat([500.0, 700.0, 900.0], 2)
    gravs = np.tile([100.0, 300.0], 3)
    spectra = np.array([t * (1 + 0.2 * np.sin(wno / 1200 + g / 100))
                        for t, g in zip(temps, gravs)])
    models = {'wavenumber': wno, 'spectra': spectra}
    params = {'teff': temps, 'grav': gravs}
    fitters = (tanalyze.GridFitter('toy', models=models, verbose=False,
                                   grid_parameters=params),
               janalyze.GridFitter('toy', models=models, verbose=False,
                                   grid_parameters=pd.DataFrame(params)))
    wl = 1e4 / np.linspace(1500, 9500, 40)
    y = np.interp(1e4 / wl, wno, spectra[3])
    for f in fitters:
        f.fit_grid('toy', 'obs', wl, y, y * 0 + 5.0)
    t, j = fitters
    assert_same_figure(t.plot_best_fit('toy', 'obs')[0],
                       j.plot_best_fit('toy', 'obs')[0])
    (fig_t, out_t), (fig_j, out_j) = (t.plot_chi_posteriors('toy', 'obs'),
                                      j.plot_chi_posteriors('toy', 'obs'))
    assert list(out_t) == list(out_j) == ['teff', 'grav']
    assert_same_figure(fig_t, fig_j)


def test_plot_atmosphere_matches_jax(run, tmp_path):
    jopa, _, df, _, _ = run
    case = jdi.inputs()
    case.phase_angle(0)
    case.gravity(gravity=25, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.star(jopa, 5700, 0.0, 4.4)
    case.atmosphere(df=pd.DataFrame(profile()))
    out = case.spectrum(jopa, calculation='reflected')
    jdi.output_xarray(out, case, savefile=str(tmp_path / 'bf.nc'))
    figs = {}
    for name, mod in (('port', tanalyze), ('jax', janalyze)):
        fig, ax = mod.plot_atmosphere(str(tmp_path), 'bf.nc',
                                      gas_names=['H2O', 'CH4'])
        assert ax[0].yaxis_inverted()
        fig, ax = mod.plot_atmosphere(str(tmp_path), 'bf.nc', fig=fig,
                                      ax=ax, linestyle='--', color='r',
                                      label='alt')
        assert len(ax[0].lines) == 2
        figs[name] = fig
    assert_same_figure(figs['port'], figs['jax'])


def test_retrieval_plots_match_jax():
    rng = np.random.default_rng(3)
    result = {'samples_equal': rng.normal(size=(200, 3)),
              'fitpars': [{'path': 'a'}, {'path': 'b'}, {'path': 'c'}]}
    assert_same_figure(tretrieval.plot_pair(result, bins=10),
                       jretrieval.plot_pair(result, bins=10))
    assert_same_figure(tretrieval.plot_pair(result, parameters=['c', 'a']),
                       jretrieval.plot_pair(result, parameters=['c', 'a']))
    wl = np.linspace(1, 5, 30)

    def model(theta):
        return theta[0] + theta[1] * np.sin(wl) + 0.1 * theta[2] * wl

    (fig_t, bt), (fig_j, bj) = (
        tretrieval.spread_plot(result, model, wl, y=model([0, 1, 0]),
                               e=np.full(30, 0.1), n_draws=20),
        jretrieval.spread_plot(result, model, wl, y=model([0, 1, 0]),
                               e=np.full(30, 0.1), n_draws=20))
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a, b)
    assert_same_figure(fig_t, fig_j)

    pressure = np.logspace(-4, 2, 15)
    bands = {f'{i}sig_{s}': np.linspace(0.5, 1.0, 30) + (0.1 * i if s == 'hi'
                                                         else -0.1 * i)
             for i in (1, 2, 3) for s in ('lo', 'hi')}
    bands['median'] = np.linspace(0.5, 1.0, 30)
    tband = {k: v * 1000 + 500 for k, v in bands.items()}
    for k in list(tband):
        tband[k] = np.interp(np.linspace(0, 1, 15), np.linspace(0, 1, 30),
                             tband[k])
    evals = {'wavelength': wl, 'bands_spectra': bands,
             'max_logl_spectra': bands['median'] * 1.01,
             'pressure': pressure, 'bands_ptchem': {'temperature': tband},
             'max_logl_ptchem': {'temperature': tband['median'] + 5}}
    for kw in ({}, {'R': 20.0}):
        assert_same_figure(tretrieval.plot_spectra_bands(evals, **kw)[0],
                           jretrieval.plot_spectra_bands(evals, **kw)[0])
    assert_same_figure(
        tretrieval.plot_pressure_bands(evals, 'temperature')[0],
        jretrieval.plot_pressure_bands(evals, 'temperature')[0])


def test_driver_viz_matches_jax(run, tmp_path):
    _, _, df, _, _ = run
    out = {k: np.asarray(df[k]) for k in ('wavenumber', 'thermal',
                                          'transit_depth')}
    figs = {}
    for name, mod, drv in (('port', tdi, tdriver), ('jax', jdi, jdriver)):
        case = mod.inputs()
        prof = profile()
        case.atmosphere(df=prof if mod is tdi else pd.DataFrame(prof))
        clouds = egp_clouds(len(prof['pressure']) - 1)
        case.clouds(df=clouds if mod is tdi else pd.DataFrame(clouds))
        figs[name] = drv.viz(case, out, savefile=str(tmp_path / f'{name}.png'))
        assert (tmp_path / f'{name}.png').exists()
    assert_same_figure(figs['port'], figs['jax'])


def test_4d_plot_hooks(run):
    """atmosphere_4d(plot=True) draws the JAX package's figure; the
    port's clouds_4d(plot=True) draws each phase's rotated opd map (the
    JAX clouds_4d draws nothing)."""
    _, topa, *_ = run
    phases = np.linspace(0, 2 * np.pi, 3, endpoint=False)
    cases = []
    for mod in (tdi, jdi):
        case = mod.inputs(calculation='browndwarf')
        case.phase_curve_geometry('thermal', phases, num_gangle=4,
                                  num_tangle=4)
        plt.close('all')
        case.atmosphere_4d(gcm(), plot=True, iz_plot=3, verbose=False)
        cases.append((case, plt.gcf()))
    (tcase, fig_t), (_, fig_j) = cases
    assert_same_figure(fig_t, fig_j)

    data = gcm()
    cmap = {'lat': data['lat'], 'lon': data['lon'],
            'wavenumber': np.linspace(1000.0, 9000.0, 5),
            'opd': np.random.default_rng(1).uniform(
                size=(6, 5, len(data['lon']), len(data['lat'])))}
    cmap['g0'] = cmap['opd'] * 0 + 0.8
    cmap['w0'] = cmap['opd'] * 0 + 0.9
    plt.close('all')
    per_phase = tcase.clouds_4d(cmap, plot=True, iz_plot=2, iw_plot=1)
    fig = plt.gcf()
    meshes = [np.ma.getdata(c.get_array()) for ax in fig.axes
              for c in ax.collections]
    assert len(per_phase) == len(meshes) == len(phases)
    for mesh, phase, shift in zip(meshes, phases, tcase.inputs['shift']):
        total = (np.degrees(phase) + shift) % 360.0
        rot = tdi.inputs._rotate_lon(cmap, total, lon_axis=2)
        np.testing.assert_array_equal(mesh.ravel(),
                                      rot['opd'][2, 1].T.ravel())
    plt.close('all')
