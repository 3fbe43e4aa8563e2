"""The front door's tools in the port against the JAX package's, on the CPU
in float64.

- ``inputs.guillot_pt``, ``TP_line_earth`` and ``pressure_grid``: rtol
  1e-12;
- ``get_contribution`` on tests/torch_facade_cases.py's scene (the
  synthetic database, H2O, CH4, H2, He, CIA, Rayleigh, an EGP cloud
  table): every species' ``taus_per_layer``, ``cumsum_taus`` and
  ``tau_p_surface`` at rtol 1e-10; ``find_press`` exactly;
- ``convert_flux_units`` for every pair of the units the JAX function
  takes, on a wavenumber and a micron grid: rtol 1e-12; ``check_units``;
- ``evolution_track`` by mass, for every mass at an age, and
  ``young_planets``, column for column;
- model save and load (``io_utils.save_model``/``load_model``, the hdf5
  and the NetCDF layouts, and ``output_xarray``/``input_xarray``): a
  file written by either package loads in both, the same profile,
  clouds and spectra, and the reloaded case's spectrum equals the
  original's; ``merge_xarrays`` and ``merge_models``.
"""

import itertools

import numpy as np
import pandas as pd
import pytest
import torch

from picaso_tpu import io_utils as jio
from picaso_tpu import justdoit as jdi

from picaso_tpu_torch import io_utils as tio
from picaso_tpu_torch import justdoit as tdi

import torch_facade_cases as fc

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.fixture(scope='module')
def opas(tmp_path_factory):
    return fc.connections(fc.synthetic_db(tmp_path_factory))


def test_profile_helpers_match_jax():
    for module in (jdi, tdi):
        case = module.inputs()
        case.gravity(gravity=25.0, gravity_unit=module.u.Unit('m/(s**2)'))
        if module is jdi:
            ref = case.guillot_pt(1200.0, T_int=200, logg1=-0.5,
                                  logKir=-1.2, alpha=0.3, nlevel=51)
            ref_params = case.inputs['atmosphere']['pt_params']
            ref_earth = case.TP_line_earth(np.logspace(-5, 1, 60))
            ref_grid = [case.pressure_grid(c) for c in GRIDS]
        else:
            got = case.guillot_pt(1200.0, T_int=200, logg1=-0.5,
                                  logKir=-1.2, alpha=0.3, nlevel=51)
            got_params = case.inputs['atmosphere']['pt_params']
            got_earth = case.TP_line_earth(np.logspace(-5, 1, 60))
            assert case.nlevel == 60
            got_grid = [case.pressure_grid(c) for c in GRIDS]
    for key in ('pressure', 'temperature'):
        np.testing.assert_allclose(got[key], ref[key].values, rtol=RTOL)
        np.testing.assert_allclose(got_earth[key], ref_earth[key].values,
                                   rtol=RTOL)
    assert got_params == ref_params
    for g, r in zip(got_grid, ref_grid):
        np.testing.assert_allclose(g, r, rtol=RTOL)


GRIDS = ({'min': {'value': 1e-4}, 'max': {'value': 100.0}, 'nlevel': 41},
         {'min': {'value': 10.0, 'unit': 'Pa'},
          'max': {'value': 1e5, 'unit': 'mbar'}, 'spacing': 'linear',
          'nlevel': 11})


def scene(module, opa, clouds=True, phase=0.3, angles=(6, 4)):
    case = module.inputs()
    case.phase_angle(phase, num_gangle=angles[0], num_tangle=angles[1])
    u = module.u
    case.gravity(mass=1, mass_unit=u.Unit('Mjup'), radius=1.2,
                 radius_unit=u.Unit('Rjup'))
    case.star(opa, temp=5700, radius=1, radius_unit=u.Unit('Rsun'),
              semi_major=0.05, semi_major_unit=u.Unit('AU'))
    prof = fc.profile()
    case.atmosphere(df=pd.DataFrame(prof))
    if clouds:
        case.clouds(df=pd.DataFrame(fc.egp_clouds(len(prof['pressure'])
                                                  - 1)))
    return case


@pytest.mark.parametrize('at_tau', [1.0, 0.05])
def test_get_contribution_matches_jax(opas, at_tau):
    jopa, topa = opas
    ref = jdi.get_contribution(scene(jdi, jopa), jopa, at_tau=at_tau)
    got = tdi.get_contribution(scene(tdi, topa), topa, at_tau=at_tau)
    assert set(got) == set(ref)
    for part in ref:
        assert set(got[part]) == set(ref[part]), part
        for name, val in ref[part].items():
            np.testing.assert_allclose(got[part][name], np.asarray(val),
                                       rtol=1e-10, atol=0, equal_nan=True,
                                       err_msg=f'{part}/{name}')
    assert {'H2O', 'CH4', 'H2H2', 'rayleigh', 'cloud'} <= set(
        got['taus_per_layer'])
    tau = got['cumsum_taus']['H2O'][:, :7]
    p = np.logspace(-5, 2, tau.shape[0])
    assert tdi.find_press(at_tau, tau, 7, p) == jdi.find_press(at_tau, tau,
                                                               7, p)


FLUX_UNITS = ('erg*cm^(-3)*s^(-1)', 'FLAM', 'FNU', 'Jy', 'mJy', 'W/(m2 um)')


@pytest.mark.parametrize('grid', ['wavenumber', 'micron'])
def test_convert_flux_units_matches_jax(grid):
    rng = np.random.default_rng(4)
    if grid == 'wavenumber':
        x, unit = np.linspace(1000.0, 12000.0, 50), 'cm^(-1)'
    else:
        x, unit = np.linspace(0.8, 10.0, 50), 'um'
    flux = 10.0 ** rng.uniform(2, 8, 50)
    for f_from, f_to in itertools.product(FLUX_UNITS, repeat=2):
        got = tdi.convert_flux_units(x, flux, f_to, xgrid_unit=unit,
                                     f_unit=f_from)
        ref = jdi.convert_flux_units(x, flux, f_to, xgrid_unit=unit,
                                     f_unit=f_from)
        np.testing.assert_allclose(got, ref, rtol=RTOL,
                                   err_msg=f'{f_from} -> {f_to}')
    with pytest.raises(ValueError, match='unsupported'):
        tdi.convert_flux_units(x, flux, 'furlong')
    assert tdi.check_units('cm') is not None
    assert tdi.check_units('not a unit') is None
    assert jdi.check_units('not a unit') is None


def test_evolution_tracks_match_jax():
    got = tdi.evolution_track(mass=3.1)
    ref = jdi.evolution_track(mass=3.1)
    for start in ('hot', 'cold'):
        assert list(got[start]) == list(ref[start].columns)
        for col in ref[start].columns:
            np.testing.assert_array_equal(got[start][col],
                                          ref[start][col].values)
    got = tdi.evolution_track('all', age=3.3e7)
    ref = jdi.evolution_track('all', age=3.3e7)
    assert got == ref
    got, ref = tdi.young_planets(), jdi.young_planets()
    assert list(got) == list(ref.columns)
    for col in ref.columns:
        if col == 'name':
            assert list(got[col]) == list(ref[col])
        else:
            np.testing.assert_array_equal(got[col], ref[col].values)


def _spectrum(module, opa, case):
    return case.spectrum(opa, calculation='reflected+thermal')


@pytest.mark.parametrize('suffix', ['.h5', '.nc'])
def test_model_save_load_round_trips(opas, tmp_path, suffix):
    """Within each package and across them: the reloaded profile, clouds
    and spectra, and the reloaded case's spectrum against the original's
    (at the phase and disk ``load_model`` restores: phase 0, the default
    angles)."""
    jopa, topa = opas
    built = {}
    for name, module, opa, io in (('jax', jdi, jopa, jio),
                                  ('port', tdi, topa, tio)):
        case = scene(module, opa, phase=0.0, angles=(10, 1))
        out = _spectrum(module, opa, case)
        path = str(tmp_path / f'{name}{suffix}')
        if module is tdi:
            assert tdi.output_xarray(out, case, savefile=path,
                                     add_output={'author': 'x'}) == path
        else:
            io.save_model(path, case, out, meta={'author': 'x'})
        built[name] = (case, out, path)

    for writer, reader in itertools.product(built, repeat=2):
        case, out, path = built[writer]
        module, opa = (jdi, jopa) if reader == 'jax' else (tdi, topa)
        if module is tdi:
            loaded, spectra, attrs = tdi.input_xarray(path, opannection=opa)
        else:
            loaded, spectra, attrs = jio.load_model(path, opannection=opa)
        assert attrs['author'] == 'x'
        prof = loaded.inputs['atmosphere']['profile']
        orig = case.inputs['atmosphere']['profile']
        for col in orig:
            np.testing.assert_allclose(np.asarray(prof[col]),
                                       np.asarray(orig[col]), rtol=RTOL)
        for col in ('opd', 'g0', 'w0'):
            np.testing.assert_allclose(
                np.asarray(loaded.inputs['clouds']['profile'][col]),
                np.asarray(case.inputs['clouds']['profile'][col]),
                rtol=RTOL)
        for key in ('albedo', 'thermal'):
            np.testing.assert_allclose(
                np.sort(spectra[key]), np.sort(out[key]), rtol=RTOL)
        # the reader's own original spectrum against the reloaded case's
        ref = built[reader][1]
        again = _spectrum(module, opa, loaded)
        for key in ('albedo', 'thermal', 'fpfs_reflected', 'fpfs_thermal'):
            np.testing.assert_allclose(again[key], ref[key], rtol=1e-9,
                                       err_msg=f'{writer}->{reader} {key}')


def test_merges_match_jax(opas):
    jopa, topa = opas
    out = _spectrum(tdi, topa, scene(tdi, topa))
    half = len(out['wavenumber']) // 2
    ds1 = {k: (v[..., :half + 5] if isinstance(v, np.ndarray)
               and v.shape[-1:] == out['wavenumber'].shape else v)
           for k, v in out.items() if k != 'full_output'}
    ds2 = {k: (v[..., half:] if isinstance(v, np.ndarray)
               and v.shape[-1:] == out['wavenumber'].shape else v)
           for k, v in out.items() if k != 'full_output'}
    got, ref = tdi.merge_xarrays(ds1, ds2), jdi.merge_xarrays(ds1, ds2)
    assert set(got) == set(ref)
    for key, val in ref.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(got[key], val)
    got = tio.merge_models([ds1, ds1])
    ref = jio.merge_models([ds1, ds1])
    assert set(got) == set(ref) and got['n_model'] == 2
    for key, val in ref.items():
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(val))
    assert tio.standard_metadata() == jio.standard_metadata()
