"""The port's 3D spectra (picaso_tpu_torch.three_d through the front door)
against the JAX package's, on the CPU in float64.

The hot-spot GCM map of tests/test_three_d.py on a 6 x 4 disk, through
both packages' ``inputs().atmosphere_3d`` and ``spectrum(dimension='3d')``:
the port runs each facet's K1, K5 and K6 twins, one facet after another,
where the JAX package vmaps its scan path over the facets (rtol 2e-5).
The facet selection (``regrid_to_disco``) and the longitude rotation
(``inputs._rotate_lon``) are host-side numpy and agree exactly.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from picaso_tpu import disco as jdisco
from picaso_tpu import justdoit as jdi
from picaso_tpu import three_d as jthree_d

from picaso_tpu_torch import disco as tdisco
from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import three_d as tthree_d

from torch_facade_cases import assert_same, connections, gcm, synthetic_db

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def opas(tmp_path_factory):
    return connections(synthetic_db(tmp_path_factory))


def _cloud_map(nlayer=24, nwno_cld=10, seed=0):
    data = gcm()
    rng = np.random.default_rng(seed)
    shape = (nlayer, nwno_cld, len(data['lon']), len(data['lat']))
    return {'lat': data['lat'], 'lon': data['lon'],
            'wavenumber': np.linspace(1e4 / 2, 1e4 / 0.3, nwno_cld),
            'opd': rng.uniform(0, 1, shape), 'g0': np.full(shape, 0.8),
            'w0': np.full(shape, 0.9)}


@pytest.mark.parametrize('phase', [0.0, 1.0, 4.0])
def test_regrid_to_disco_equals_jax(phase):
    jg = jdisco.make_geometry(phase, 6, 4)
    tg = tdisco.make_geometry(phase, 6, 4)
    for data, axis in ((gcm(), 1), (_cloud_map(), 2)):
        want = jthree_d.regrid_to_disco(data, jg, field_lon_axis=axis)
        got = tthree_d.regrid_to_disco(data, tg, field_lon_axis=axis)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('shift', [0.0, 37.5, 180.0, 300.0])
def test_rotate_lon_equals_jax(shift):
    for data, axis in ((gcm(), 1), (_cloud_map(), 2)):
        want = jdi.inputs._rotate_lon(data, shift, lon_axis=axis)
        got = tdi.inputs._rotate_lon(data, shift, lon_axis=axis)
        assert list(got) == list(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


_THREE_D = {jdi: jthree_d, tdi: tthree_d}


def _case3d(module, opa, calculation, phase=0.0, clouds=False):
    if 'reflected' in calculation:
        case = module.inputs()
        case.phase_angle(phase, num_gangle=6, num_tangle=4)
        case.gravity(gravity=25, gravity_unit=module.u.Unit('m/(s**2)'))
        case.star(opa, 5700, 0.0, 4.4)
    else:
        case = module.inputs(calculation='browndwarf')
        case.phase_angle(phase, num_gangle=6, num_tangle=4)
        case.gravity(gravity=100, gravity_unit=module.u.Unit('m/(s**2)'))
    case.atmosphere_3d(gcm())
    if clouds:
        cmap = _cloud_map()
        geom = case.inputs['disco']
        faceted = _THREE_D[module].regrid_to_disco(cmap, geom,
                                                   field_lon_axis=2)
        case.clouds_3d(opd=faceted['opd'], g0=faceted['g0'],
                       w0=faceted['w0'], wavenumber=cmap['wavenumber'])
    return case


@pytest.mark.parametrize('calculation,phase,clouds', [
    ('thermal', 0.0, False), ('reflected', np.pi / 3, False),
    ('reflected', 0.5, True)], ids=['thermal', 'reflected', 'cloudy'])
def test_3d_matches_jax(opas, calculation, phase, clouds):
    jopa, topa = opas
    kw = dict(calculation=calculation, dimension='3d', full_output=True)
    got = _case3d(tdi, topa, calculation, phase, clouds).spectrum(topa, **kw)
    want = _case3d(jdi, jopa, calculation, phase, clouds).spectrum(jopa, **kw)
    assert_same(got, want)


def test_uniform_3d_matches_1d(opas):
    """A horizontally uniform map reproduces the 1D spectrum
    (tests/test_three_d.py:37): each facet's K6 at one angle against the
    1D K6 at all 24."""
    _, opa = opas
    data = gcm()
    column = np.clip(900 * (data['pressure'] / 10) ** 0.08, 300, None)
    data['temperature'] = np.broadcast_to(
        column[:, None, None], data['temperature'].shape).copy()
    case3 = tdi.inputs(calculation='browndwarf')
    case3.phase_angle(0, num_gangle=6, num_tangle=4)
    case3.gravity(gravity=100, gravity_unit=tdi.u.Unit('m/(s**2)'))
    case3.atmosphere_3d(data)
    out3 = case3.spectrum(opa, calculation='thermal', dimension='3d')
    case1 = tdi.inputs(calculation='browndwarf')
    case1.phase_angle(0, num_gangle=6, num_tangle=4)
    case1.gravity(gravity=100, gravity_unit=tdi.u.Unit('m/(s**2)'))
    case1.atmosphere(df=pd.DataFrame({
        k: (v[:, 0, 0] if np.ndim(v) == 3 else v) for k, v in data.items()
        if k not in ('lat', 'lon')}))
    out1 = case1.spectrum(opa, calculation='thermal')
    np.testing.assert_allclose(out3['thermal'], out1['thermal'], rtol=1e-6)


def test_4d_inputs_equal_jax():
    """atmosphere_4d and clouds_4d: the per-phase profiles and facet clouds
    equal the JAX package's, for both zero points."""
    for zero_point in ('night_transit', 'secondary_eclipse'):
        cases = []
        for module in (jdi, tdi):
            case = module.inputs(calculation='browndwarf')
            case.phase_angle(phase_grid=np.array([0.0, np.pi / 2, np.pi]),
                             num_gangle=6, num_tangle=4,
                             calculation='thermal')
            profiles = case.atmosphere_4d(gcm(), shift=[0.0, 10.0, -20.0],
                                          verbose=False,
                                          zero_point=zero_point)
            clouds = case.clouds_4d(_cloud_map(), verbose=False)
            cases.append((profiles, clouds))
        (jp, jc), (tp, tc) = cases
        for want, got in zip(jp + jc, tp + tc):
            assert list(got) == list(want)
            for key in want:
                np.testing.assert_array_equal(got[key], want[key])


def test_netcdf_input_is_not_ported(tmp_path):
    """NetCDF GCM input is ported now (``ncio``): a path goes through
    ``ncio.gcm_dict`` to the dict the JAX package stores, and a missing
    file raises FileNotFoundError instead of NotImplementedError
    (tests/test_torch_ncio.py holds the rest)."""
    from picaso_tpu_torch import ncio
    data = gcm(nlevel=6, nlon=4, nlat=3)
    path = str(tmp_path / 'gcm.nc')
    ncio.write_netcdf(path, {k: (('pressure', 'lon', 'lat'), v)
                             for k, v in data.items()
                             if k not in ('pressure', 'lat', 'lon')},
                      coords={k: data[k] for k in ('pressure', 'lon',
                                                   'lat')})
    got, want = tdi.inputs(), jdi.inputs()
    got.atmosphere_3d(path)
    want.atmosphere_3d(path)
    for key, val in want.inputs['atmosphere']['profile'].items():
        np.testing.assert_array_equal(
            got.inputs['atmosphere']['profile'][key], val)
    with pytest.raises(FileNotFoundError):
        tdi.inputs().atmosphere_3d(str(tmp_path / 'missing.nc'))
