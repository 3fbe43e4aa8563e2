"""The port's NetCDF layer (picaso_tpu_torch.ncio) against the JAX
package's: the bundled WASP-17b classic file read by both packages, equal;
NetCDF-4 files written by one package and read by the other, both ways;
GCM input to atmosphere_3d / atmosphere_4d / clouds_4d from a path."""

import builtins

import numpy as np
import pandas as pd
import pytest

from picaso_tpu import justdoit as jdi
from picaso_tpu import ncio as jncio
from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import ncio as tncio

import torch_facade_cases as fc


def assert_same_dataset(port, ref):
    assert isinstance(port, tncio.NCDataset)
    assert port.attrs == ref.attrs
    assert port.dims == ref.dims
    for part in ('data_vars', 'coords'):
        a, b = getattr(port, part), getattr(ref, part)
        assert list(a) == list(b), part
        for name in b:
            assert a[name].dims == b[name].dims, name
            assert a[name].attrs == b[name].attrs, name
            np.testing.assert_array_equal(a[name].values, b[name].values,
                                          err_msg=name)


def test_w17_classic_file_equal():
    assert tdi.w17_data() == jdi.w17_data()
    port = tncio.read_netcdf(tdi.w17_data())
    assert_same_dataset(port, jncio.read_netcdf(jdi.w17_data()))
    assert port['transit_depth'].values.shape == (28,)
    assert 'central_wavelength' in port.coords


def test_classic_file_needs_no_h5py(monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == 'h5py':
            raise ImportError('no h5py')
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', no_h5py)
    ds = tncio.read_netcdf(tdi.w17_data())
    assert len(ds['transit_depth'].values) == 28


def test_netcdf4_needs_h5py_error_names_file(tmp_path, monkeypatch):
    path = str(tmp_path / 'x.nc')
    tncio.write_netcdf(path, {'a': (('n',), np.arange(3.0))})
    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == 'h5py':
            raise ImportError('no h5py')
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, '__import__', no_h5py)
    with pytest.raises(ImportError, match='x.nc'):
        tncio.read_netcdf(path)


def _write(module, path):
    rng = np.random.default_rng(4)
    return module.write_netcdf(
        path,
        {'temperature': (('pressure', 'lon', 'lat'), rng.random((5, 4, 3)),
                         {'units': 'K'}),
         'flux': module.NCVar(rng.random((7,)), ('wavelength',),
                              {'note': 'binned', 'meta': {'R': 100}}),
         'scratch': (('n_aux',), np.arange(6, dtype=np.int32))},
        coords={'pressure': (np.logspace(-3, 2, 5), {'units': 'bar'}),
                'lon': np.linspace(-180, 180, 4),
                'lat': np.linspace(-60, 60, 3),
                'wavelength': np.linspace(1, 5, 7)},
        attrs={'planet_params': {'mass': 1.0, 'radius': 1.2},
               'author': 'test', 'n': 3})


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_netcdf4_round_trip_across_packages(tmp_path, writer):
    path = str(tmp_path / f'{writer}.nc')
    _write(jncio if writer == 'jax' else tncio, path)
    port, ref = tncio.read_netcdf(path), jncio.read_netcdf(path)
    assert_same_dataset(port, ref)
    assert port.attrs['author'] == 'test'
    assert port['temperature'].dims == ('pressure', 'lon', 'lat')
    assert port['scratch'].dims == ('n_aux',)
    # gcm_dict transposes to [pressure, lon, lat] alike
    gp, gr = tncio.gcm_dict(path), jncio.gcm_dict(path)
    assert list(gp) == list(gr)
    for k in gr:
        np.testing.assert_array_equal(gp[k], gr[k])


def _gcm_file(path, nlevel=12, nlon=6, nlat=4):
    """torch_facade_cases.gcm's map as an xarray-layout NetCDF file, its
    fields stored [lat, lon, pressure] so gcm_dict must transpose them."""
    data = fc.gcm(nlevel=nlevel, nlon=nlon, nlat=nlat)
    fields = {k: (('lat', 'lon', 'pressure'),
                  np.transpose(v, (2, 1, 0)))
              for k, v in data.items()
              if k not in ('pressure', 'lat', 'lon')}
    tncio.write_netcdf(path, fields, coords={'pressure': data['pressure'],
                                             'lon': data['lon'],
                                             'lat': data['lat']})
    return data


def test_atmosphere_3d_from_a_path(tmp_path):
    path = str(tmp_path / 'gcm.nc')
    data = _gcm_file(path)
    for module, source in ((jdi, path), (jdi, jncio.read_netcdf(path)),
                           (tdi, path), (tdi, tncio.read_netcdf(path))):
        case = module.inputs()
        case.atmosphere_3d(source)
        prof = case.inputs['atmosphere']['profile']
        assert case.nlevel == 12
        for k in ('pressure', 'lat', 'lon', 'temperature', 'H2O'):
            np.testing.assert_array_equal(prof[k], data[k])


def test_atmosphere_4d_and_clouds_4d_from_paths(tmp_path):
    path = str(tmp_path / 'gcm.nc')
    _gcm_file(path)
    nlayer, nw, nlon, nlat = 11, 5, 6, 4
    rng = np.random.default_rng(2)
    cld = {k: rng.random((nlat, nlon, nw, nlayer))
           for k in ('opd', 'g0', 'w0')}
    cpath = str(tmp_path / 'clouds.nc')
    tncio.write_netcdf(
        cpath, {k: (('lat', 'lon', 'wno', 'pressure'), v)
                for k, v in cld.items()},
        coords={'pressure': np.logspace(-3, 2, nlayer),
                'wno': np.linspace(1000, 5000, nw),
                'lon': np.linspace(-180, 180, nlon),
                'lat': np.linspace(-60, 60, nlat)})
    phases = np.linspace(0, 2 * np.pi, 3, endpoint=False)
    outs = []
    for module in (jdi, tdi):
        case = module.inputs()
        case.phase_angle(phase_grid=phases, num_gangle=3, num_tangle=3,
                         calculation='reflected')
        prof = case.atmosphere_4d(path, verbose=False)
        clds = case.clouds_4d(cpath, verbose=False)
        outs.append((prof, clds, case.inputs['clouds']['wavenumber']))
    (jp, jc, jw), (tp, tc, tw) = outs
    np.testing.assert_array_equal(tw, jw)
    for a, b in zip(tp, jp):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    for a, b in zip(tc, jc):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
