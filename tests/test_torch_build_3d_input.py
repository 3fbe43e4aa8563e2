"""picaso_tpu_torch.build_3d_input against picaso_tpu.build_3d_input.

Every function on tests/test_build_3d_input.py's synthetic datasets (and
on MITgcm-layout text files written by the port's helpers), the port's
ncio dataset beside the JAX one: bitwise, the same numpy arithmetic.
Then a regridded map feeds the port's 3D front door (``atmosphere_3d``,
``clouds_3d``, ``spectrum(dimension='3d')``) and the JAX one, float64 on
the CPU (tests/torch_facade_cases.py's tolerance).
"""

import numpy as np
import pytest

from picaso_tpu import build_3d_input as jb3d
from picaso_tpu import justdoit as jdi
from picaso_tpu import ncio as jncio

from picaso_tpu_torch import build_3d_input as tb3d
from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import ncio as tncio

from torch_facade_cases import RTOL, connections, synthetic_db


def datasets(nlon=36, nlat=18, nlev=5, lon0=-180.0):
    """tests/test_build_3d_input.py's smooth analytic field, as an
    NCDataset of each package."""
    lon = np.linspace(lon0, lon0 + 356, nlon)
    lat = np.linspace(-87.5, 87.5, nlat)
    lev = np.arange(nlev, dtype=float)
    field = (np.sin(np.radians(lon))[None, :, None]
             + np.cos(np.radians(lat))[None, None, :]
             + lev[:, None, None])
    out = []
    for mod in (jncio, tncio):
        out.append(mod.NCDataset(
            data_vars={'temperature': mod.NCVar(field, ('lev', 'lon', 'lat'),
                                                {}),
                       'scalar': mod.NCVar(lev, ('lev',), {})},
            coords={'lon': mod.NCVar(lon, ('lon',), {}),
                    'lat': mod.NCVar(lat, ('lat',), {}),
                    'lev': mod.NCVar(lev, ('lev',), {})},
            attrs={}, dims={'lon': nlon, 'lat': nlat, 'lev': nlev}))
    return out


def assert_same(got, want):
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize('lon0', [-180.0, 0.0], ids=['pm180', 'global0'])
@pytest.mark.parametrize('target', ['gauss_cheby', 'explicit'])
def test_regrid_xarray_matches_jax(lon0, target):
    jds, tds = datasets(lon0=lon0)
    kw = (dict(num_gangle=6, num_tangle=6, phase_angle=0.3)
          if target == 'gauss_cheby' else
          dict(latitude=np.array([-30.0, 0.0, 45.0]),
               longitude=np.array([-90.0, 0.0, 90.0])))
    assert_same(tb3d.regrid_xarray(tds, **kw), jb3d.regrid_xarray(jds, **kw))


@pytest.mark.parametrize('lon', [np.arange(0.0, 360.0, 30.0),
                                 np.linspace(10, 50, 5)],
                         ids=['global', 'limited_area'])
def test_regrid_to_gauss_cheby_matches_jax(lon):
    lat = np.linspace(-75, 75, 6)
    cube = (np.cos(np.radians(lon))[None, :, None] + lat[None, None, :]
            + np.arange(3.0)[:, None, None])
    gt, ct = tb3d.regrid_to_gauss_cheby(lat, lon, cube, num_gangle=8,
                                        num_tangle=4, phase=0.5)
    gj, cj = jb3d.regrid_to_gauss_cheby(lat, lon, cube, num_gangle=8,
                                        num_tangle=4, phase=0.5)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(gt.latitude, np.asarray(gj.latitude))
    np.testing.assert_array_equal(gt.longitude, np.asarray(gj.longitude))
    src, tgt, vals = tb3d._wrap_longitude(lon, np.array([-170.0, 20.0]),
                                          cube)
    want = jb3d._wrap_longitude(lon, np.array([-170.0, 20.0]), cube)
    for a, b in zip((src, tgt, vals), want):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope='module')
def mitgcm_files(tmp_path_factory):
    """A small synthetic GCM and its MITgcm-layout PT and cloud dumps."""
    root = tmp_path_factory.mktemp('mitgcm')
    ds = tb3d.synthetic_gcm(nlon=16, nlat=8, nlevel=12)
    pt = tb3d.write_mitgcm_pt(str(root / 'pt.txt'), ds)
    cld = tb3d.write_mitgcm_cld(str(root / 'cld.txt'), nlon=6, nlat=4,
                                nlayer=11, nwno_cld=196)
    return ds, pt, cld


def test_rebin_mitgcm_matches_jax(mitgcm_files):
    _, pt, cld = mitgcm_files
    kw = dict(num_gangle=6, num_tangle=4, phase=0.0)
    assert_same(tb3d.rebin_mitgcm_pt(pt, **kw), jb3d.rebin_mitgcm_pt(pt, **kw))
    assert_same(tb3d.rebin_mitgcm_cld(cld, **kw),
                jb3d.rebin_mitgcm_cld(cld, **kw))


def test_synthetic_gcm_regrids_as_jax(mitgcm_files):
    """The synthetic GCM through both packages' regrid_xarray (the JAX
    one given the same arrays in its own ncio types)."""
    ds = mitgcm_files[0]
    jds = jncio.NCDataset(
        data_vars={k: jncio.NCVar(*v) for k, v in ds.data_vars.items()},
        coords={k: jncio.NCVar(*v) for k, v in ds.coords.items()},
        attrs={}, dims=dict(ds.dims))
    kw = dict(num_gangle=10, num_tangle=10, phase_angle=0.0)
    assert_same(tb3d.regrid_xarray(ds, **kw), jb3d.regrid_xarray(jds, **kw))


def test_make_3d_inputs_match_jax():
    p = np.logspace(-4, 2, 9)

    def tfn(pp, lo, la):
        return 1000.0 + 100.0 * np.cos(np.radians(lo)) + 0.1 * la + pp

    def ofn(pp, lo, la):
        return 0.01 * pp * (1.0 + np.sin(np.radians(lo)) ** 2)
    kw = dict(lat=np.linspace(-60, 60, 5), lon=np.linspace(-180, 150, 12),
              molecules={'H2O': 1e-3})
    assert_same(tb3d.make_3d_pt_input(p, tfn, **kw),
                jb3d.make_3d_pt_input(p, tfn, **kw))
    assert_same(tb3d.make_3d_pt_input(p, tfn), jb3d.make_3d_pt_input(p, tfn))
    args = (ofn, p[:-1], kw['lat'], kw['lon'])
    np.testing.assert_array_equal(tb3d.make_3d_cld_input(*args, nwno_cld=7),
                                  jb3d.make_3d_cld_input(*args, nwno_cld=7))


@pytest.fixture(scope='module')
def opas(tmp_path_factory):
    return connections(synthetic_db(tmp_path_factory))


def test_rebinned_map_spectrum_matches_jax(opas, mitgcm_files):
    """rebin_mitgcm_pt and rebin_mitgcm_cld into the 3D front door of
    each package: a cloudy reflected + thermal spectrum on a 6 x 4 disk,
    float64, within the front-door tolerance."""
    _, pt, cld = mitgcm_files
    kw = dict(num_gangle=6, num_tangle=4, phase=0.0)
    out = {}
    for name, mod, b3d, opa in (('jax', jdi, jb3d, opas[0]),
                                ('port', tdi, tb3d, opas[1])):
        prof = b3d.rebin_mitgcm_pt(pt, **kw)
        clouds = b3d.rebin_mitgcm_cld(cld, **kw)
        data = {'pressure': prof['pressure'], 'lat': prof['lat'],
                'lon': prof['lon'], 'temperature': prof['temperature']}
        shape = prof['temperature'].shape
        for mol, vmr in (('H2O', 1e-3), ('CH4', 3e-4), ('H2', 0.84),
                         ('He', 0.155)):
            data[mol] = np.full(shape, vmr)
        case = mod.inputs()
        case.phase_angle(0.0, num_gangle=6, num_tangle=4)
        case.gravity(gravity=25, gravity_unit=mod.u.Unit('m/(s**2)'))
        case.star(opa, 5700, 0.0, 4.4)
        case.atmosphere_3d(data)
        case.clouds_3d(opd=clouds['opd'], g0=clouds['g0'], w0=clouds['w0'],
                       wavenumber=mod.get_cld_input_grid())
        out[name] = case.spectrum(opa, calculation='reflected+thermal',
                                  dimension='3d')
    for key in ('albedo', 'thermal'):
        got = np.asarray(out['port'][key])
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(out['jax'][key]),
                                   rtol=RTOL, err_msg=key)
