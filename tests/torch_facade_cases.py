"""Shared inputs of the front-door tests (test_torch_justdoit.py,
test_torch_three_d.py, test_torch_phase_curve.py): the same scenes built
through picaso_tpu.justdoit and picaso_tpu_torch.justdoit, and the
comparison of their outputs.

The opacity connection is the synthetic sqlite database of
tests/test_three_d.py (120 wavenumbers, 8 x 6 (T, P) points), loaded by
each package's own loader in float64; the GCM map is test_three_d.py's
hot-spot map.
"""

import numpy as np

from picaso_tpu import justdoit as jdi
from picaso_tpu import raman as jraman
from picaso_tpu.opacities import db as jdb
from picaso_tpu.opacities import factory as jfactory

from picaso_tpu_torch import justdoit as tdi

# kernel twins against the JAX scan path (tests/test_torch_pipeline.py);
# transit is the same arithmetic in both
RTOL = 2e-5
RTOL_TRANSIT = 1e-8


def synthetic_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('opa') / 'synthetic.db')
    jfactory.build_synthetic_db(path, np.linspace(1000.0, 12000.0, 120),
                                ntemp=8, npress=6)
    return path


def connections(path, **kw):
    """(JAX connection, port connection on the CPU) to the database at
    ``path``, both tables in float64.  The JAX ``opannection`` loads its
    table in float32, so its connection is built as ``opannection``
    builds it, around ``load_opacity_db(dtype=float64)``."""
    grid = jdb.load_opacity_db(path, dtype=np.float64)
    jopa = jdi.Opacity(np.asarray(grid.wno), grid=grid,
                       raman_db=jraman.load_raman_db(
                           jdi.refdata_path('opacities', 'raman.txt')), **kw)
    return jopa, tdi.opannection(filename_db=path, device='cpu', **kw)


def gcm(nlevel=25, nlon=12, nlat=8):
    """tests/test_three_d.py's hot-spot map: a warm dayside, H2O, CH4,
    H2 and He."""
    pressure = np.logspace(-4, 2, nlevel)
    lon = np.linspace(-180, 180, nlon)
    lat = np.linspace(-85, 85, nlat)
    base = np.clip(900 * (pressure / 10) ** 0.08, 300, None)
    tmap = np.zeros((nlevel, nlon, nlat))
    for i, lo in enumerate(lon):
        for j, la in enumerate(lat):
            dayside = np.cos(np.radians(lo)) * np.cos(np.radians(la))
            tmap[:, i, j] = base * (1 + 0.2 * max(dayside, 0.0))
    return {'pressure': pressure, 'lat': lat, 'lon': lon,
            'temperature': tmap,
            'H2O': np.zeros_like(tmap) + 1e-3,
            'CH4': np.zeros_like(tmap) + 3e-4,
            'H2': np.zeros_like(tmap) + 0.84,
            'He': np.zeros_like(tmap) + 0.155}


def profile(nlevel=30):
    """A 1D profile of H2O, CH4, H2, He and electrons, as a dict."""
    p = np.logspace(-5, 2, nlevel)
    return {'pressure': p,
            'temperature': np.clip(900 * (p / 10) ** 0.08, 300, None),
            'H2O': np.full(nlevel, 1e-3), 'CH4': np.full(nlevel, 3e-4),
            'H2': np.full(nlevel, 0.84), 'He': np.full(nlevel, 0.155)}


def egp_clouds(nlayer, seed=0):
    """A cloud table on the 196-point EGP grid (nlayer x 196 rows)."""
    rng = np.random.default_rng(seed)
    n = nlayer * 196
    return {'opd': rng.uniform(0.0, 0.3, n), 'g0': rng.uniform(0.5, 0.9, n),
            'w0': rng.uniform(0.8, 0.99, n)}


def planet(case, module, opa, phase=0.3, num_gangle=6, num_tangle=4,
           star=True):
    """phase_angle, gravity (mass and radius) and a 5700 K blackbody star
    at 0.05 AU, in the facade's units."""
    u = module.u
    case.phase_angle(phase, num_gangle=num_gangle, num_tangle=num_tangle)
    case.gravity(mass=1, mass_unit=u.Unit('Mjup'), radius=1.2,
                 radius_unit=u.Unit('Rjup'))
    if star:
        case.star(opa, temp=5700, radius=1, radius_unit=u.Unit('Rsun'),
                  semi_major=0.05, semi_major_unit=u.Unit('AU'))


def assert_same(port, ref, rtol=RTOL, path=''):
    """Every key of the JAX output in the port's, arrays and floats within
    ``rtol`` (transit depths within RTOL_TRANSIT), everything else
    equal."""
    if isinstance(ref, dict):
        assert set(port) == set(ref), (path, set(port) ^ set(ref))
        for key in ref:
            tol = RTOL_TRANSIT if key == 'transit_depth' else rtol
            assert_same(port[key], ref[key], tol, f'{path}/{key}')
        return
    if isinstance(ref, (list, tuple, str)) or ref is None:
        assert list(port) == list(ref) if not isinstance(ref, str) \
            else port == ref, path
        return
    x = np.asarray(port, dtype=float)
    y = np.asarray(ref, dtype=float)
    assert x.shape == y.shape, (path, x.shape, y.shape)
    atol = 1e-12 * np.max(np.abs(y)) if y.size else 0.0
    np.testing.assert_allclose(x, y, rtol=rtol, atol=atol, err_msg=path)
