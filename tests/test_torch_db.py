"""The port's sqlite opacity loader, writers and nearest-point query
against the JAX package.

- a database written by the JAX ``build_synthetic_db`` ('regular' and
  '1060' layouts) loads identically through both ``load_opacity_db``s
  (JAX with ``native=False``, the Python row path the port mirrors): with
  ``wave_range``, ``resample``, a ``molecules`` subset, float32 and
  float64 -- every array equal;
- a database written by the port's ``build_synthetic_db`` loads
  identically through the JAX loader, and holds the JAX writer's numbers:
  exactly for 'regular' (float64 numpy band model in both), to 1e-4 dex
  for '1060' (the float32 band model, as tests/test_torch_interp.py);
- ``slice_db`` round-trips: the slice loads as the source loads with the
  same ``wave_range``, and as the JAX ``slice_db``'s slice;
- ``interp_molecular_nearest`` picks the same grid points as the JAX
  function: values to rtol 1e-12 (XLA's and torch's ``10 **`` differ by
  an ulp, as in tests/test_torch_interp.py), while neighbouring grid rows
  differ by far more.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu.opacities import db as jdb
from picaso_tpu.opacities import factory as jfactory

from picaso_tpu_torch.opacities import db as tdb
from picaso_tpu_torch.opacities import factory as tfactory

torch.set_num_threads(1)

WNO = {'regular': np.linspace(1000.0, 12000.0, 150),
       '1060': np.linspace(2000.0, 10000.0, 60)}
MOLS = {'regular': ('H2O', 'CH4', 'CO'), '1060': ('H2O', 'CO')}


def _write(tmp_path_factory, writer, layout):
    path = str(tmp_path_factory.mktemp('db') / f'{layout}.db')
    kw = dict(molecules=MOLS[layout], pt_layout=layout, ntemp=5, npress=4)
    if writer is tfactory:
        kw['device'] = 'cpu'
    writer.build_synthetic_db(path, WNO[layout], **kw)
    return path


@pytest.fixture(scope='module')
def jax_dbs(tmp_path_factory):
    return {layout: _write(tmp_path_factory, jfactory, layout)
            for layout in WNO}


@pytest.fixture(scope='module')
def port_dbs(tmp_path_factory):
    return {layout: _write(tmp_path_factory, tfactory, layout)
            for layout in WNO}


def _assert_same_grid(tgrid, jgrid):
    assert tgrid.molecules == jgrid.molecules
    assert tgrid.continuum_molecules == jgrid.continuum_molecules
    for name in ('wno', 'log_kappa', 'cont_opa', 'cia_temps'):
        got, want = getattr(tgrid, name), np.asarray(getattr(jgrid, name))
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    for name in jgrid.pt._fields:
        np.testing.assert_array_equal(getattr(tgrid.pt, name).numpy(),
                                      np.asarray(getattr(jgrid.pt, name)),
                                      err_msg=name)
    assert tgrid.pt.nc_p.dtype == tgrid.pt.t_offset.dtype == torch.int32


_LOADS = {
    'all': dict(),
    'wave_range': dict(wave_range=[1.2, 3.5]),
    'resample': dict(resample=2),
    'molecules': dict(molecules=['CO', 'XX']),
    'float32': dict(wave_range=[1.2, 3.5], resample=3),
}


def _load_both(path, case):
    kw = dict(_LOADS[case])
    dtype = np.float32 if case == 'float32' else np.float64
    jgrid = jdb.load_opacity_db(path, dtype=dtype, native=False, **kw)
    tgrid = tdb.load_opacity_db(path, dtype=torch.float32 if case ==
                                'float32' else torch.float64,
                                device='cpu', **kw)
    return tgrid, jgrid


@pytest.mark.parametrize('case', list(_LOADS))
@pytest.mark.parametrize('layout', list(WNO))
def test_loader_matches_jax(jax_dbs, layout, case):
    tgrid, jgrid = _load_both(jax_dbs[layout], case)
    if case == 'float32':
        assert tgrid.log_kappa.dtype == torch.float32
        # JAX keeps wno in float64 under x64; the port's grids carry one
        # float dtype
        jgrid = jgrid._replace(wno=np.asarray(jgrid.wno, np.float32))
    _assert_same_grid(tgrid, jgrid)
    if layout == '1060':
        assert tgrid.log_kappa.shape[1] == 1060
        assert tgrid.pt.nc_p.shape == (60,)


@pytest.mark.parametrize('layout', list(WNO))
def test_port_writer_loads_through_jax_loader(port_dbs, jax_dbs, layout):
    tgrid, jgrid = _load_both(port_dbs[layout], 'all')
    _assert_same_grid(tgrid, jgrid)
    ref = jdb.load_opacity_db(jax_dbs[layout], dtype=np.float64,
                              native=False)
    if layout == 'regular':
        _assert_same_grid(tgrid, ref)
    else:
        np.testing.assert_allclose(tgrid.log_kappa.numpy(),
                                   np.asarray(ref.log_kappa), rtol=0,
                                   atol=1e-4)
        np.testing.assert_array_equal(tgrid.cont_opa.numpy(),
                                      np.asarray(ref.cont_opa))


@pytest.mark.parametrize('molecules', [None, ['CH4']])
def test_slice_db_round_trips(jax_dbs, tmp_path, molecules):
    src = jax_dbs['regular']
    window = [1.5, 4.0]
    dst = tfactory.slice_db(src, str(tmp_path / 'slice.db'), window,
                            molecules=molecules)
    jdst = jfactory.slice_db(src, str(tmp_path / 'jslice.db'), window,
                             molecules=molecules)
    got = tdb.load_opacity_db(dst, dtype=torch.float64, device='cpu')
    want = tdb.load_opacity_db(src, wave_range=window, molecules=molecules,
                               dtype=torch.float64, device='cpu')
    _assert_same_grid(got, want)
    _assert_same_grid(got, jdb.load_opacity_db(jdst, dtype=np.float64,
                                               native=False))
    with pytest.raises(ValueError, match='no wavenumber'):
        tfactory.slice_db(src, str(tmp_path / 'empty.db'), [50.0, 60.0])


@pytest.mark.parametrize('layout', list(WNO))
def test_interp_molecular_nearest_matches_jax(jax_dbs, layout):
    tgrid, jgrid = _load_both(jax_dbs[layout], 'all')
    rng = np.random.default_rng(12)
    tlayer = np.concatenate([rng.uniform(100.0, 3000.0, 12), [20.0, 6000.0]])
    player = np.concatenate([10 ** rng.uniform(-5, 2, 12), [1e-9, 1e4]])
    ref = jdb.interp_molecular_nearest(jgrid, jnp.asarray(tlayer),
                                       jnp.asarray(player))
    out = tdb.interp_molecular_nearest(tgrid, torch.as_tensor(tlayer),
                                       torch.as_tensor(player))
    assert out.shape == (len(tgrid.molecules), 14, len(tgrid.wno))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)


def test_connect_round_trips_arrays(tmp_path):
    cur, conn = tdb.connect(str(tmp_path / 'a.db'))
    cur.execute('CREATE TABLE t (id INTEGER PRIMARY KEY, x array)')
    arr = np.random.default_rng(1).normal(size=(3, 5))
    cur.execute('INSERT INTO t (x) VALUES (?)', (arr,))
    cur.execute('SELECT x FROM t')
    np.testing.assert_array_equal(cur.fetchone()[0], arr)
    conn.close()
