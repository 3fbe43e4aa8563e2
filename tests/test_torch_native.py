"""picaso_tpu_torch.native (the C++ opacity-database decode) against the
port's numpy decode and the JAX package's loaders.

As tests/test_native.py does for the JAX package: the library builds (into
the port's build directory), its float32 arrays are bitwise the numpy
decode's (whole table, and a window with a resample stride), the direct
entry points fill what the DB lacks, and ``native=True`` warns, naming
the reason, where it cannot be used.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from picaso_tpu import native as jnative
from picaso_tpu.opacities import db as jdb
from picaso_tpu.opacities import factory as jfactory

from picaso_tpu_torch import native
from picaso_tpu_torch._build import _BUILD_ROOT
from picaso_tpu_torch.opacities import db


@pytest.fixture(scope='module')
def small_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('ndb') / 'small.db')
    jfactory.build_synthetic_db(path, np.linspace(1000.0, 12000.0, 300),
                                ntemp=6, npress=5)
    return path


def load(path, native_flag, **kw):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        grid = db.load_opacity_db(path, dtype=torch.float32, device='cpu',
                                  native=native_flag, **kw)
    return grid, [str(w.message) for w in caught]


def test_native_builds_into_the_build_directory():
    assert native.available(), native.unavailable_reason()
    so = native.build()
    assert so.startswith(os.path.join(_BUILD_ROOT, 'native'))
    assert os.path.exists(so)


@pytest.mark.parametrize('kw', [{}, dict(wave_range=[1.0, 5.0], resample=2)],
                         ids=['whole', 'window_resample'])
def test_native_python_parity(small_db, kw):
    """Bitwise: the C++ decode, the numpy decode, and the JAX package's
    C++ loader."""
    g_nat, msgs = load(small_db, True, **kw)
    g_py, _ = load(small_db, False, **kw)
    assert msgs == []
    assert torch.equal(g_nat.log_kappa, g_py.log_kappa)
    assert torch.equal(g_nat.cont_opa, g_py.cont_opa)
    assert g_nat.molecules == g_py.molecules
    g_jax = jdb.load_opacity_db(small_db, native=True, **kw)
    np.testing.assert_array_equal(g_nat.log_kappa.numpy(),
                                  np.asarray(g_jax.log_kappa))
    np.testing.assert_array_equal(g_nat.cont_opa.numpy(),
                                  np.asarray(g_jax.cont_opa))


def test_default_is_native_for_float32_only(small_db, monkeypatch):
    """native=None: the C++ decode for a float32 load, numpy for float64,
    without a warning."""
    calls = []
    real = native.load_molecular
    monkeypatch.setattr(native, 'load_molecular',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    _, msgs = load(small_db, None)
    assert calls == [1] and msgs == []
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        db.load_opacity_db(small_db, device='cpu')
    assert calls == [1]


def test_direct_api_and_missing_molecule(small_db):
    out = native.load_molecular(small_db, ['H2O'], 30, np.arange(10))
    want = jnative.load_molecular(small_db, ['H2O'], 30, np.arange(10))
    assert out.shape == (1, 30, 10) and np.isfinite(out).all()
    np.testing.assert_array_equal(out, want)
    missing = native.load_molecular(small_db, ['NOT_A_MOL'], 30,
                                    np.arange(5))
    assert (missing == -50.0).all()
    cont = native.load_continuum(small_db, ['NOT_A_MOL'], [500.0],
                                 np.arange(5))
    assert (cont == 0.0).all()


def test_warns_when_the_library_cannot_load(small_db, monkeypatch):
    """A library that cannot be built: native=True warns with the reason
    and decodes with numpy; the same arrays."""
    def no_compiler(force=False):
        raise FileNotFoundError(2, 'No such file or directory', 'g++')
    monkeypatch.setattr(native, 'build', no_compiler)
    monkeypatch.setattr(native, '_lib', None)
    monkeypatch.setattr(native, '_reason', None)
    assert not native.available()
    assert 'g++' in native.unavailable_reason()
    grid, msgs = load(small_db, True)
    assert len(msgs) == 1 and 'unavailable' in msgs[0] and 'g++' in msgs[0]
    ref, _ = load(small_db, False)
    assert torch.equal(grid.log_kappa, ref.log_kappa)


def test_warns_on_float64_and_on_a_blob_it_cannot_read(small_db, tmp_path):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        db.load_opacity_db(small_db, device='cpu', native=True)
    assert any('float32' in str(w.message) for w in caught)

    from picaso_tpu_torch.opacities.ingest import (build_skeleton,
                                                   insert_wno_grid)
    bad = str(tmp_path / 'f4.db')
    build_skeleton(bad)
    insert_wno_grid(bad, np.linspace(1000.0, 2000.0, 8))
    cur, conn = db.connect(bad)
    for ptid in (1, 2):
        cur.execute('INSERT INTO molecular (ptid, molecule, temperature, '
                    'pressure, opacity) values (?,?,?,?,?)',
                    (ptid, 'H2O', 500.0, float(ptid),
                     np.ones(8, np.float32)))
    conn.commit()
    conn.close()
    grid, msgs = load(bad, True)
    assert len(msgs) == 1 and 'failed' in msgs[0]
    assert torch.equal(grid.log_kappa, torch.zeros_like(grid.log_kappa))
