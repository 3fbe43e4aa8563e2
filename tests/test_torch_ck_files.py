"""The port's correlated-k file tooling against the JAX package's, on the
CPU in float64.

- ``factory.compute_k_distribution``, ``compute_ck_molecular`` and
  ``compute_sum_molecular`` (scalar abundances and a per-(T, P) chemistry
  table) on the same synthetic monochromatic database: rtol 1e-12;
- the writers: ``legacy.write_legacy_ascii`` byte for byte (SHA-256) and
  ``factory.write_ck_hdf5`` dataset for dataset;
- ``opacities.ck.load_ck_db`` of each format -- a premixed hdf5, a legacy
  ``ascii_data`` directory (``legacy.synthetic_legacy_table``, the
  layout's 24 species, 73 x 20 (T, P) points, 196 of 200 windows), a
  per-gas directory with ``preload_gases`` -- in both packages: every
  array and the chemistry table equal at rtol 1e-12;
- ``justdoit.opannection(ck_db=...)`` of each (the legacy directory also
  without ``method``), and a resort-rebin thermal spectrum on the per-gas
  directory against the JAX facade's.
"""

import hashlib
import os

import h5py
import numpy as np
import pandas as pd
import pytest
import torch

from picaso_tpu import justdoit as jdi
from picaso_tpu.opacities import ck as jck
from picaso_tpu.opacities import factory as jfac
from picaso_tpu.opacities import legacy as jleg

from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch.opacities import ck as tck
from picaso_tpu_torch.opacities import factory as tfac
from picaso_tpu_torch.opacities import legacy as tleg

torch.set_num_threads(1)

RTOL = 1e-12
GASES = ('H2O', 'CH4', 'CO', 'NH3')


def sha256(path):
    with open(path, 'rb') as f:
        return hashlib.sha256(f.read()).hexdigest()


@pytest.fixture(scope='module')
def mono_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('mono') / 'mono.db')
    jfac.build_synthetic_db(path, np.linspace(1000.0, 5000.0, 300),
                            molecules=('H2O', 'CH4'), ntemp=4, npress=3)
    return path


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    """One file (or directory) of each format, written by the port."""
    root = tmp_path_factory.mktemp('ck')
    legacy_dir = root / 'legacy'
    legacy_dir.mkdir()
    tleg.write_legacy_ascii(str(legacy_dir / 'ascii_data'),
                            **tleg.synthetic_legacy_table())

    syn = tck.synthetic_ck_table(device='cpu', with_per_gas=True)
    ab = syn.full_abunds
    species = [c for c in ab if c not in ('pressure', 'temperature')]
    premixed = str(root / 'premixed.hdf5')
    tfac.write_ck_hdf5(premixed, premix_dict(syn), species, ab)

    per_gas_dir = root / 'per_gas'
    per_gas_dir.mkdir()
    npress, ntemp = len(syn.pressures), len(syn.temps)
    for ig, mol in enumerate(syn.per_gas_molecules):
        with h5py.File(per_gas_dir / f'{mol}_1460.hdf5', 'w') as f:
            f['kcoeffs'] = syn.per_gas[ig].numpy()
            f['wno'] = syn.wno
            f['delta_wno'] = syn.delta_wno
            f['pressures'] = np.tile(syn.pressures, ntemp)
            f['temperatures'] = np.repeat(syn.temps, npress)
            f['gauss_pts'] = syn.gauss_pts
            f['gauss_wts'] = syn.gauss_wts
            f['nc_p'] = np.full(ntemp, npress)
    return dict(premixed=premixed, legacy=str(legacy_dir),
                per_gas=str(per_gas_dir))


def premix_dict(table):
    """A premixed table as the factory's dict (compute_sum_molecular's
    keys)."""
    return dict(kcoeffs=table.arrays.ln_kappa.numpy(), wno=table.wno,
                delta_wno=table.delta_wno, temps=table.temps,
                pressures=table.pressures, gauss_pts=table.gauss_pts,
                gauss_wts=table.gauss_wts)


def load_kwargs(fmt):
    if fmt == 'per_gas':
        return dict(method='resortrebin',
                    preload_gases=list(GASES) + ['CO2'])
    return dict(method='preweighted')


def assert_same_table(port, ref):
    """Every array of a port CKTable against a JAX one, rtol 1e-12."""
    for name, val in ref.arrays._asdict().items():
        got = getattr(port.arrays, name)
        if name == 'continuum_molecules':
            assert got == val
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(val), rtol=RTOL,
                                   err_msg=name)
    assert port.molecules == tuple(ref.molecules)
    assert list(port.full_abunds) == list(ref.full_abunds.columns)
    for col in ref.full_abunds.columns:
        np.testing.assert_allclose(port.full_abunds[col],
                                   ref.full_abunds[col].values, rtol=RTOL,
                                   err_msg=col)
    for name in ('gauss_pts', 'gauss_wts', 'temps', 'pressures', 'wno',
                 'delta_wno'):
        np.testing.assert_allclose(getattr(port, name),
                                   np.asarray(getattr(ref, name)),
                                   rtol=RTOL, err_msg=name)
    assert port.per_gas_molecules == tuple(ref.per_gas_molecules)
    if ref.per_gas is None:
        assert port.per_gas is None
    else:
        np.testing.assert_allclose(port.per_gas.numpy(),
                                   np.asarray(ref.per_gas), rtol=RTOL)


def test_k_distribution_matches_jax():
    rng = np.random.default_rng(3)
    wno = np.sort(rng.uniform(1000.0, 2000.0, 400))
    sigma = 10.0 ** rng.uniform(-26, -20, (2, 3, 400))
    edges = np.linspace(900.0, 2100.0, 14)     # the outer bins are empty
    pts, _ = tck.double_gauss_points()
    np.testing.assert_allclose(
        tfac.compute_k_distribution(sigma, wno, edges, pts),
        jfac.compute_k_distribution(sigma, wno, edges, pts), rtol=RTOL)


def test_ck_molecular_matches_jax(mono_db):
    edges = np.linspace(1000.0, 5000.0, 11)
    got = tfac.compute_ck_molecular(mono_db, 'H2O', edges)
    ref = jfac.compute_ck_molecular(mono_db, 'H2O', edges)
    assert got.keys() == ref.keys() and got['molecule'] == 'H2O'
    for key in got:
        if key != 'molecule':
            np.testing.assert_allclose(got[key], ref[key], rtol=RTOL)


@pytest.mark.parametrize('chemistry', ['scalar', 'per_pt'])
def test_sum_molecular_matches_jax(mono_db, chemistry):
    edges = np.linspace(1000.0, 5000.0, 11)
    if chemistry == 'scalar':
        port_ab = ref_ab = {'H2O': 1e-3, 'CH4': 5e-4}
    else:
        temps, pressures = tfac.default_pt_grid(4, 3)
        t = np.repeat(temps, len(pressures))
        port_ab = {'pressure': np.tile(pressures, len(temps)),
                   'temperature': t, 'H2O': 1e-3 * t / t.max(),
                   'CH4': 5e-4 * t.min() / t}
        ref_ab = pd.DataFrame(port_ab)
    got = tfac.compute_sum_molecular(mono_db, port_ab, edges)
    ref = jfac.compute_sum_molecular(mono_db, ref_ab, edges)
    assert got.keys() == ref.keys()
    for key in got:
        np.testing.assert_allclose(got[key], ref[key], rtol=RTOL)


def test_writers_match_jax(files, tmp_path):
    """The legacy ASCII text byte for byte; the hdf5 datasets exactly,
    with scalar and per-(T, P) abundances."""
    path = str(tmp_path / 'ascii_data')
    jleg.write_legacy_ascii(path, **tleg.synthetic_legacy_table())
    assert sha256(path) == sha256(
        os.path.join(files['legacy'], 'ascii_data'))

    syn = tck.synthetic_ck_table(device='cpu')
    ck = premix_dict(syn)
    species = ['H2O', 'CH4', 'CO', 'NH3']
    for abunds in ({'H2O': 1e-3, 'CH4': 5e-4, 'CO': 3e-4, 'NH3': 1e-4},
                   syn.full_abunds):
        ref_ab = (abunds if np.ndim(abunds['H2O']) == 0
                  else pd.DataFrame(abunds))
        tfac.write_ck_hdf5(str(tmp_path / 'port.h5'), ck, species, abunds)
        jfac.write_ck_hdf5(str(tmp_path / 'jax.h5'), ck, species, ref_ab)
        with h5py.File(tmp_path / 'port.h5') as fp, \
                h5py.File(tmp_path / 'jax.h5') as fj:
            assert sorted(fp) == sorted(fj)
            for name in fj:
                np.testing.assert_array_equal(fp[name][()], fj[name][()])


@pytest.mark.parametrize('fmt', ['premixed', 'legacy', 'per_gas'])
def test_load_ck_db_matches_jax(files, fmt):
    kw = load_kwargs(fmt)
    ref = jck.load_ck_db(files[fmt], dtype=np.float64, **kw)
    got = tck.load_ck_db(files[fmt], device='cpu', **kw)
    assert got.arrays.ln_kappa.dtype == torch.float64
    assert_same_table(got, ref)
    if fmt == 'legacy':
        # the loaded table is the written one, at the text's precision
        tab = tleg.synthetic_legacy_table()
        np.testing.assert_allclose(got.arrays.ln_kappa.numpy(),
                                   tab['kappa'] * np.log(10.0), rtol=RTOL)
        assert got.arrays.ln_kappa.shape == (20, 73, 196, 8)
        assert len(got.molecules) == 24
    if fmt == 'per_gas':
        assert got.per_gas_molecules == GASES      # CO2 has no file


@pytest.mark.parametrize('fmt', ['premixed', 'legacy', 'per_gas'])
def test_opannection_ck_db(files, fmt):
    """``opannection(ck_db=...)`` reads each format; the per-gas
    directory's resort-rebin thermal spectrum against the JAX facade's."""
    kw = load_kwargs(fmt)
    topa = tdi.opannection(ck_db=files[fmt], device='cpu', **kw)
    assert_same_table(topa.climate_ck,
                      jck.load_ck_db(files[fmt], dtype=np.float64, **kw))
    assert topa.ck is topa.climate_ck          # f64 on the CPU: one table
    assert topa.ngauss == 8 and topa.nwno == 196
    if fmt == 'legacy':
        # a ck_db with the default method is a premixed connection
        plain = tdi.opannection(ck_db=files[fmt], device='cpu')
        assert torch.equal(plain.ck.arrays.ln_kappa, topa.ck.arrays.ln_kappa)
    if fmt != 'per_gas':
        return
    from test_torch_justdoit import _spectrum
    from torch_facade_cases import assert_same
    jopa = jdi.opannection(ck_db=files[fmt], dtype=np.float64, **kw)
    spec = dict(calculation='thermal', clouds=None)
    assert_same(_spectrum(tdi, topa, **spec), _spectrum(jdi, jopa, **spec))
