"""The port's Raman module against picaso_tpu.raman.

The tables are read by both (pandas there, numpy here) and compared field
by field (rtol 1e-15 where pandas' float parser rounds the last digit); the port's vectorised ``bin_star``/``compute_stellar_shifts``
against the JAX package's loop on small grids, empty bins (NaN) and the
strict left edge of bin 0 included; ``raman_factor_oklopcic`` in float64
on seeded inputs (rtol 1e-12: the same sums, the einsum order may
differ).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu import raman as jraman

from picaso_tpu_torch import raman as traman

torch.set_num_threads(1)

RAMAN_TXT = f'{traman.REFDATA_OPACITIES}/raman.txt'


@pytest.fixture(scope='module')
def dbs():
    return jraman.load_raman_db(RAMAN_TXT), traman.load_raman_db()


def test_load_raman_db_matches_jax(dbs):
    jdb, tdb = dbs
    assert len(tdb['c']) == len(jdb) == 56
    for key in ('ji', 'jf', 'vf', 'deltanu'):
        np.testing.assert_array_equal(tdb[key], jdb[key].values, err_msg=key)
    # pandas' float parser may round the last digit otherwise
    np.testing.assert_allclose(tdb['c'], jdb['c'].values, rtol=1e-15)
    assert np.abs(tdb['c']).max() == 1.0
    assert tdb['ji'].dtype.kind == 'i'


def test_raman_factor_pollack_matches_jax():
    wave = 1e4 / np.linspace(300.0, 33000.0, 257)
    refdata = traman.REFDATA_OPACITIES.rsplit('/', 1)[0]
    want = jraman.raman_factor_pollack(7, wave, refdata_dir=refdata)
    got = traman.raman_factor_pollack(7, wave)
    assert got.shape == (7, 257)
    np.testing.assert_allclose(got, want, rtol=1e-15)
    np.testing.assert_array_equal(
        traman.raman_factor_pollack(7, wave, refdata_dir=refdata), got)


def _star(case):
    """(model grid, stellar grid, flux) of a binning case."""
    rng = np.random.default_rng(5 + case)
    if case == 0:   # the fine-grid layout of inputs.star, 5x oversampled
        new = np.linspace(1000.0, 9000.0, 120)
        old = np.linspace(new[0] - 2000, new[-1] + 6000, len(new) * 5)
    elif case == 1:  # coarse stellar grid: empty bins (NaN in both)
        new = np.linspace(1000.0, 9000.0, 200)
        old = np.linspace(500.0, 12000.0, 90)
    elif case == 2:  # unsorted, irregular stellar grid
        new = np.sort(rng.uniform(2000.0, 8000.0, 60))
        old = rng.uniform(1500.0, 9000.0, 900)
    else:            # stellar points exactly on the bin edges
        new = np.arange(10.0, 40.0, 2.0)
        old = np.arange(8.0, 42.0, 1.0)
    return new, old, rng.uniform(0.5, 2.0, len(old))


@pytest.mark.parametrize('case', range(4))
def test_bin_star_matches_jax_loop(case):
    new, old, flux = _star(case)
    with np.testing.suppress_warnings() as sup:
        sup.filter(RuntimeWarning)   # the JAX loop's mean of empty bins
        want = jraman.bin_star(new, old, flux)
    got = traman.bin_star(new, old, flux)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-13)
    if case == 1:
        assert np.isnan(want).any()


@pytest.mark.parametrize('case', [0, 1])
def test_compute_stellar_shifts_matches_jax(dbs, case):
    jdb, tdb = dbs
    new, old, flux = _star(case)
    with np.testing.suppress_warnings() as sup:
        sup.filter(RuntimeWarning)
        want, want_spec = jraman.compute_stellar_shifts(new, jdb, old, flux)
    got, got_spec = traman.compute_stellar_shifts(new, tdb, old, flux)
    assert got.shape == want.shape == (len(new), 56)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_array_equal(np.isnan(got_spec), np.isnan(want_spec))
    ok = ~np.isnan(want_spec)
    np.testing.assert_allclose(got_spec[ok], want_spec[ok], rtol=1e-13)


@pytest.mark.parametrize('nwno', [64, 300])
def test_raman_factor_oklopcic_matches_jax(dbs, nwno):
    jdb, tdb = dbs
    rng = np.random.default_rng(nwno)
    wno = np.linspace(300.0, 33000.0, nwno)
    shifts = rng.uniform(0.5, 1.5, (nwno, len(tdb['c'])))
    tlayer = rng.uniform(100.0, 2500.0, 12)
    args = (wno, shifts, tlayer, tdb['c'], tdb['ji'], tdb['deltanu'])
    want = jraman.raman_factor_oklopcic(
        *(jnp.asarray(a) for a in args[:4]), jnp.asarray(tdb['ji'], jnp.int32),
        jnp.asarray(args[5]))
    got = traman.raman_factor_oklopcic(
        *(torch.as_tensor(a) for a in args[:4]),
        torch.as_tensor(tdb['ji'], dtype=torch.int32),
        torch.as_tensor(args[5]))
    assert got.shape == (12, nwno) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    # the factor is a real correction: away from 1 in the blue
    assert (got[:, 0] - 1.0).abs().max() > 1e-3
