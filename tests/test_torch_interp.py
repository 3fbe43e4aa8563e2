"""The port's opacity gather and grids against the JAX package.

Same inputs (numpy, from a seed) go through the JAX functions in float64
and through picaso_tpu_torch on the CPU in float64:
- db._find_indices: row ids exact, weights to 1e-12, on a regular and on
  the ragged production (T, P) grid, with layers beyond the grid edges;
- interp_tau_plain (the twin of csrc/interp_tau.cu) against both Pallas
  gathers in interpret mode, rtol 1e-10 (same arithmetic in f64);
- the ragged production grid built by the port against the JAX one:
  the band model runs in float32 in both, so 1e-4 dex.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu.opacities import db as jdb
from picaso_tpu.opacities import factory as jfactory
from picaso_tpu.opacities.pallas_interp import (blocked_table,
                                                interp_tau_pallas,
                                                interp_tau_pallas_blocked)

from picaso_tpu_torch.convert import grid_from_numpy
from picaso_tpu_torch.opacities import db as tdb
from picaso_tpu_torch.opacities import factory as tfactory
from picaso_tpu_torch.opacities.cuda_interp import (interp_tau,
                                                    interp_tau_plain)

torch.set_num_threads(1)

NLAYER = 14


def _grid_arrays(grid):
    d = {k: np.array(getattr(grid, k))
         for k in ('wno', 'log_kappa', 'cont_opa', 'cia_temps')}
    d.update({k: np.array(v) for k, v in grid.pt._asdict().items()})
    return d


def _port_grid(jgrid):
    return grid_from_numpy(_grid_arrays(jgrid), jgrid.molecules,
                           jgrid.continuum_molecules)


@pytest.fixture(scope='module')
def regular_grid():
    wno = np.linspace(1000.0, 15000.0, 700)
    return jfactory.synthetic_opacity_grid(
        wno, molecules=('H2O', 'CH4', 'CO'), ntemp=6, npress=5,
        dtype=np.float64)


@pytest.fixture(scope='module')
def ragged_grid():
    wno = np.linspace(300.0, 33000.0, 256)
    return jfactory.synthetic_opacity_grid_ragged(
        wno, molecules=('H2O', 'CO', 'Na'), dtype=np.float64)


def _layers(seed):
    rng = np.random.default_rng(seed)
    # temperatures and pressures inside and beyond the grid edges
    tlayer = np.concatenate([rng.uniform(200.0, 2400.0, NLAYER - 4),
                             [30.0, 5000.0, 75.0, 3000.0]])
    player = np.concatenate([np.logspace(-5, 2, NLAYER - 4),
                             [1e-9, 1e4, 1e-6, 300.0]])
    return tlayer, player


@pytest.mark.parametrize('which', ['regular', 'ragged'])
def test_find_indices_matches_jax(which, regular_grid, ragged_grid):
    jgrid = regular_grid if which == 'regular' else ragged_grid
    tgrid = _port_grid(jgrid)
    tlayer, player = _layers(5)
    j_tw, j_pw, j_idx = jdb._find_indices(jgrid.pt, jnp.asarray(tlayer),
                                          jnp.asarray(player))
    t_tw, t_pw, t_idx = tdb._find_indices(tgrid.pt, torch.as_tensor(tlayer),
                                          torch.as_tensor(player))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(t_tw.numpy(), np.asarray(j_tw), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(t_pw.numpy(), np.asarray(j_pw), rtol=1e-12,
                               atol=1e-12)


def test_gather_twin_matches_both_pallas_gathers(regular_grid):
    jgrid = regular_grid
    nwno = jgrid.wno.shape[0]
    rng = np.random.default_rng(3)
    tlayer, player = _layers(3)
    colden = rng.uniform(1.0, 100.0, NLAYER)
    mmw = rng.uniform(2.2, 2.4, NLAYER)
    mix = rng.uniform(1e-6, 1e-3, (3, NLAYER))
    mixcol = mix * colden[None, :] / mmw[None, :]

    t_w, p_w, idx = jdb._find_indices(jgrid.pt, jnp.asarray(tlayer),
                                      jnp.asarray(player))
    flat = interp_tau_pallas(jgrid.log_kappa, idx, t_w, p_w,
                             jnp.asarray(mixcol), block_w=256,
                             interpret=True)
    blocked = interp_tau_pallas_blocked(
        blocked_table(jgrid.log_kappa, block_w=256), idx, t_w, p_w,
        jnp.asarray(mixcol), nwno, interpret=True)

    tgrid = _port_grid(jgrid)
    tt_w, tp_w, t_idx = tdb._find_indices(tgrid.pt, torch.as_tensor(tlayer),
                                          torch.as_tensor(player))
    out = interp_tau_plain(tgrid.log_kappa, t_idx, tt_w, tp_w,
                           torch.as_tensor(mixcol))
    assert out.shape == (NLAYER, nwno) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(flat), rtol=1e-10)
    np.testing.assert_allclose(out.numpy(), np.asarray(blocked), rtol=1e-10)

    # on CPU tensors the public wrapper is the twin and launches nothing
    before = interp_tau.launches
    wrapped = interp_tau(tgrid.log_kappa, t_idx, tt_w, tp_w,
                         torch.as_tensor(mixcol))
    assert interp_tau.launches == before
    assert torch.equal(wrapped, out)


def test_interp_molecular_matches_jax(ragged_grid):
    jgrid = ragged_grid
    tlayer, player = _layers(9)
    ref = jdb.interp_molecular(jgrid, jnp.asarray(tlayer),
                               jnp.asarray(player))
    out = tdb.interp_molecular(_port_grid(jgrid), torch.as_tensor(tlayer),
                               torch.as_tensor(player))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10)
    cref = jdb.nearest_continuum(jgrid, jnp.asarray(tlayer))
    cout = tdb.nearest_continuum(_port_grid(jgrid), torch.as_tensor(tlayer))
    np.testing.assert_array_equal(cout.numpy(), np.asarray(cref))


def test_ragged_grid_matches_jax(ragged_grid):
    jgrid = ragged_grid
    wno = np.asarray(jgrid.wno)
    tgrid = tfactory.synthetic_opacity_grid_ragged(
        wno, molecules=jgrid.molecules, dtype=torch.float64)
    assert tgrid.log_kappa.shape == (3, 1060, 256)
    np.testing.assert_allclose(tgrid.log_kappa.numpy(),
                               np.asarray(jgrid.log_kappa), rtol=0,
                               atol=1e-4)
    for name in jgrid.pt._fields:
        np.testing.assert_array_equal(getattr(tgrid.pt, name).numpy(),
                                      np.asarray(getattr(jgrid.pt, name)))
    np.testing.assert_array_equal(tgrid.cont_opa.numpy(),
                                  np.asarray(jgrid.cont_opa))
    np.testing.assert_array_equal(tgrid.cia_temps.numpy(),
                                  np.asarray(jgrid.cia_temps))
    assert tgrid.molecules == jgrid.molecules
    assert tgrid.continuum_molecules == jgrid.continuum_molecules


def test_regular_grid_matches_jax(regular_grid):
    jgrid = regular_grid
    tgrid = tfactory.synthetic_opacity_grid(
        np.asarray(jgrid.wno), molecules=jgrid.molecules, ntemp=6, npress=5)
    for name in ('wno', 'log_kappa', 'cont_opa', 'cia_temps'):
        np.testing.assert_array_equal(getattr(tgrid, name).numpy(),
                                      np.asarray(getattr(jgrid, name)))
    for name in jgrid.pt._fields:
        np.testing.assert_array_equal(getattr(tgrid.pt, name).numpy(),
                                      np.asarray(getattr(jgrid.pt, name)))
