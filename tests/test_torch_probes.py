"""The port's probes (picaso_tpu_torch/probes) against the JAX package's
scripts/gather_probe.py and scripts/sweep_layout_probe.py.

- stabilize_slots and fetch_stats equal the script's functions, and
  parity_slots the JAX ``_parity_slots``, on the ragged production grid
  and on a profile that walks it cell by cell;
- the layer-inner gather's twin on parity slots against
  interp_tau_pallas_blocked(..., parity=..., interpret=True): rtol 1e-10
  (float64, the same slot order);
- the sweep twin against the TPU probe's ``_kernel`` in interpret mode,
  float32: rtol 1e-6 (the same operations in the same order; XLA's CPU
  program may round a step differently, which the recursion carries).
  scripts/sweep_layout_probe.py runs ``main()`` when imported, so its
  source is executed here without that last statement.
"""

import ast
import importlib.util
import pathlib
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from picaso_tpu.opacities import db as jdb
from picaso_tpu.opacities import factory as jfactory
from picaso_tpu.opacities.pallas_interp import (_parity_slots, blocked_table,
                                                interp_tau_pallas_blocked)

from picaso_tpu_torch.convert import grid_from_numpy
from picaso_tpu_torch.opacities import db as tdb
from picaso_tpu_torch.probes import gather_probe as tprobe
from picaso_tpu_torch.probes import sweep_layout_probe as tsweep

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
NLAYER = 40


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f'_{name}', ROOT / 'scripts' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sweep_script():
    """scripts/sweep_layout_probe.py without its trailing ``main()``."""
    path = ROOT / 'scripts' / 'sweep_layout_probe.py'
    tree = ast.parse(path.read_text())
    last = tree.body[-1]
    assert isinstance(last, ast.Expr) and last.value.func.id == 'main'
    tree.body = tree.body[:-1]
    ns = {'__name__': '_sweep_layout_probe'}
    exec(compile(tree, str(path), 'exec'), ns)
    return ns


@pytest.fixture(scope='module')
def jax_grid():
    return jfactory.synthetic_opacity_grid_ragged(
        np.linspace(300.0, 33000.0, 300), molecules=('H2O', 'CO', 'Na'),
        dtype=np.float64)


@pytest.fixture(scope='module')
def profile(jax_grid):
    """bench.py's temperature profile on NLAYER layers: neighbouring
    layers share most of their corner rows."""
    pressure = np.logspace(-6, 2.5, NLAYER + 1)
    temperature = np.clip(1200.0 * (pressure / 50.0) ** 0.08, 150.0, None)
    tlayer = 0.5 * (temperature[1:] + temperature[:-1])
    player = np.sqrt(pressure[1:] * pressure[:-1])
    t_w, p_w, idx, parity = jdb._find_indices(
        jax_grid.pt, jnp.asarray(tlayer), jnp.asarray(player),
        return_parity=True)
    w4 = jnp.stack([(1 - t_w) * (1 - p_w), t_w * (1 - p_w), t_w * p_w,
                    (1 - t_w) * p_w], 0)
    mixcol = np.random.default_rng(2).uniform(1e-4, 1e-1, (3, NLAYER))
    return dict(tlayer=tlayer, player=player, t_w=t_w, p_w=p_w, idx=idx,
                parity=parity, w4=w4, mixcol=mixcol)


def test_stabilize_and_fetch_stats_match_script(profile):
    script = _script('gather_probe')
    idx, w4 = np.asarray(profile['idx']), np.asarray(profile['w4'])
    j_idx, j_w4 = script.stabilize_slots(idx, w4)
    t_idx, t_w4 = tprobe.stabilize_slots(idx, w4)
    np.testing.assert_array_equal(t_idx, j_idx)
    np.testing.assert_array_equal(t_w4, j_w4)
    for ix in (idx, j_idx):
        assert tprobe.fetch_stats(ix) == script.fetch_stats(ix)
    changes, naive, distinct = tprobe.fetch_stats(t_idx)
    # the profile walks the grid: stabilised slots fetch far fewer rows
    assert naive == 4 * NLAYER and distinct <= changes < naive // 2


def test_parity_slots_match_jax(profile):
    t_par, p_par = (np.asarray(a) for a in profile['parity'])
    j_idx, j_w4 = _parity_slots(profile['idx'], profile['w4'],
                                jnp.asarray(t_par), jnp.asarray(p_par))
    t_idx, t_w4 = tprobe.parity_slots(
        torch.as_tensor(np.asarray(profile['idx'])),
        torch.as_tensor(np.asarray(profile['w4'])),
        torch.as_tensor(t_par), torch.as_tensor(p_par))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_w4.numpy(), np.asarray(j_w4))
    # a permutation of each layer's (row, weight) pairs
    np.testing.assert_array_equal(np.sort(t_idx.numpy(), 0),
                                  np.sort(np.asarray(profile['idx']), 0))


def test_layer_inner_twin_matches_parity_gather(jax_grid, profile):
    nwno = jax_grid.wno.shape[0]
    ref = interp_tau_pallas_blocked(
        blocked_table(jax_grid.log_kappa, block_w=256), profile['idx'],
        profile['t_w'], profile['p_w'], jnp.asarray(profile['mixcol']),
        nwno, parity=profile['parity'], interpret=True)
    arrays = {k: np.asarray(getattr(jax_grid, k))
              for k in ('wno', 'log_kappa', 'cont_opa', 'cia_temps')}
    arrays.update({k: np.asarray(v) for k, v in jax_grid.pt._asdict().items()})
    grid = grid_from_numpy(arrays, jax_grid.molecules,
                           jax_grid.continuum_molecules, device='cpu')
    t_w, p_w, idx, parity = tdb._find_indices(
        grid.pt, torch.as_tensor(profile['tlayer']),
        torch.as_tensor(profile['player']), return_parity=True)
    idx_st, w_st = tprobe.parity_slots(idx, tdb.corner_weights(t_w, p_w),
                                       *parity)
    mixcol = torch.as_tensor(profile['mixcol'])
    out = tprobe.interp_tau_layer_inner_plain(grid.log_kappa, idx_st, w_st,
                                              mixcol)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-10)
    before = tprobe.interp_tau_layer_inner.launches
    assert torch.equal(tprobe.interp_tau_layer_inner(
        grid.log_kappa, idx_st, w_st, mixcol), out)
    assert tprobe.interp_tau_layer_inner.launches == before


@pytest.mark.parametrize('nlayer,ncol', [(12, 256), (90, 128)])
def test_sweep_twin_matches_tpu_kernel(nlayer, ncol):
    ns = _sweep_script()
    rng = np.random.default_rng(nlayer)
    b, c, d = (1.5 + 0.1 * rng.uniform(size=(nlayer, ncol))
               for _ in range(3))
    b = (b + 1.0).astype(np.float32)
    c, d = c.astype(np.float32), d.astype(np.float32)
    spec = pl.BlockSpec((nlayer, ncol), lambda i: (0, i))
    ref = pl.pallas_call(
        partial(ns['_kernel'], nlayer=nlayer), grid=(1,),
        in_specs=[spec, spec, spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((nlayer, ncol), jnp.float32),
        interpret=True)(jnp.asarray(b), jnp.asarray(c), jnp.asarray(d))
    args = [torch.as_tensor(x) for x in (b, c, d)]
    out = tsweep.sweep_plain(*args)
    assert out.dtype == torch.float32 and out.shape == (nlayer, ncol)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)
    launches = (tsweep.sweep_rows.launches, tsweep.sweep_staged.launches)
    assert torch.equal(tsweep.sweep_rows(*args), out)
    assert torch.equal(tsweep.sweep_staged(*args, tile=32), out)
    assert (tsweep.sweep_rows.launches,
            tsweep.sweep_staged.launches) == launches
