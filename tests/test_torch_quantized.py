"""The port's int16 opacity table and its gather (K8) against the JAX
package.

- quantize_table gives the JAX package's int16 codes bit for bit and the
  same qparams (JAX's blocked [npt, nwb, nmol, bw] table reshaped back to
  flat, padding lanes dropped), on a regular and on the ragged grid, for
  a float32 and a float64 table;
- interp_tau_q_plain (the twin of K8) against interp_tau_pallas_blocked on
  the int16 table in interpret mode, without parity slots: rtol 5e-5, both
  in float32.  XLA's CPU program lands one or two float32 ulps of logk
  away from the eager twin in 0.3-3 % of the outputs; at |logk| up to 50
  (ulp 3.8e-6) exp(ln10 x) turns each ulp into up to 9e-6 relative
  (measured: 4.8e-6 regular, 1.8e-5 ragged);
- the port's forward on an int16 grid against the JAX plain forward on
  the float table, within tests/test_pallas_toon.py's int16 bound
  (5 x (10**(step / 2) - 1 + 1e-4) with step the quantization step);
- the routing: use_kernels takes K8's twin on an int16 grid, the plain
  path stays the float one, build_problem(blocked='int16') attaches the
  table.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu import pipeline as jpipeline
from picaso_tpu.opacities import db as jdb
from picaso_tpu.opacities import factory as jfactory
from picaso_tpu.opacities.pallas_interp import (blocked_table,
                                                interp_tau_pallas_blocked)

from picaso_tpu_torch import pipeline as tpipeline
from picaso_tpu_torch.convert import grid_from_numpy, scene_from_numpy
from picaso_tpu_torch.opacities import db as tdb
from picaso_tpu_torch.opacities.assemble import ContinuumSpec
from picaso_tpu_torch.opacities.cuda_interp import (interp_tau, interp_tau_q,
                                                    interp_tau_q_plain,
                                                    quantize_table)
from picaso_tpu_torch.rt.toon import ScatteringControls

torch.set_num_threads(1)

NLAYER = 14
NWNO, NLEVEL = 256, 31


def _jax_grid(which, dtype):
    if which == 'regular':
        return jfactory.synthetic_opacity_grid(
            np.linspace(1000.0, 15000.0, 700), molecules=('H2O', 'CH4', 'CO'),
            ntemp=6, npress=5, dtype=dtype)
    return jfactory.synthetic_opacity_grid_ragged(
        np.linspace(300.0, 33000.0, 300), molecules=('H2O', 'CO', 'Na'),
        dtype=dtype)


def _flat_codes(q, nwno):
    """JAX's blocked int16 table [npt, nwb, nmol, bw] as flat
    [nmol, npt, nwno], padding lanes dropped."""
    q = np.asarray(q)
    npt, nwb, nmol, bw = q.shape
    return q.transpose(2, 0, 1, 3).reshape(nmol, npt, nwb * bw)[:, :, :nwno]


@pytest.mark.parametrize('dtype', [np.float32, np.float64])
@pytest.mark.parametrize('which', ['regular', 'ragged'])
def test_codes_and_qparams_match_jax(which, dtype):
    jgrid = _jax_grid(which, dtype)
    nwno = jgrid.wno.shape[0]
    jq, jqp = blocked_table(jgrid.log_kappa, block_w=256, quantize=True)
    q, qp = quantize_table(torch.as_tensor(np.array(jgrid.log_kappa)))
    assert q.dtype == torch.int16 and qp.dtype == torch.float32
    assert q.shape == tuple(jgrid.log_kappa.shape)
    np.testing.assert_array_equal(q.numpy(), _flat_codes(jq, nwno))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(jqp))
    # the codes span the full range
    assert q.min().item() == -32767 and q.max().item() == 32767


def _gather_inputs(jgrid, seed):
    rng = np.random.default_rng(seed)
    tlayer = np.concatenate([rng.uniform(200.0, 2400.0, NLAYER - 2),
                             [30.0, 5000.0]])
    player = np.concatenate([np.logspace(-5, 2, NLAYER - 2), [1e-9, 1e4]])
    mix = rng.uniform(1e-6, 1e-3, (3, NLAYER))
    mixcol = mix * rng.uniform(1.0, 100.0, NLAYER)[None, :]
    return tlayer, player, mixcol


@pytest.mark.parametrize('which', ['regular', 'ragged'])
def test_int16_twin_matches_pallas_kernel(which):
    jgrid = _jax_grid(which, np.float32)
    nwno = jgrid.wno.shape[0]
    tlayer, player, mixcol = _gather_inputs(jgrid, 4)
    t_w, p_w, idx = jdb._find_indices(jgrid.pt, jnp.asarray(tlayer),
                                      jnp.asarray(player))
    jq, jqp = blocked_table(jgrid.log_kappa, block_w=256, quantize=True)
    ref = np.asarray(interp_tau_pallas_blocked(
        jq, idx, t_w, p_w, jnp.asarray(mixcol), nwno, qparams=jqp,
        interpret=True))
    assert ref.dtype == np.float32

    q, qp = quantize_table(torch.as_tensor(np.array(jgrid.log_kappa)))
    args = (q, torch.as_tensor(np.asarray(idx)),
            torch.as_tensor(np.asarray(t_w)), torch.as_tensor(np.asarray(p_w)),
            torch.as_tensor(mixcol))
    out = interp_tau_q_plain(*args, qp)
    assert out.dtype == torch.float32 and out.shape == (NLAYER, nwno)
    np.testing.assert_allclose(out.numpy(), ref, rtol=5e-5)
    # the public wrapper is the twin on CPU tensors and launches nothing
    before = interp_tau_q.launches
    assert torch.equal(interp_tau_q(*args, qparams=qp), out)
    assert interp_tau_q.launches == before


def test_int16_gather_requires_qparams():
    jgrid = _jax_grid('regular', np.float32)
    q, _ = quantize_table(torch.as_tensor(np.array(jgrid.log_kappa)))
    idx = torch.zeros((4, 3), dtype=torch.int64)
    w = torch.full((3,), 0.5, dtype=torch.float64)
    with pytest.raises(ValueError, match='qparams'):
        interp_tau_q(q, idx, w, w, torch.ones((3, 3), dtype=torch.float64))


@pytest.fixture(scope='module')
def jax_problem():
    """A 16-molecule ragged grid (float table) and a cloudy 31-level scene
    with transmission, built by the JAX package; its plain forward."""
    wno = np.linspace(300.0, 33000.0, NWNO)
    grid = jfactory.synthetic_opacity_grid_ragged(
        wno, molecules=tpipeline.MOLECULES_16, dtype=np.float64)
    nlayer = NLEVEL - 1
    pressure = np.logspace(-6, 2.5, NLEVEL)
    temperature = np.clip(1200.0 * (pressure / 50.0) ** 0.08, 150.0, None)
    mix = {'H2': np.zeros(NLEVEL) + 0.84, 'He': np.zeros(NLEVEL) + 0.155}
    for m, v in tpipeline.MIX_16.items():
        mix[m] = np.zeros(NLEVEL) + v
    cld = {'opd': np.repeat(np.linspace(0.0, 1.0, nlayer) ** 2, NWNO),
           'g0': np.zeros(nlayer * NWNO) + 0.85,
           'w0': np.zeros(nlayer * NWNO) + 0.95}
    scene, config = jpipeline.scene_from_arrays(
        pressure, temperature, mix, grid, cld=cld, dtype=np.float64,
        gravity=2500.0, radius=7.1492e9, mass=1.898e30, rstar=6.96e10)
    out = jpipeline.forward(scene, grid, config)
    return grid, scene, config, {k: np.asarray(v) for k, v in out.items()}


def _port_problem(jgrid, jscene, jconfig):
    arrays = {k: np.asarray(getattr(jgrid, k))
              for k in ('wno', 'log_kappa', 'cont_opa', 'cia_temps')}
    arrays.update({k: np.asarray(v) for k, v in jgrid.pt._asdict().items()})
    grid = grid_from_numpy(arrays, jgrid.molecules,
                           jgrid.continuum_molecules, device='cpu')
    scene = scene_from_numpy({k: np.asarray(v)
                              for k, v in jscene._asdict().items()},
                             device='cpu')
    config = tpipeline.SpectrumConfig(
        mol_indices=jconfig.mol_indices,
        continuum_specs=tuple(ContinuumSpec(*s)
                              for s in jconfig.continuum_specs),
        cont_indices=jconfig.cont_indices, mix_index=jconfig.mix_index,
        controls=ScatteringControls(**dataclasses.asdict(jconfig.controls)),
        transmission=jconfig.transmission)
    return grid, scene, config


def test_int16_forward_matches_jax_plain_forward(jax_problem):
    jgrid, jscene, jconfig, ref = jax_problem
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    gq = grid.with_blocked_table(quantize=True)
    assert gq.log_kappa_blocked.dtype == torch.int16
    assert grid.with_blocked_table(quantize=False) is grid
    out = tpipeline.forward(scene, gq, config)
    step = gq.blocked_qparams[0].item()
    rtol = 5 * (10.0 ** (0.5 * step) - 1.0 + 1e-4)
    for key in ('albedo', 'thermal', 'transit_depth'):
        assert out[key].dtype == torch.float64
        np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=rtol)


def test_int16_grid_routes_to_k8(jax_problem):
    """use_kernels: gather_args/gather_taugas take K8 (its twin here) on an
    int16 grid; use_kernels=False stays the plain float path on
    log_kappa; forward_batch passes the int16 grid through."""
    jgrid, jscene, jconfig, _ = jax_problem
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    gq = grid.with_blocked_table(quantize=True)
    args = tpipeline.gather_args(scene, gq, config)
    assert len(args) == 6 and args[0] is gq.log_kappa_blocked
    assert args[5] is gq.blocked_qparams
    taugas = tpipeline.gather_taugas(scene, gq, config)
    assert torch.equal(taugas, interp_tau_q_plain(*args))
    assert not torch.equal(taugas.double(),
                           tpipeline.gather_taugas(scene, grid, config))
    launches = (interp_tau.launches, interp_tau_q.launches)
    plain = dataclasses.replace(config, use_kernels=False)
    assert torch.equal(tpipeline.gather_taugas(scene, gq, plain),
                       tpipeline.gather_taugas(scene, grid, plain))
    one = tpipeline.forward(scene, gq, config)
    batch = tpipeline.forward_batch(tpipeline.stack_scenes([scene, scene]),
                                    gq, config)
    assert (interp_tau.launches, interp_tau_q.launches) == launches
    for key in one:
        assert torch.equal(batch[key][1], one[key])


def test_build_problem_int16():
    scene, grid, config = tpipeline.build_problem(64, nlevel=21,
                                                  production=False,
                                                  device='cpu',
                                                  blocked='int16')
    assert grid.log_kappa_blocked.dtype == torch.int16
    assert grid.log_kappa_blocked.shape == grid.log_kappa.shape
    q, qp = quantize_table(grid.log_kappa)
    assert torch.equal(grid.log_kappa_blocked, q)
    assert torch.equal(grid.blocked_qparams, qp)
    out = tpipeline.forward(scene, grid, config)
    assert all(torch.isfinite(v).all() for v in out.values())
    with pytest.raises(ValueError, match='blocked'):
        tpipeline.build_problem(64, production=False, device='cpu',
                                blocked='int8')


def test_find_indices_parity_matches_jax():
    jgrid = _jax_grid('ragged', np.float64)
    tlayer, player, _ = _gather_inputs(jgrid, 8)
    *_, (jt, jp) = jdb._find_indices(jgrid.pt, jnp.asarray(tlayer),
                                     jnp.asarray(player), return_parity=True)
    arrays = {k: np.asarray(v) for k, v in jgrid.pt._asdict().items()}
    pt = tdb.PTGrid(*(torch.as_tensor(arrays[k]) for k in tdb.PTGrid._fields))
    *_, (tt, tp) = tdb._find_indices(pt, torch.as_tensor(tlayer),
                                     torch.as_tensor(player),
                                     return_parity=True)
    assert tt.dtype == tp.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
