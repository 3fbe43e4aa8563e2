"""The retrieval slice as a whole on the CPU in float64: the batched
likelihoods of picaso_tpu_torch/probes/retrieval.py (the free retrieval of
examples/retrieval_nested.py, transmission and thermal, and the WASP-17b
fit of examples/wasp17_transmission.py) against the same examples built
through the JAX package's pipeline.scene_from_arrays, stack_scenes and
forward_batch (its scan path) on tests/torch_facade_cases.py's synthetic
database: transit depths and their log-likelihoods at RTOL_TRANSIT, the
thermal flux at RTOL; then a nested run over the port's likelihood."""

import dataclasses

import numpy as np
import pytest

from picaso_tpu import pipeline as jpipeline
from picaso_tpu import justdoit as jdi
from picaso_tpu.ncio import read_netcdf
from picaso_tpu.wavelength import conv_non_uniform_R
from picaso_tpu_torch.probes import retrieval as pr
from picaso_tpu_torch.sampler import nested_sample

import torch_facade_cases as fc

NLEVEL = 21


@pytest.fixture(scope='module')
def grids(tmp_path_factory):
    jopa, topa = fc.connections(fc.synthetic_db(tmp_path_factory))
    return jopa.grid, topa.grid


def _jax_forward(grid, scene_fn, kind, theta):
    """The JAX example's batched forward: one scene per point, stacked,
    forward_batch."""
    scenes = [scene_fn(*t) for t in np.atleast_2d(theta)]
    config = dataclasses.replace(
        scenes[0][1], reflected=False, thermal=kind == 'thermal',
        transmission=kind == 'transmission')
    out = jpipeline.forward_batch(jpipeline.stack_scenes(
        [s for s, _ in scenes]), grid, config)
    return np.asarray(out['transit_depth' if kind == 'transmission'
                          else 'thermal'])


@pytest.mark.parametrize('kind', ['transmission', 'thermal'])
def test_free_retrieval_likelihood_matches_jax(grids, kind):
    jgrid, tgrid = grids
    case = pr.FreeRetrieval(tgrid, kind, nlevel=NLEVEL)
    pressure = np.logspace(-6, 2, NLEVEL)

    def jscene(tiso, log_h2o):
        mix = {'H2': np.full(NLEVEL, 0.86), 'He': np.full(NLEVEL, 0.14),
               'H2O': np.full(NLEVEL, 10.0 ** log_h2o),
               'CH4': np.full(NLEVEL, 1e-4)}
        return jpipeline.scene_from_arrays(
            pressure, np.full(NLEVEL, tiso), mix, jgrid, gravity=np.nan,
            radius=1.2 * pr.RJ, mass=0.8 * pr.MJ, rstar=0.9 * pr.RSUN,
            dtype=np.float64)

    theta = case.prior(np.random.default_rng(5).random((3, 2)))
    ref = _jax_forward(jgrid, jscene, kind, theta)
    rtol = fc.RTOL_TRANSIT if kind == 'transmission' else fc.RTOL
    np.testing.assert_allclose(case.forward(theta), ref, rtol=rtol, atol=0)
    jll = -0.5 * np.sum((ref - case.y) ** 2 / case.err ** 2, axis=1)
    np.testing.assert_allclose(case.loglike(theta), jll, rtol=rtol)
    assert case.scenes == 6 and len(case.batch_ms) == 2


def test_w17_likelihood_matches_jax(grids):
    jgrid, tgrid = grids
    case = pr.W17Retrieval(tgrid, nlevel=NLEVEL)
    ds = read_netcdf(jdi.w17_data())
    np.testing.assert_array_equal(case.y, ds['transit_depth'].values)
    pressure = np.logspace(-6, 2, NLEVEL)

    def jscene(tiso, log_h2o, xrp):
        mix = {'H2': np.full(NLEVEL, 0.85), 'He': np.full(NLEVEL, 0.15),
               'H2O': np.full(NLEVEL, 10.0 ** log_h2o),
               'CH4': np.full(NLEVEL, 1e-7)}
        return jpipeline.scene_from_arrays(
            pressure, np.full(NLEVEL, tiso), mix, jgrid, gravity=np.nan,
            radius=xrp * 1.93 * pr.RJ, mass=0.78 * pr.MJ,
            rstar=1.58 * pr.RSUN, dtype=np.float64)

    theta = case.walkers(3)
    depth = _jax_forward(jgrid, jscene, 'transmission', theta)
    wl_model = 1e4 / np.asarray(jgrid.wno)[::-1]
    ref = np.stack([conv_non_uniform_R(d[::-1], wl_model, case.R_obs,
                                       case.wl_obs) for d in depth])
    np.testing.assert_allclose(case.forward(theta), ref,
                               rtol=fc.RTOL_TRANSIT, atol=0)
    outside = np.array([[100.0, -3.0, 1.0]])
    assert case.loglike(outside)[0] == -np.inf


def test_nested_run_over_the_batched_likelihood(grids):
    _, tgrid = grids
    case = pr.FreeRetrieval(tgrid, 'transmission', nlevel=NLEVEL)
    res = nested_sample(case.loglike, case.prior, 2, nlive=10, max_iter=8,
                        walks=2, seed=2)
    # no ellipsoid before iteration 20: each iteration walks 2 x 4 points
    assert case.scenes == 10 + 8 * 2 * 4
    assert np.isfinite(res.logz) and res.samples.shape == (18, 2)
