"""The port's forward spectrum against picaso_tpu.pipeline.forward.

A 16-molecule ragged production-layout grid at nwno = 256 and a cloudy
31-level scene with transmission are built by the JAX package in float64,
carried across with picaso_tpu_torch.convert, and run through both
forwards on the CPU in float64.  The JAX side takes its plain reference
(use_pallas=False); the port runs both its kernel path (the kernels'
twins on CPU tensors) and its plain path, for the Toon solver and for the
SH solver at stream 2 and 4.  Toon albedo and thermal agree to rtol 2e-5
(the kernel-vs-scan tolerance of tests/test_pallas_toon.py), SH to 1e-7
(reason at test_sh_forward_matches_jax), transit to 1e-8 (same
arithmetic).
"""

import dataclasses

import numpy as np
import pytest
import torch

from picaso_tpu import pipeline as jpipeline
from picaso_tpu.opacities import factory as jfactory

from picaso_tpu_torch import pipeline as tpipeline
from picaso_tpu_torch.convert import grid_from_numpy, scene_from_numpy
from picaso_tpu_torch.opacities.assemble import ContinuumSpec
from picaso_tpu_torch.opacities.cuda_interp import interp_tau
from picaso_tpu_torch.rt import cuda_sh
from picaso_tpu_torch.rt.cuda_toon import spectrum_toon
from picaso_tpu_torch.rt.toon import ScatteringControls

torch.set_num_threads(1)

NWNO, NLEVEL = 256, 31


def _profile():
    """bench.py's build_problem profile at NLEVEL levels."""
    nlevel, nlayer = NLEVEL, NLEVEL - 1
    pressure = np.logspace(-6, 2.5, nlevel)
    temperature = np.clip(1200.0 * (pressure / 50.0) ** 0.08, 150.0, None)
    mix = {'H2': np.zeros(nlevel) + 0.84, 'He': np.zeros(nlevel) + 0.155}
    for m, v in tpipeline.MIX_16.items():
        mix[m] = np.zeros(nlevel) + v
    cld = {'opd': np.repeat(np.linspace(0.0, 1.0, nlayer) ** 2, NWNO),
           'g0': np.zeros(nlayer * NWNO) + 0.85,
           'w0': np.zeros(nlayer * NWNO) + 0.95}
    return pressure, temperature, mix, cld


_KW = dict(gravity=2500.0, radius=7.1492e9, mass=1.898e30, rstar=6.96e10)


@pytest.fixture(scope='module')
def jax_problem():
    wno = np.linspace(300.0, 33000.0, NWNO)
    grid = jfactory.synthetic_opacity_grid_ragged(
        wno, molecules=tpipeline.MOLECULES_16, dtype=np.float64)
    pressure, temperature, mix, cld = _profile()
    scene, config = jpipeline.scene_from_arrays(
        pressure, temperature, mix, grid, cld=cld, dtype=np.float64, **_KW)
    assert config.transmission and not config.use_pallas
    out = jpipeline.forward(scene, grid, config)
    return grid, scene, config, {k: np.asarray(v) for k, v in out.items()}


def _port_problem(jgrid, jscene, jconfig):
    arrays = {k: np.asarray(getattr(jgrid, k))
              for k in ('wno', 'log_kappa', 'cont_opa', 'cia_temps')}
    arrays.update({k: np.asarray(v) for k, v in jgrid.pt._asdict().items()})
    grid = grid_from_numpy(arrays, jgrid.molecules,
                           jgrid.continuum_molecules)
    scene = scene_from_numpy({k: np.asarray(v)
                              for k, v in jscene._asdict().items()})
    config = tpipeline.SpectrumConfig(
        mol_indices=jconfig.mol_indices,
        continuum_specs=tuple(ContinuumSpec(*s)
                              for s in jconfig.continuum_specs),
        cont_indices=jconfig.cont_indices, mix_index=jconfig.mix_index,
        controls=ScatteringControls(**dataclasses.asdict(jconfig.controls)),
        transmission=jconfig.transmission)
    return grid, scene, config


@pytest.mark.parametrize('use_kernels', [True, False])
def test_forward_matches_jax(jax_problem, use_kernels):
    jgrid, jscene, jconfig, ref = jax_problem
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    config = dataclasses.replace(config, use_kernels=use_kernels)
    launches = (interp_tau.launches, spectrum_toon.launches)
    out = tpipeline.forward(scene, grid, config)
    assert (interp_tau.launches, spectrum_toon.launches) == launches
    assert set(out) == {'albedo', 'thermal', 'transit_depth'}
    for key in out:
        assert out[key].shape == (NWNO,) and out[key].dtype == torch.float64
        assert torch.isfinite(out[key]).all()
    np.testing.assert_allclose(out['albedo'].numpy(), ref['albedo'],
                               rtol=2e-5)
    np.testing.assert_allclose(out['thermal'].numpy(), ref['thermal'],
                               rtol=2e-5)
    np.testing.assert_allclose(out['transit_depth'].numpy(),
                               ref['transit_depth'], rtol=1e-8)


def test_scene_from_arrays_matches_jax(jax_problem):
    """The port's own host-side scene construction (numpy copies of
    atmosphere, rayleigh, disco) against the JAX package's, field by
    field."""
    jgrid, jscene, jconfig, _ = jax_problem
    grid, _, _ = _port_problem(jgrid, jscene, jconfig)
    pressure, temperature, mix, cld = _profile()
    scene, config = tpipeline.scene_from_arrays(
        pressure, temperature, mix, grid, cld=cld, **_KW)
    for name in jpipeline.SceneTensors._fields:
        got, want = getattr(scene, name), np.asarray(getattr(jscene, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0,
                                   err_msg=name)
    assert config.mol_indices == jconfig.mol_indices
    assert config.cont_indices == jconfig.cont_indices
    assert config.mix_index == jconfig.mix_index
    assert [tuple(s) for s in config.continuum_specs] == [
        tuple(s) for s in jconfig.continuum_specs]
    assert config.transmission == jconfig.transmission


@pytest.fixture(scope='module')
def jax_sh(jax_problem):
    """The JAX SH forwards (plain path, f64) at stream 2 and 4."""
    jgrid, jscene, jconfig, _ = jax_problem
    out = {}
    for stream in (2, 4):
        cfg = dataclasses.replace(jconfig, rt_method=1, stream=stream)
        out[stream] = {k: np.asarray(v) for k, v in
                       jpipeline.forward(jscene, jgrid, cfg).items()}
    return out


def _sh_launches():
    return tuple(getattr(cuda_sh, f'{k}_sh{s}').launches
                 for k in ('reflected', 'thermal') for s in (2, 4))


@pytest.mark.parametrize('use_kernels', [True, False])
@pytest.mark.parametrize('stream', [2, 4])
def test_sh_forward_matches_jax(jax_problem, jax_sh, stream, use_kernels):
    """rtol 1e-7 for albedo and thermal (measured 1.5e-8 / 4.9e-10 for the
    plain SH4 path, 2.7e-8 / 2.7e-9 for the twins): the f64 JAX path takes
    the classic grouping, whose pivot blocks are nearly singular in the
    thin top layers of this profile (p down to 1e-6 bar), so the ~1e-14
    differences of the opacity stage come out ~1e6 times larger; the
    twins add the TPU kernels' Taylor expm1 and the incoming grouping.
    SH2 agrees to 5e-12 (plain) and 3.3e-9 (twins)."""
    jgrid, jscene, jconfig, _ = jax_problem
    ref = jax_sh[stream]
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    config = dataclasses.replace(config, rt_method=1, stream=stream,
                                 use_kernels=use_kernels)
    launches = (interp_tau.launches, spectrum_toon.launches, _sh_launches())
    out = tpipeline.forward(scene, grid, config)
    assert (interp_tau.launches, spectrum_toon.launches,
            _sh_launches()) == launches
    assert set(out) == {'albedo', 'thermal', 'transit_depth'}
    for key in out:
        assert out[key].shape == (NWNO,) and out[key].dtype == torch.float64
        assert torch.isfinite(out[key]).all()
    np.testing.assert_allclose(out['albedo'].numpy(), ref['albedo'],
                               rtol=1e-7)
    np.testing.assert_allclose(out['thermal'].numpy(), ref['thermal'],
                               rtol=1e-7)
    np.testing.assert_allclose(out['transit_depth'].numpy(),
                               ref['transit_depth'], rtol=1e-8)


@pytest.mark.parametrize('part', ['reflected', 'thermal'])
@pytest.mark.parametrize('stream', [2, 4])
def test_sh_forward_one_part(jax_problem, jax_sh, stream, part):
    """Reflected-only and thermal-only SH spectra (the JAX SH branch runs
    its two kernels separately): the part asked for, equal to the full
    forward's, and no key for the other."""
    jgrid, jscene, jconfig, _ = jax_problem
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    config = dataclasses.replace(config, rt_method=1, stream=stream,
                                 reflected=part == 'reflected',
                                 thermal=part == 'thermal')
    out = tpipeline.forward(scene, grid, config)
    key = 'albedo' if part == 'reflected' else 'thermal'
    assert set(out) == {key, 'transit_depth'}
    np.testing.assert_allclose(out[key].numpy(), jax_sh[stream][key],
                               rtol=1e-7)


@pytest.mark.parametrize('change, item', [
    (dict(rt_method=1, raman=1), 'item 8'),
    (dict(raman=0), 'item 8'),
    (dict(test_mode='rayleigh'), 'item 14'),
    (dict(thermal=False), 'Queue 2 items 3-4'),
    (dict(rt_method=1, test_mode='constant_tau'), 'item 14'),
])
def test_unported_configurations_raise(jax_problem, change, item):
    jgrid, jscene, jconfig, _ = jax_problem
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    with pytest.raises(NotImplementedError, match=item):
        tpipeline.forward(scene, grid, dataclasses.replace(config, **change))


@pytest.mark.parametrize('change', [dict(rt_method=1, stream=3),
                                    dict(rt_method=2)])
def test_bad_rt_options_raise(jax_problem, change):
    jgrid, jscene, jconfig, _ = jax_problem
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    with pytest.raises(ValueError):
        tpipeline.forward(scene, grid, dataclasses.replace(config, **change))


def test_build_problem_shapes():
    """build_problem mirrors bench.py: 5 disk angles from num_gangle=10,
    90 layers, transmission on; small regular grid here."""
    scene, grid, config = tpipeline.build_problem(64, production=False)
    assert scene.ubar0.shape == (5, 1)
    assert scene.tlayer.shape == (90,)
    assert grid.log_kappa.shape == (6, 150, 64)
    assert config.transmission and config.use_kernels
    assert scene.cld_opd.dtype == torch.float64
    out = tpipeline.forward(scene, grid, config)
    assert all(torch.isfinite(v).all() for v in out.values())
