"""The port's forward spectrum against picaso_tpu.pipeline.forward.

A 16-molecule ragged production-layout grid at nwno = 256 and a cloudy
31-level scene with transmission are built by the JAX package in float64,
carried across with picaso_tpu_torch.convert, and run through both
forwards on the CPU in float64.  The JAX side takes its plain reference
(use_pallas=False); the port runs both its kernel path (the kernels'
twins on CPU tensors) and its plain path, for the Toon solver (reflected
and thermal together or alone, Raman modes 0/1/2, fused or unfused optics,
the test modes) and for the SH solver at stream 2 and 4, and through
forward_batch.  Toon albedo and thermal agree to rtol 2e-5 (the
kernel-vs-scan tolerance of tests/test_pallas_toon.py), SH to 1e-7 (reason
at test_sh_forward_matches_jax), transit to 1e-8 (same arithmetic).
"""

import dataclasses

import numpy as np
import pytest
import torch

from picaso_tpu import disco as jdisco
from picaso_tpu import pipeline as jpipeline
from picaso_tpu import raman as jraman
from picaso_tpu.opacities import factory as jfactory

from picaso_tpu_torch import disco as tdisco
from picaso_tpu_torch import pipeline as tpipeline
from picaso_tpu_torch import raman as traman
from picaso_tpu_torch.convert import grid_from_numpy, scene_from_numpy
from picaso_tpu_torch.opacities import db as tdb
from picaso_tpu_torch.opacities import factory as tfactory
from picaso_tpu_torch.opacities.assemble import ContinuumSpec
from picaso_tpu_torch.opacities.cuda_interp import interp_tau
from picaso_tpu_torch.rt import cuda_sh, cuda_toon
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


_TOON_KERNELS = ('spectrum_toon', 'reflected_toon', 'thermal_toon',
                 'reflected_toon_props', 'thermal_toon_props')


def _toon_launches():
    return tuple(getattr(cuda_toon, k).launches for k in _TOON_KERNELS)


@pytest.fixture(scope='module')
def raman_inputs(jax_problem):
    """Raman inputs made the JAX package's way: the Oklopcic table, the
    shift ratios of a 5700 K blackbody star on the fine grid of
    inputs.star (justdoit.py:337-358) through the JAX binning loop, and
    the Pollack row."""
    from picaso_tpu.constants import PLANCK_C1, PLANCK_C2
    wno = np.asarray(jax_problem[0].wno)
    db = jraman.load_raman_db(f'{traman.REFDATA_OPACITIES}/raman.txt')
    wno_star = np.linspace(max(wno.min() - 2500, 10.0), wno.max() + 7000,
                           len(wno) * 5 + 1000)
    lam = 1.0 / wno_star
    flux_star = (np.pi * PLANCK_C1 / lam ** 5
                 / (np.exp(PLANCK_C2 / (lam * 5700.0)) - 1.0))
    fine_wno = np.linspace(wno.min() - 2000, wno.max() + 6000, len(wno) * 5)
    with np.testing.suppress_warnings() as sup:
        sup.filter(RuntimeWarning)   # the loop's mean of empty bins
        shifts, _ = jraman.compute_stellar_shifts(
            wno, db, fine_wno, np.interp(fine_wno, wno_star, flux_star))
    pollack = jraman.raman_factor_pollack(
        1, 1e4 / wno, refdata_dir=traman.REFDATA_OPACITIES.rsplit('/', 1)[0])
    return dict(raman_db=db, raman_shifts=shifts,
                raman_pollack_row=pollack[0])


@pytest.fixture(scope='module')
def jax_raman_scene(jax_problem, raman_inputs):
    pressure, temperature, mix, cld = _profile()
    scene, _ = jpipeline.scene_from_arrays(
        pressure, temperature, mix, jax_problem[0], cld=cld,
        dtype=np.float64, **raman_inputs, **_KW)
    return scene


def test_scene_raman_inputs_match_jax(jax_problem, jax_raman_scene):
    """The port's own Raman scene inputs (numpy table, vectorised binning
    of its 5700 K star, Pollack row) against the JAX package's."""
    jgrid, jscene, jconfig, _ = jax_problem
    grid, _, _ = _port_problem(jgrid, jscene, jconfig)
    db = traman.load_raman_db()
    wno = grid.wno.numpy()
    pressure, temperature, mix, cld = _profile()
    scene, _ = tpipeline.scene_from_arrays(
        pressure, temperature, mix, grid, cld=cld, raman_db=db,
        raman_shifts=tpipeline.stellar_shifts_5700k(wno, db),
        raman_pollack_row=traman.raman_factor_pollack(1, 1e4 / wno)[0],
        **_KW)
    for name in ('raman_shifts', 'raman_c', 'raman_ji', 'raman_dnu',
                 'raman_pollack_row'):
        got = getattr(scene, name)
        want = np.asarray(getattr(jax_raman_scene, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   err_msg=name)
    assert scene.raman_ji.dtype == torch.int32


# Toon configurations beyond reflected + thermal with fused optics: each
# with the kernels the port's forward launches for it
_TOON_CASES = {
    'reflected_raman2': (dict(thermal=False), ('reflected_toon',)),
    'reflected_raman1': (dict(thermal=False, raman=1), ('reflected_toon',)),
    'reflected_raman0': (dict(thermal=False, raman=0), ('reflected_toon',)),
    'both_raman0': (dict(raman=0), ('spectrum_toon',)),
    'thermal': (dict(reflected=False), ('thermal_toon',)),
    'unfused_raman1': (dict(fuse_optics=False, raman=1),
                       ('reflected_toon_props', 'thermal_toon_props')),
    'rayleigh': (dict(test_mode='rayleigh'),
                 ('reflected_toon_props', 'thermal_toon_props')),
    'constant_tau': (dict(test_mode='constant_tau'),
                     ('reflected_toon_props', 'thermal_toon_props')),
}


@pytest.fixture(scope='module')
def jax_toon_cases(jax_problem, jax_raman_scene):
    """The JAX forwards (plain path, f64) of every _TOON_CASES entry."""
    jgrid, _, jconfig, _ = jax_problem
    return {name: {k: np.asarray(v) for k, v in jpipeline.forward(
                jax_raman_scene, jgrid,
                dataclasses.replace(jconfig, **change)).items()}
            for name, (change, _) in _TOON_CASES.items()}


@pytest.mark.parametrize('use_kernels', [True, False])
@pytest.mark.parametrize('case', list(_TOON_CASES))
def test_toon_configurations_match_jax(jax_problem, jax_raman_scene,
                                       jax_toon_cases, case, use_kernels):
    """Reflected-only with Raman 0/1/2, thermal-only, unfused optics and
    the two test modes: the kernels' twins (use_kernels) and the plain
    path against the JAX plain path; on CPU tensors no kernel launches."""
    jgrid, _, jconfig, _ = jax_problem
    change, _ = _TOON_CASES[case]
    ref = jax_toon_cases[case]
    grid, scene, config = _port_problem(jgrid, jax_raman_scene, jconfig)
    config = dataclasses.replace(config, use_kernels=use_kernels, **change)
    before = _toon_launches()
    out = tpipeline.forward(scene, grid, config)
    assert _toon_launches() == before
    assert set(out) == set(ref)
    for key in out:
        assert out[key].shape == (NWNO,) and torch.isfinite(out[key]).all()
        rtol = 1e-8 if key == 'transit_depth' else 2e-5
        np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=rtol,
                                   err_msg=key)


@pytest.mark.parametrize('case', list(_TOON_CASES))
def test_toon_configurations_take_their_kernels(jax_problem,
                                                jax_raman_scene, case,
                                                monkeypatch):
    """With use_kernels each configuration reaches the wrappers of its
    kernels (K2-K6 as the JAX package routes them), and no other Toon
    wrapper."""
    jgrid, _, jconfig, _ = jax_problem
    change, kernels = _TOON_CASES[case]
    grid, scene, config = _port_problem(jgrid, jax_raman_scene, jconfig)
    config = dataclasses.replace(config, **change)
    called = []
    for name in _TOON_KERNELS:
        wrapper = getattr(cuda_toon, name)
        monkeypatch.setattr(
            cuda_toon, name,
            lambda *a, _w=wrapper, _n=name, **k: called.append(_n) or
            _w(*a, **k))
    monkeypatch.setattr(tpipeline, 'spectrum_toon', cuda_toon.spectrum_toon)
    tpipeline.forward(scene, grid, config)
    assert tuple(called) == kernels


def _jax_batch(jax_problem, geometry):
    """Three scenes with temperatures scaled by (1 + 0.001 i), as the JAX
    bench perturbs them; geometry 'shared' (the retrieval case) or
    'phase' (phase angles 0, 0.8, 2.0 on a 6 x 6 disk, bench.py:627)."""
    _, jscene, _, _ = jax_problem
    scenes = []
    for i, phase in enumerate((0.0, 0.8, 2.0)):
        s = jscene._replace(tlevel=jscene.tlevel * (1 + 0.001 * i),
                            tlayer=jscene.tlayer * (1 + 0.001 * i))
        if geometry == 'phase':
            g = jdisco.make_geometry(phase, num_gangle=6, num_tangle=6)
            s = s._replace(ubar0=np.asarray(g.ubar0),
                           ubar1=np.asarray(g.ubar1),
                           gweight=np.asarray(g.gweight),
                           tweight=np.asarray(g.tweight),
                           cos_theta=np.asarray(g.cos_theta))
        scenes.append(s)
    return scenes


@pytest.mark.parametrize('geometry', ['shared', 'phase'])
def test_forward_batch_matches_jax(jax_problem, geometry):
    """stack_scenes + forward_batch against the JAX package's: shared
    geometry stays unbatched, per-scene (phase-curve) geometry keeps its
    axis; outputs gain the batch axis.  The phase curve is reflected-only
    (K3's twin), the shared case reflected + thermal (K2's)."""
    jgrid, _, jconfig, _ = jax_problem
    jscenes = _jax_batch(jax_problem, geometry)
    change = dict(thermal=False) if geometry == 'phase' else {}
    want = jpipeline.forward_batch(jpipeline.stack_scenes(jscenes), jgrid,
                                   dataclasses.replace(jconfig, **change))
    grid, _, config = _port_problem(jgrid, jscenes[0], jconfig)
    scenes = [scene_from_numpy({k: np.asarray(v)
                                for k, v in s._asdict().items()},
                               device='cpu')
              for s in jscenes]
    batch = tpipeline.stack_scenes(scenes)
    assert batch.tlevel.shape == (3, NLEVEL)
    assert batch.ubar0.dim() == (3 if geometry == 'phase' else 2)
    assert batch.F0PI.dim() == 1
    out = tpipeline.forward_batch(batch, grid,
                                  dataclasses.replace(config, **change))
    assert set(out) == set(want)
    for key in out:
        assert out[key].shape == (3, NWNO)
        rtol = 1e-8 if key == 'transit_depth' else 2e-5
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]),
                                   rtol=rtol, err_msg=key)
    if geometry == 'phase':
        # with_geometry builds the same scene from the port's disco
        g = tdisco.make_geometry(0.8, num_gangle=6, num_tangle=6)
        moved = tpipeline.with_geometry(scenes[0], g)
        for name in ('ubar0', 'ubar1', 'gweight', 'tweight', 'cos_theta'):
            assert torch.equal(getattr(moved, name),
                               getattr(scenes[1], name)), name


@pytest.mark.parametrize('change', [
    dict(), dict(thermal=False), dict(fuse_optics=False),
    dict(test_mode='rayleigh'), dict(use_kernels=False)])
def test_unported_configurations_raise(jax_problem, change):
    """multi_phase=2 (isotropic), which every Toon route raised on until
    it was ported, now runs on each of them: K2's, K3's and K5's twins
    (the fused, reflected-only, unfused and test-mode routes) and the plain
    path, each against the JAX scan path (use_pallas=False) at the same
    setting: rtol 2e-5 for the twins, 1e-10 for the plain path, transit
    1e-8.  An unknown multi_phase raises."""
    jgrid, jscene, jconfig, _ = jax_problem
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    config = dataclasses.replace(
        config, controls=ScatteringControls(multi_phase=2), **change)
    jcfg = dataclasses.replace(
        jconfig, controls=dataclasses.replace(jconfig.controls,
                                              multi_phase=2),
        **{k: v for k, v in change.items()
           if k in ('thermal', 'test_mode')})
    assert not jcfg.use_pallas
    want = jpipeline.forward(jscene, jgrid, jcfg)
    out = tpipeline.forward(scene, grid, config)
    assert set(out) == set(want)
    rtol = 1e-10 if change.get('use_kernels') is False else 2e-5
    for key in out:
        np.testing.assert_allclose(
            out[key].numpy(), np.asarray(want[key]),
            rtol=1e-8 if key == 'transit_depth' else rtol, err_msg=key)
    # isotropic differs from N=2 (the default) where the clouds scatter
    n2 = tpipeline.forward(scene, grid, dataclasses.replace(
        config, controls=ScatteringControls()))
    assert not torch.allclose(out['albedo'], n2['albedo'], rtol=1e-6)
    with pytest.raises(ValueError, match='multi_phase'):
        tpipeline.forward(scene, grid, dataclasses.replace(
            config, controls=ScatteringControls(multi_phase=3)))


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
    scene, grid, config = tpipeline.build_problem(64, production=False,
                                                  device='cpu')
    assert scene.ubar0.shape == (5, 1)
    assert scene.tlayer.shape == (90,)
    assert grid.log_kappa.shape == (6, 150, 64)
    assert config.transmission and config.use_kernels
    assert scene.cld_opd.dtype == torch.float64
    out = tpipeline.forward(scene, grid, config)
    assert all(torch.isfinite(v).all() for v in out.values())


@pytest.mark.parametrize('raman', [0, 1])
def test_build_problem_raman_modes(raman):
    """build_problem's Raman inputs: the Pollack row, or the Oklopcic
    table with the 5700 K star's shift ratios; the factor then differs
    from the neutral 0.99999 and the forward stays finite."""
    scene, grid, config = tpipeline.build_problem(64, nlevel=21,
                                                  production=False,
                                                  raman=raman, device='cpu')
    assert config.raman == raman
    wno = grid.wno.numpy()
    if raman == 1:
        np.testing.assert_array_equal(
            scene.raman_pollack_row.numpy(),
            traman.raman_factor_pollack(1, 1e4 / wno)[0])
    else:
        db = traman.load_raman_db()
        np.testing.assert_array_equal(
            scene.raman_shifts.numpy(),
            tpipeline.stellar_shifts_5700k(wno, db).T)
        np.testing.assert_array_equal(scene.raman_dnu.numpy(),
                                      db['deltanu'])
    _, _, rf = tpipeline.rt_sources(scene, grid, config)
    assert rf.shape == (20, 64) and (rf < 0.99999).any()
    out = tpipeline.forward(scene, grid, config)
    assert all(torch.isfinite(v).all() for v in out.values())


_DATA_ENTRY_POINTS = {
    'build_problem': lambda: tpipeline.build_problem(64, production=False),
    'synthetic_opacity_grid': lambda: tfactory.synthetic_opacity_grid(
        np.linspace(1000.0, 2000.0, 8)),
    'synthetic_opacity_grid_ragged':
        lambda: tfactory.synthetic_opacity_grid_ragged(
            np.linspace(1000.0, 2000.0, 8), ('H2O',)),
    'grid_from_numpy': lambda: grid_from_numpy({}, (), ()),
    'scene_from_numpy': lambda: scene_from_numpy({}),
    'load_opacity_db': lambda: tdb.load_opacity_db('missing.db'),
}


@pytest.mark.parametrize('entry', list(_DATA_ENTRY_POINTS))
def test_data_entry_points_default_to_the_card(entry):
    """The entry points that build data run on the card unless the caller
    asks for the CPU: without a card they raise, never falling back."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present, so the default runs there')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        _DATA_ENTRY_POINTS[entry]()
