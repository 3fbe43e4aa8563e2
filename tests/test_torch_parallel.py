"""The port's device mesh (picaso_tpu_torch.parallel) on the CPU, in
float64, with its shards on ``torch.device('cpu')`` named 8 times: the
counterpart of the 8 virtual devices tests/conftest.py gives the JAX
package.  Each sharded path is held two ways:

- against the port's own unsharded result: the forward paths (Toon, its
  split solves, SH4, Oklopcic Raman, the int16 table, forward_batch, the
  batched phase curve, the likelihoods) bitwise where every wave shard
  spans a whole number of the CPU's 16-double vector blocks (nwno 256 over
  8 or 4 shards).  At other widths torch's CPU kernels compute the last
  elements of a row in a scalar tail loop, whose exp can round an ulp away
  from the vector one, so there the JAX tests' rtol 1e-10 applies
  (measured max rel ~3e-16); on the card each element is computed alike
  and chip_smoke.py gates bitwise.  The climate at the JAX tests'
  tolerances (its wave sums add in another order);
- against the JAX package's sharded result on the 8 virtual devices, at
  the tolerance the port's tests hold its unsharded path to the JAX
  package's (forward rtol 2e-5, SH 1e-7, transit 1e-8, int16 the
  quantization bound; a profile step rtol 1e-8 on T, 1e-6 on fluxes).

A width or a batch that the mesh does not divide raises in both.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from picaso_tpu import justdoit as jdi
from picaso_tpu import parallel as jparallel
from picaso_tpu import pipeline as jpipeline
from picaso_tpu.climate import fused as jfused
from picaso_tpu.opacities import factory as jfactory

from picaso_tpu_torch import justdoit as tdi
from picaso_tpu_torch import parallel as tparallel
from picaso_tpu_torch import pipeline as tpipeline
from picaso_tpu_torch.climate import core as tcore
from picaso_tpu_torch.climate import fused as tfused
from picaso_tpu_torch.opacities import factory as tfactory
from picaso_tpu_torch.sampler import nested_sample

from test_torch_climate_fluxes import close, jax_twins, port_state
from test_torch_climate_fluxes import sliced_tables
from test_torch_pipeline import _KW, _port_problem, _profile
from torch_facade_cases import assert_same, connections

torch.set_num_threads(1)

CPU = torch.device('cpu')
MESHES = [(8, 1), (4, 2)]     # (n_wave, n_batch)


def mesh(n_wave, n_batch):
    return tparallel.make_mesh(n_wave=n_wave, n_batch=n_batch,
                               devices=[CPU] * 8)


def mesh_id(shape):
    return f'wave{shape[0]}x{shape[1]}'


def assert_bitwise(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        assert got[key].shape == ref[key].shape, key
        assert torch.equal(got[key], ref[key]), (
            key, float((got[key] - ref[key]).abs().max()))


@pytest.fixture(scope='module')
def problem():
    """The 16-molecule ragged grid at nwno 256 and the cloudy 31-level
    scene with transmission of tests/test_torch_pipeline.py, built by the
    JAX package in float64 and carried across."""
    wno = np.linspace(300.0, 33000.0, 256)
    jgrid = jfactory.synthetic_opacity_grid_ragged(
        wno, molecules=tpipeline.MOLECULES_16, dtype=np.float64)
    pressure, temperature, mix, cld = _profile()
    jscene, jconfig = jpipeline.scene_from_arrays(
        pressure, temperature, mix, jgrid, cld=cld, dtype=np.float64, **_KW)
    grid, scene, config = _port_problem(jgrid, jscene, jconfig)
    return (jgrid, jscene, jconfig), (grid, scene, config)


PATHS = {'toon': {}, 'reflected': dict(thermal=False),
         'thermal': dict(reflected=False), 'unfused': dict(fuse_optics=False),
         'sh4': dict(rt_method=1, stream=4), 'oklopcic': None}


@pytest.mark.parametrize('shape', MESHES, ids=mesh_id)
@pytest.mark.parametrize('path', PATHS)
def test_sharded_forward_is_bitwise(problem, path, shape):
    """Every Toon route, SH4 and the Oklopcic Raman factor: bitwise the
    unsharded forward, on 8 x 32 and 4 x 64 bins (4 x 64 also over 2
    batch rows, which an unbatched scene leaves to row 0)."""
    _, (grid, scene, config) = problem
    if path == 'oklopcic':
        scene, grid, config = tpipeline.with_raman(scene, grid, config, 0)
    else:
        config = dataclasses.replace(config, **PATHS[path])
    m = mesh(*shape)
    got = tparallel.sharded_forward(tparallel.shard_scene(scene, m),
                                    tparallel.shard_grid(grid, m), config, m)
    assert_bitwise(got, tpipeline.forward(scene, grid, config))


@pytest.mark.parametrize('shape', MESHES, ids=mesh_id)
@pytest.mark.parametrize('path', ['toon', 'sh4'])
def test_sharded_forward_matches_jax_sharded(problem, path, shape):
    (jgrid, jscene, jconfig), (grid, scene, config) = problem
    kw = PATHS[path]
    config = dataclasses.replace(config, **kw)
    jconfig = dataclasses.replace(jconfig, **kw)
    m = mesh(*shape)
    got = tparallel.sharded_forward(tparallel.shard_scene(scene, m),
                                    tparallel.shard_grid(grid, m), config, m)
    jm = jparallel.make_mesh(n_wave=shape[0], n_batch=shape[1])
    want = jparallel.sharded_forward(jparallel.shard_scene(jscene, jm),
                                     jparallel.shard_grid(jgrid, jm),
                                     jconfig, jm)
    rtol = 1e-7 if path == 'sh4' else 2e-5
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(val),
                                   rtol=1e-8 if key == 'transit_depth'
                                   else rtol, err_msg=key)


def test_sharded_forward_at_a_width_off_the_vector_blocks():
    """200 bins over 8 shards of 25 (the JAX tests' width): within the
    JAX test's rtol 1e-10 of the unsharded forward (the scalar tail
    loop's exp, see the module docstring)."""
    scene, grid, config = tpipeline.build_problem(200, nlevel=25,
                                                  production=False,
                                                  device='cpu')
    m = mesh(8, 1)
    got = tparallel.sharded_forward(tparallel.shard_scene(scene, m),
                                    tparallel.shard_grid(grid, m), config, m)
    ref = tpipeline.forward(scene, grid, config)
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), ref[key].numpy(),
                                   rtol=1e-10, atol=0, err_msg=key)


@pytest.mark.parametrize('shape', MESHES, ids=mesh_id)
def test_int16_grid_sharded(problem, shape):
    """The flat int16 table cut on its last axis: the forward through K8's
    twin bitwise the unsharded int16 forward, and within the quantization
    bound of tests/test_torch_quantized.py of the JAX package's sharded
    forward on the float table."""
    (jgrid, jscene, jconfig), (grid, scene, config) = problem
    gq = grid.with_blocked_table(quantize=True)
    m = mesh(*shape)
    gq_s = tparallel.shard_grid(gq, m)
    for row in gq_s.shards:
        for piece in row:
            assert piece.log_kappa_blocked.dtype == torch.int16
            assert piece.log_kappa_blocked.is_contiguous()
            assert piece.log_kappa_blocked.shape[-1] == 256 // shape[0]
    got = tparallel.sharded_forward(tparallel.shard_scene(scene, m), gq_s,
                                    config, m)
    assert_bitwise(got, tpipeline.forward(scene, gq, config))
    jm = jparallel.make_mesh(n_wave=shape[0], n_batch=shape[1])
    want = jparallel.sharded_forward(jparallel.shard_scene(jscene, jm),
                                     jparallel.shard_grid(jgrid, jm),
                                     jconfig, jm)
    step = gq.blocked_qparams[0].item()
    rtol = 5 * (10.0 ** (0.5 * step) - 1.0 + 1e-4)
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), np.asarray(val),
                                   rtol=rtol, err_msg=key)


def test_shards_hold_their_slices(problem):
    """Each device piece is a contiguous copy of its slice; the wave
    fields cut, the rest replicated; batch rows of an unbatched scene
    share row 0's tensors where the device is the same."""
    _, (grid, scene, _) = problem
    m = mesh(4, 2)
    ss, gs = tparallel.shard_scene(scene, m), tparallel.shard_grid(grid, m)
    for w in range(4):
        sl = slice(64 * w, 64 * (w + 1))
        piece = gs.shards[0][w]
        assert torch.equal(piece.log_kappa, grid.log_kappa[..., sl])
        assert piece.log_kappa.is_contiguous()
        assert piece.log_kappa.data_ptr() != grid.log_kappa.data_ptr()
        assert torch.equal(piece.cont_opa, grid.cont_opa[..., sl])
        assert torch.equal(piece.pt.nc_p, grid.pt.nc_p)
        assert gs.shards[1][w].log_kappa is piece.log_kappa
        s = ss.shards[0][w]
        assert torch.equal(s.cld_opd, scene.cld_opd[:, sl])
        assert torch.equal(s.F0PI, scene.F0PI[sl])
        assert torch.equal(s.tlevel, scene.tlevel)
        assert torch.equal(ss.shards[1][w].sigma_ray, s.sigma_ray)


def _scenes(scene, n):
    return [scene._replace(tlevel=scene.tlevel * (1 + 0.01 * i),
                           tlayer=scene.tlayer * (1 + 0.01 * i))
            for i in range(n)]


def test_sharded_forward_batch_is_bitwise(problem):
    """4 scenes of different temperatures (the retrieval case: the
    geometry fields stay unbatched) over 2 batch rows x 4 wave shards."""
    _, (grid, scene, config) = problem
    batch = tpipeline.stack_scenes(_scenes(scene, 4))
    assert batch.ubar0.dim() == 2        # batch-constant, unbatched
    m = mesh(4, 2)
    got = tparallel.sharded_forward_batch(
        tparallel.shard_scene(batch, m, batched=True),
        tparallel.shard_grid(grid, m), config, m)
    assert_bitwise(got, tpipeline.forward_batch(batch, grid, config))


@pytest.fixture(scope='module')
def curve_dbs(tmp_path_factory):
    """The facade's synthetic database at 256 bins (whole vector blocks
    over 8 shards), both connections in float64."""
    path = str(tmp_path_factory.mktemp('mesh') / 'syn256.db')
    jfactory.build_synthetic_db(path, np.linspace(2000.0, 12000.0, 256),
                                ntemp=6, npress=5)
    return connections(path)


def _curve_case(module, opa, calculation):
    from torch_facade_cases import egp_clouds, planet, profile
    import pandas as pd
    case = module.inputs()
    planet(case, module, opa)
    case.phase_angle(phase_grid=np.radians([0.0, 45.0, 90.0, 120.0]),
                     num_gangle=6, num_tangle=6, calculation=calculation)
    prof = profile()
    case.atmosphere(df=pd.DataFrame(prof))
    case.clouds(df=pd.DataFrame(egp_clouds(len(prof['pressure']) - 1)))
    return case


@pytest.mark.parametrize('shape', [(8, 1), (2, 2), (4, 2)], ids=mesh_id)
@pytest.mark.parametrize('calculation', ['reflected', 'thermal'])
def test_sharded_phase_curve(curve_dbs, calculation, shape):
    """The batched 4-phase curve through ``phase_curve(mesh=...)``:
    bitwise ``mesh=None``, and the JAX package's sharded curve within the
    facade tests' rtol 2e-5."""
    jopa, topa = curve_dbs
    m = mesh(*shape)
    got = _curve_case(tdi, topa, calculation).phase_curve(
        topa, verbose=False, mesh=m)
    ref = _curve_case(tdi, topa, calculation).phase_curve(
        topa, verbose=False)
    assert list(got) == list(ref)
    for phase in ref:
        for key in ref[phase]:
            np.testing.assert_array_equal(got[phase][key], ref[phase][key],
                                          err_msg=f'{phase} {key}')
    jm = jparallel.make_mesh(n_wave=shape[0], n_batch=shape[1])
    want = _curve_case(jdi, jopa, calculation).phase_curve(
        jopa, verbose=False, mesh=jm)
    assert_same(got, want)


@pytest.fixture(scope='module')
def retrieval_problem():
    """The forward problem of tests/test_parallel_climate.py:138-149:
    nwno 256, 25 levels, 4 molecules on a 6 x 5 grid; the JAX grid and
    scene in float64 carried across to the port."""
    nwno, nlevel = 256, 25
    wno = np.linspace(2000.0, 18000.0, nwno)
    pressure = np.logspace(-6, 2, nlevel)
    temperature = 1000.0 * (pressure / 10.0) ** 0.1 + 300.0
    mix = {'H2': np.zeros(nlevel) + 0.85, 'He': np.zeros(nlevel) + 0.14,
           'H2O': np.zeros(nlevel) + 5e-4, 'CH4': np.zeros(nlevel) + 3e-4}
    grid = tfactory.synthetic_opacity_grid(wno, ntemp=6, npress=5,
                                           device='cpu')
    scene, config = tpipeline.scene_from_arrays(
        pressure, temperature, mix, grid, gravity=2500.0, radius=7.1e9,
        mass=1.9e30, rstar=6.96e10)
    jgrid = jfactory.synthetic_opacity_grid(wno, ntemp=6, npress=5,
                                            dtype=np.float64)
    jscene, jconfig = jpipeline.scene_from_arrays(
        pressure, temperature, mix, jgrid, gravity=2500.0, radius=7.1e9,
        mass=1.9e30, rstar=6.96e10, dtype=np.float64)
    return (scene, grid, config), (jscene, jgrid, jconfig)


def _model(scene, grid, config, scales):
    return torch.stack([tpipeline.forward(
        scene._replace(tlevel=scene.tlevel * s[0],
                       tlayer=scene.tlayer * s[0]), grid, config)['albedo']
        for s in scales])


def _sharded_model(scene_s, grid_s, config, m, scales, b):
    out = []
    for s in scales:
        scaled = scene_s.row(b).map(lambda sc: sc._replace(
            tlevel=sc.tlevel * s[0].to(sc.tlevel.device),
            tlayer=sc.tlayer * s[0].to(sc.tlevel.device)))
        out.append(tparallel.sharded_forward(scaled, grid_s.row(b), config,
                                             m.row(b))['albedo'])
    return torch.stack(out)


def test_sharded_loglike_nested_sampler(retrieval_problem):
    """tests/test_parallel_climate.py:152-199 in the port: nested_sample
    over a likelihood whose live points shard over 'batch' and bins over
    'wave' (``sharded_loglike`` on a 2 x 2 mesh) reproduces the unsharded
    run (logz within 1e-6, samples rtol 1e-10; here the same dead points
    exactly), and the sharded model on the 2 x 4 mesh is the JAX package's
    sharded model within rtol 2e-5.  The likelihood reads the albedo
    alone, so the forward runs reflected-only (K3's twin); nlive 10 and
    dlogz 2 (the JAX test's 50 and 0.5 run in the mesh example on the
    card; chip_smoke.py's phase 52 runs 25 and 0.5) keep the two runs to
    ~1200 likelihood points each, ~40 s on one CPU thread."""
    (scene, grid, config), (jscene, jgrid, jconfig) = retrieval_problem
    config = dataclasses.replace(config, thermal=False, transmission=False)
    truth = 1.02
    y = _model(scene, grid, config, torch.tensor([[truth]]))[0]

    def ll_ref(x):
        alb = _model(scene, grid, config, torch.as_tensor(x))
        return (-0.5 * ((alb - y[None]) ** 2).sum(-1) / 1e-6).numpy()

    def prior(u):
        return 0.9 + 0.3 * u

    ref = nested_sample(ll_ref, prior, 1, nlive=10, seed=11, dlogz=2.0)

    m = mesh(2, 2)
    scene_s = tparallel.shard_scene(scene, m)
    grid_s = tparallel.shard_grid(grid, m)
    rows = []

    def ll_row(x, b):
        rows.append((b, x.shape[0], x.device))
        alb = _sharded_model(scene_s, grid_s, config, m, x, b)
        return -0.5 * ((alb - y[None]) ** 2).sum(-1) / 1e-6

    got = nested_sample(tparallel.sharded_loglike(ll_row, m), prior, 1,
                        nlive=10, seed=11, dlogz=2.0)
    assert got.logz == pytest.approx(ref.logz, abs=1e-6)
    np.testing.assert_allclose(got.samples, ref.samples, rtol=1e-10)
    assert got.logz == ref.logz and np.array_equal(got.samples,
                                                   ref.samples)
    mean_ref = float((ref.samples[:, 0] * ref.weights).sum())
    assert mean_ref == pytest.approx(truth, abs=2e-2)
    assert {b for b, _, _ in rows} == {0, 1}
    assert {n for _, n, _ in rows if n} and all(
        dev == CPU for _, _, dev in rows)

    # the sharded model against the JAX package's sharded model
    x = np.array([[0.95], [1.0], [1.02], [1.1]])
    m = mesh(4, 2)
    scene_s = tparallel.shard_scene(scene, m)
    grid_s = tparallel.shard_grid(grid, m)
    jm = jparallel.make_mesh(n_wave=4, n_batch=2)
    jgrid_s = jparallel.shard_grid(jgrid, jm)

    def jmodel(scales, grid_in):
        def one(s):
            sc = jscene._replace(tlevel=jscene.tlevel * s[0],
                                 tlayer=jscene.tlayer * s[0])
            return jpipeline.forward(sc, grid_in, jconfig)['albedo']
        return jax.vmap(one)(scales)

    want = np.asarray(jax.jit(jmodel)(
        jax.device_put(x, jax.sharding.NamedSharding(
            jm, jax.sharding.PartitionSpec('batch', None))), jgrid_s))
    got_model = torch.cat([_sharded_model(
        scene_s, grid_s, config, m, torch.as_tensor(blk), b)
        for b, blk in enumerate(np.split(x, 2))])
    np.testing.assert_allclose(got_model.numpy(), want, rtol=2e-5)


def test_sharded_loglike_pads_and_orders():
    """A batch of 5 over 2 rows: padded with its last point, one call per
    row with that row's block on its device, the first 5 results in
    order, host numpy."""
    m = mesh(1, 2)
    calls = []

    def ll(x, b):
        calls.append((b, x.clone()))
        return x[:, 0] * 10.0 + b * 0.0

    x = np.arange(10.0).reshape(5, 2)
    out = tparallel.sharded_loglike(ll, m)(x)
    assert isinstance(out, np.ndarray) and out.tolist() == [
        0.0, 20.0, 40.0, 60.0, 80.0]
    assert [b for b, _ in calls] == [0, 1]
    assert calls[1][1].tolist() == [[6.0, 7.0], [8.0, 9.0], [8.0, 9.0]]
    assert calls[0][1].dtype == torch.float64


def test_sharded_batched_likelihood_matches(retrieval_problem):
    """tests/test_parallel_climate.py:202-235 in the port: a batched chi^2
    over 4 live points on the 2 x 4 mesh equals the unsharded one (the
    JAX test's rtol 2e-5; bitwise here) and the JAX package's sharded one
    within rtol 2e-5."""
    (scene, grid, config), (jscene, jgrid, jconfig) = retrieval_problem
    nwno = grid.wno.shape[0]
    y = np.float32(0.3 + 0.01 * np.random.default_rng(1)
                   .standard_normal(nwno))
    yt = torch.tensor(y, dtype=torch.float64)

    def loglike(out):
        return -0.5 * ((out['albedo'] - yt[None]) ** 2).sum(-1)

    batch = tpipeline.stack_scenes(_scenes(scene, 4))
    ref = loglike(tpipeline.forward_batch(batch, grid, config))
    m = mesh(4, 2)
    got = loglike(tparallel.sharded_forward_batch(
        tparallel.shard_scene(batch, m, batched=True),
        tparallel.shard_grid(grid, m), config, m))
    assert torch.isfinite(ref).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-5)
    assert torch.equal(got, ref)

    jbatch = jpipeline.stack_scenes(_scenes(jscene, 4))
    jm = jparallel.make_mesh(n_wave=4, n_batch=2)
    jout = jpipeline.forward_batch(
        jparallel.shard_scene(jbatch, jm, batched=True),
        jparallel.shard_grid(jgrid, jm), jconfig)
    want = -0.5 * np.sum((np.asarray(jout['albedo']) - y[None]) ** 2, -1)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5)


@pytest.fixture(scope='module')
def climate_problem():
    """tests/test_parallel_climate.py:27-52 in both packages: the 700 K
    brown dwarf at 41 levels on the 196-bin table (49 bins a wave shard),
    the guess and 1.02 x the guess."""
    nlevel = 41
    js, ts = sliced_tables(1)
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    nstr = (0, nlevel - 8, nlevel - 2, 0, 0, 0)
    state = port_state(ts, pressure, guess, nstr)
    zones = tcore.zone_maps(nstr, 1, nlevel)
    config = state.fused_config(it_max=1, egp_stepmax=False)
    temps = np.stack([guess, guess * 1.02])
    return js, state, zones, config, temps


def test_sharded_profile_step(climate_problem):
    """One profile step of each profile over ``make_mesh(n_wave=4,
    n_batch=2)`` (each batch row steps its profile on its 4 wave shards)
    against the unsharded steps: T rtol 5e-5 / atol 1e-3 K, the layer
    fluxes rtol 5e-4 (tests/test_parallel_climate.py:62-78); and against
    the JAX package's sharded step at the port-vs-JAX profile-step
    tolerance (T rtol 1e-8, fluxes 1e-6)."""
    js, state, zones, config, temps = climate_problem
    st = state
    refs = [tfused.profile_step(torch.tensor(t), zones, st.data,
                                st.chem_grid, st.ck.arrays, st.geom,
                                st.adiabat, config) for t in temps]
    t_ref = torch.stack([r[0] for r in refs]).numpy()
    f_ref = torch.stack([r[3] for r in refs]).numpy()

    m = mesh(4, 2)
    temps_s, data_s, ck_s = tparallel.shard_climate(
        temps, st.data, st.ck.arrays, m)
    assert [t.shape for t in temps_s] == [(1, 41), (1, 41)]
    assert [d.F0PI.shape[0] for d in data_s.wave.data[0]] == [49] * 4
    assert data_s.wave.ck[1][3].ln_kappa.shape[2] == 49
    counts = tfused.ClimateCounts()
    t_sh, conv, dtdp, fnil, fnvl, fpit = tparallel.sharded_profile_step(
        temps_s, zones, data_s, st.chem_grid, ck_s, st.geom, st.adiabat,
        config, counts)
    assert counts.profile_steps == 2 and counts.jacobians >= 2
    assert np.isfinite(t_ref).all()
    np.testing.assert_allclose(t_sh.numpy(), t_ref, rtol=5e-5, atol=1e-3)
    np.testing.assert_allclose(fnil.numpy(), f_ref, rtol=5e-4,
                               atol=5e-4 * np.abs(f_ref).max())
    assert fpit.shape == (2, 196)

    from picaso_tpu.climate import core as jcore
    jdata, jconfig, jchem, jadiabat, jgeom = jax_twins(st, js, it_max=1)
    jz = jcore.zone_maps([0, 33, 39, 0, 0, 0], 1, 41)

    def step(t_all, data, ckarr):
        def one(t):
            out = jfused.profile_step(t, jz, data, jchem, ckarr, jgeom,
                                      jadiabat, jconfig)
            return out[0], out[3]
        return jax.vmap(one)(t_all)

    jm = jparallel.make_mesh(n_wave=4, n_batch=2)
    jt, jd, jc = jparallel.shard_climate(temps, jdata, js.arrays, jm)
    jt_sh, jf_sh = jax.jit(step)(jt, jd, jc)
    np.testing.assert_allclose(t_sh.numpy(), np.asarray(jt_sh), rtol=1e-8)
    close(fnil.numpy(), np.asarray(jf_sh), rtol=1e-6)


def _rce_inputs(nlevel=41):
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    from picaso_tpu_torch.climate import api as tapi
    return tapi.ClimateInputs(t_eff=700.0, gravity=1e4, pressure=pressure,
                              guess=guess,
                              nstr=(0, nlevel - 8, nlevel - 2, 0, 0, 0))


@pytest.mark.slow
def test_full_climate_solve_sharded_equals_single():
    """tests/test_parallel_climate.py:116-135 in the port: the whole
    run_climate on the stride-4, 48-bin slice at 41 levels over a 2 x 4
    mesh converges as the single-device solve (same cvz_locs, T within
    rtol 1e-4 / atol 0.05 K), and as the JAX package's sharded solve,
    within the same bound: the two packages add the wave shards' sums in
    different orders, which the Newton steps amplify (measured 1.9e-5 K;
    unsharded, the port ends ~1e-10 K from the JAX solve)."""
    from picaso_tpu_torch.climate import api as tapi
    from test_parallel_climate import _rce_case, _sliced_ck
    js = _sliced_ck()
    _, ts = sliced_tables(4, 192)
    assert ts.nwno == len(np.asarray(js.wno)) == 48
    ref = tapi.run_climate(_rce_inputs(), ts, verbose=False, device='cpu')
    got = tapi.run_climate(_rce_inputs(), ts, verbose=False, device='cpu',
                           mesh=mesh(4, 2))
    assert ref['converged'] and got['converged']
    assert list(got['cvz_locs']) == list(ref['cvz_locs'])
    np.testing.assert_allclose(got['temperature'], ref['temperature'],
                               rtol=1e-4, atol=0.05)
    case, opa = _rce_case(js)
    jgot = case.climate(opa, verbose=False,
                        mesh=jparallel.make_mesh(n_wave=4, n_batch=2))
    assert list(got['cvz_locs']) == [int(i) for i in jgot['cvz_locs']]
    np.testing.assert_allclose(got['temperature'], jgot['temperature'],
                               rtol=1e-4, atol=0.05)


def test_width_mesh_does_not_divide(problem):
    """What the JAX package's device_put refuses, the port refuses: 201
    bins over 8 wave shards, 3 scenes over 2 batch rows, 16 shards on 8
    devices; and a mesh without devices= takes the cards, of which there
    are none here."""
    (jgrid, jscene, _), (grid, scene, _) = problem
    wno = np.linspace(300.0, 33000.0, 201)
    tg = tfactory.synthetic_opacity_grid(wno, ntemp=4, npress=3,
                                         device='cpu')
    jg = jfactory.synthetic_opacity_grid(wno, ntemp=4, npress=3)
    with pytest.raises(ValueError, match='divide'):
        tparallel.shard_grid(tg, mesh(8, 1))
    with pytest.raises(ValueError, match='divisible'):
        jparallel.shard_grid(jg, jparallel.make_mesh(n_wave=8, n_batch=1))
    batch = tpipeline.stack_scenes(_scenes(scene, 3))
    with pytest.raises(ValueError, match='divide'):
        tparallel.shard_scene(batch, mesh(4, 2), batched=True)
    jbatch = jpipeline.stack_scenes(_scenes(jscene, 3))
    with pytest.raises(ValueError, match='divisible'):
        jparallel.shard_scene(jbatch, jparallel.make_mesh(n_wave=4,
                                                          n_batch=2),
                              batched=True)
    with pytest.raises(ValueError):
        tparallel.make_mesh(n_wave=16, devices=[CPU] * 8)
    with pytest.raises(ValueError):
        jparallel.make_mesh(n_wave=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='devices='):
            tparallel.make_mesh(n_wave=2)
    with pytest.raises(ValueError, match='batch'):
        tparallel.sharded_forward_batch(
            tparallel.shard_scene(scene, mesh(8, 1)),
            tparallel.shard_grid(grid, mesh(8, 1)), None, mesh(8, 1))


def test_mesh_devices():
    """The examples' and chip_smoke.py's devices for a mesh: n times the
    CPU for a CPU device; the visible cards, the first repeated, else a
    refusal, for a CUDA one (nothing falls back to the CPU)."""
    assert tparallel.mesh_devices(3, 'cpu') == [CPU] * 3
    if torch.cuda.is_available():
        got = tparallel.mesh_devices(8)
        assert len(got) == 8 and {d.type for d in got} == {'cuda'}
    else:
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tparallel.mesh_devices(8)
