"""The port's mesh and photochemistry examples against the JAX package's
runs of its own (tests/examples_reference.json, written by
tests/examples_record.py).

Each port example runs whole on the CPU (``cpu``: float64, the kernels'
twins) in a process of its own, and its printed lines are held to the JAX
example's ``JAX_ENABLE_X64=1`` run:

- mesh: the retrieval's line (scale, logz, posterior samples) exactly, as
  the sampler is bit for bit the JAX one for the same seed and both
  likelihoods are float64; the climate line's ``converged`` and ``nstr``
  exactly and its T range within 1 K; no kernel launch on the CPU;
- photochemistry: ``converged``, the T range and the kinetics count
  exactly as printed.

Each whole example takes minutes on one CPU thread (mostly the sampler's
~7000 sharded forwards, and the coupled solve), so those two tests are
``slow``.  In their place the tier-1 tests run the examples' own
functions: the mesh example's retrieval at ``nlive`` 10 and ``dlogz`` 2
against the JAX example's calls, its sharded solve against the record's
climate line, and the photochemistry example's coupled solve on the
48-bin slice of the table against the JAX example's calls there.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
EXAMPLES = os.path.join(ROOT, 'picaso_tpu_torch', 'examples')
MESH = 'mesh_sharded_retrieval_climate.py'
PHOTOCHEM = 'photochem_coupled_climate.py'
CPU = torch.device('cpu')
T_RANGE_K = 1          # the climate line's T range, K
CLIMATE_LINE = re.compile(
    r'sharded RCE: converged=(\w+), T = (\d+)\.\.(\d+) K, '
    r'conv zones at nstr=(\[[\d, ]*\])$')

torch.set_num_threads(1)


def record(name):
    """The JAX example's x64 run: exit code and printed lines."""
    with open(os.path.join(HERE, 'examples_reference.json')) as f:
        return json.load(f)[name]['x64']


def line(lines, prefix):
    (found,) = [ln for ln in lines if ln.startswith(prefix)]
    return found


def example(name):
    """The port example as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        name[:-3], os.path.join(EXAMPLES, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_on_cpu(name):
    """The port example as a script with ``cpu``, one thread."""
    proc = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, name), 'cpu'],
        capture_output=True, text=True, cwd=ROOT, timeout=1800,
        env=dict(os.environ, OMP_NUM_THREADS='1'))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.splitlines()


def check_climate_line(got, want):
    """``converged`` and ``nstr`` exactly, the T range within 1 K."""
    g, w = CLIMATE_LINE.match(got), CLIMATE_LINE.match(want)
    assert g and w, (got, want)
    assert (g[1], g[4]) == (w[1], w[4]), (got, want)
    for i in (2, 3):
        assert abs(int(g[i]) - int(w[i])) <= T_RANGE_K, (got, want)


@pytest.mark.slow
def test_mesh_example_matches_the_jax_record():
    want = record(MESH)
    assert want['returncode'] == 0
    got = run_on_cpu(MESH)
    assert line(got, 'mesh: ') == line(want['lines'], 'mesh: ')
    assert (line(got, 'retrieved scale') ==
            line(want['lines'], 'retrieved scale'))
    check_climate_line(line(got, 'sharded RCE'),
                       line(want['lines'], 'sharded RCE'))
    assert got[-2] == 'ok' and got[-1] == 'kernel launches: {}'


@pytest.mark.slow
def test_photochem_example_matches_the_jax_record():
    want = record(PHOTOCHEM)
    assert want['returncode'] == 0
    got = run_on_cpu(PHOTOCHEM)
    for prefix in ('photochem not installed', 'converged:', 'T range:',
                   'kinetics solves', 'photochem-coupled climate OK'):
        assert line(got, prefix) == line(want['lines'], prefix)


def jax_retrieval(nlive, dlogz):
    """The JAX example's retrieval (its calls, its seed) at ``nlive`` and
    ``dlogz``, on the float64 grid."""
    import jax
    import jax.numpy as jnp

    from picaso_tpu import parallel, pipeline
    from picaso_tpu.opacities import factory
    from picaso_tpu.sampler import nested_sample

    mesh = parallel.make_mesh(n_wave=4, n_batch=2)
    wno = np.linspace(2000.0, 18000.0, 256)
    grid = factory.synthetic_opacity_grid(wno, ntemp=6, npress=5,
                                          dtype=np.float64)
    nlevel = 25
    pressure = np.logspace(-6, 2, nlevel)
    temperature = 1000.0 * (pressure / 10.0) ** 0.1 + 300.0
    mix = {'H2': np.zeros(nlevel) + 0.85, 'He': np.zeros(nlevel) + 0.14,
           'H2O': np.zeros(nlevel) + 5e-4, 'CH4': np.zeros(nlevel) + 3e-4}
    scene, config = pipeline.scene_from_arrays(
        pressure, temperature, mix, grid, gravity=2500.0, radius=7.1e9,
        mass=1.9e30, rstar=6.96e10, dtype=np.float64)
    grid_s = parallel.shard_grid(grid, mesh)

    def model_batch(scales, grid_in):
        def one(s):
            sc = scene._replace(tlevel=scene.tlevel * s[0],
                                tlayer=scene.tlayer * s[0])
            return pipeline.forward(sc, grid_in, config)['albedo']
        return jax.vmap(one)(scales)

    y = np.asarray(jax.jit(model_batch)(jnp.asarray([[1.05]]), grid_s))[0]
    y_s = jax.device_put(y, jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec('wave')))

    @jax.jit
    def ll_dev(scales, grid_in, y_in):
        alb = model_batch(scales, grid_in)
        return -0.5 * jnp.sum((alb - y_in[None]) ** 2, -1) / 1e-6

    loglike = parallel.sharded_loglike(lambda x: ll_dev(x, grid_s, y_s),
                                       mesh)
    return nested_sample(loglike, lambda u: 0.9 + 0.3 * u, 1, nlive=nlive,
                         seed=3, dlogz=dlogz)


def test_mesh_example_retrieval_matches_jax():
    """The example's ``retrieve`` on 8 CPU shards at nlive 10, dlogz 2:
    the JAX example's dead points, weights and logz."""
    from picaso_tpu_torch import parallel

    ex = example(MESH)
    mesh = parallel.make_mesh(n_wave=4, n_batch=2,
                              devices=parallel.mesh_devices(8, CPU))
    got, mean, forwards = ex.retrieve(mesh, CPU, nlive=10, dlogz=2.0)
    want = jax_retrieval(nlive=10, dlogz=2.0)
    assert got.samples.shape == want.samples.shape
    np.testing.assert_allclose(got.samples, want.samples, rtol=1e-10)
    np.testing.assert_allclose(got.weights, want.weights, rtol=1e-8)
    assert got.logz == pytest.approx(want.logz, abs=1e-8)
    assert mean == pytest.approx(
        float((want.samples[:, 0] * want.weights).sum()), rel=1e-10)


def test_mesh_example_climate_matches_the_jax_record():
    """The example's sharded climate (41 levels, 48 bins, 2 x 4 CPU
    shards) against the JAX example's x64 climate line."""
    from picaso_tpu_torch import parallel

    ex = example(MESH)
    mesh = parallel.make_mesh(n_wave=4, n_batch=2,
                              devices=parallel.mesh_devices(8, CPU))
    case, opa = ex.climate_case(CPU)
    out = case.climate(opa, verbose=False, mesh=mesh)
    temp = np.asarray(out['temperature'])
    got = (f"sharded RCE: converged={bool(out['converged'])}, "
           f'T = {temp.min():.0f}..{temp.max():.0f} K, '
           f"conv zones at nstr={[int(i) for i in out['cvz_locs']]}")
    check_climate_line(got, line(record(MESH)['lines'], 'sharded RCE'))


def photochem_lines(out, calls):
    """The photochemistry example's printed results."""
    temp = np.asarray(out['temperature'])
    return [f'converged: {bool(out["converged"])}',
            f'T range: {temp.min():.0f} - {temp.max():.0f} K',
            f'kinetics solves during the climate run: {calls}']


def jax_coupled(js, nlevel=31):
    """The JAX example's coupled solve (its calls, its mock kinetics on
    the DataFrame profile) on the CK table ``js``."""
    from picaso_tpu import justdoit as jdi

    opa = jdi.opannection(ck_table=js, method='preweighted')
    case = jdi.inputs(calculation='brown', climate=True)
    case.phase_angle(0)
    case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.effective_temp(700.0)
    case.setup_nostar()
    case.setup_climate()
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(700.0 * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    case.inputs_climate(temp_guess=guess, pressure=pressure,
                        rcb_guess=nlevel - 3, rfacv=0.0)

    class MockKinetics:
        calls = 0

        def run_for_picaso(self, df, log10mh, cto, kz, df_comp_guess=None,
                           **kw):
            MockKinetics.calls += 1
            out = df.copy()
            if 'CH4' in out:
                out['CH4'] = float(np.asarray(out['CH4'])[-1])
            return out

    case.inputs['climate']['pc'] = MockKinetics()
    out = case.climate(opa, diseq_chem=True, verbose=False)
    return out, MockKinetics.calls


def test_photochem_example_matches_jax_on_the_48_bin_slice():
    """The example's ``coupled_case`` on the synthetic table's stride-4,
    48-bin slice with its per-gas tables (the JAX float64 table carried
    across) against the JAX example's calls on the same table: the same
    printed lines, convective zones and frozen CH4."""
    from climate_modes_record import jax_table
    from torch_climate_modes_cases import port_table

    js = jax_table(dict(table=196, slice=[4, 192]))
    ex = example(PHOTOCHEM)
    case, opa, pc = ex.coupled_case(CPU, ck=port_table(js))
    out = case.climate(opa, diseq_chem=True, verbose=False)
    want, calls = jax_coupled(js)
    assert photochem_lines(out, pc.calls) == photochem_lines(want, calls)
    assert pc.calls >= 2
    assert [int(i) for i in out['cvz_locs']] == [
        int(i) for i in want['cvz_locs']]
    prof = case.inputs['atmosphere']['profile']
    assert np.isfinite(out['temperature']).all()
    assert np.allclose(prof['CH4'], prof['CH4'][-1])


@pytest.mark.parametrize('name', [MESH, PHOTOCHEM])
def test_example_refuses_the_cpu_unasked(name):
    """With no card and no ``cpu`` argument an example raises before any
    work: nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is visible')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        example(name).main([])
