"""The twins of the split Toon kernels against the JAX package's Pallas
kernels, and combine_optics' test modes against JAX.

Same inputs (numpy, from a seed) go through the JAX functions in float64
and through picaso_tpu_torch on the CPU in float64:
- reflected_toon_plain (twin of K3) against reflected_pallas_fused and
  thermal_toon_plain (twin of K4) against thermal_pallas_fused, in
  interpret mode with block_w=256 as tests/test_pallas_toon.py runs them;
- reflected_toon_props_plain (K5) against reflected_pallas and
  thermal_toon_props_plain (K6) against thermal_pallas, on the props of
  combine_optics with each test_mode;
- the port's combine_optics against JAX's, field by field.
Twins and Pallas kernels share the arithmetic: rtol 1e-8 (the cumulative
tau is a cumsum here, a triangular matmul there).  combine_optics is the
same elementwise arithmetic: rtol 1e-13.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu.optics import combine_optics as j_combine_optics
from picaso_tpu.rt import toon as jtoon
from picaso_tpu.rt.pallas_toon import (reflected_pallas,
                                       reflected_pallas_fused,
                                       thermal_pallas, thermal_pallas_fused)

from picaso_tpu_torch import optics as t_optics
from picaso_tpu_torch.rt import cuda_toon
from picaso_tpu_torch.rt import toon as ttoon

torch.set_num_threads(1)

NLAYER, NWNO, NANG = 16, 300, 3
TEST_MODES = [None, 'rayleigh', 'constant_tau']


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(23)
    shape = (NLAYER, NWNO)
    d = dict(taugas=rng.uniform(1e-4, 1.5, shape),
             tauray=rng.uniform(1e-5, 0.3, shape),
             copd=rng.uniform(0.0, 1.0, shape),
             cw0=rng.uniform(0.3, 0.99, shape),
             cg0=rng.uniform(0.0, 0.9, shape),
             rf=rng.uniform(0.9, 0.99999, shape),
             ubar0=rng.uniform(0.1, 1.0, (NANG, 1)),
             ubar1=rng.uniform(0.1, 1.0, (NANG, 1)),
             surf=np.full(NWNO, 0.1),
             F0PI=rng.uniform(0.5, 1.5, NWNO),
             tlevel=np.linspace(400.0, 1600.0, NLAYER + 1),
             wno=np.linspace(300.0, 20000.0, NWNO))
    # a few cells of zero cloud albedo: the test modes' w0 floor
    d['cw0'][::3, ::11] = 0.0
    d['all_b'] = np.array(jtoon.blackbody(jnp.asarray(d['tlevel']),
                                            1.0 / jnp.asarray(d['wno'])))
    return d


def _controls(single_phase):
    return (jtoon.ScatteringControls(single_phase=single_phase),
            ttoon.ScatteringControls(single_phase=single_phase))


def _close(got, want, rtol=1e-8):
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=1e-12)


@pytest.mark.parametrize('delta_eddington', [True, False])
@pytest.mark.parametrize('single_phase', [0, 1, 2, 3])
def test_reflected_twin_matches_pallas_fused(inputs, single_phase,
                                             delta_eddington):
    d = inputs
    jc, tc = _controls(single_phase)
    names = ('taugas', 'tauray', 'copd', 'cw0', 'cg0', 'rf', 'surf',
             'ubar0', 'ubar1')
    want = reflected_pallas_fused(
        *(jnp.asarray(d[k]) for k in names), 0.5, jnp.asarray(d['F0PI']),
        controls=jc, delta_eddington=delta_eddington, block_w=256,
        interpret=True)
    got = cuda_toon.reflected_toon_plain(
        *(torch.as_tensor(d[k]) for k in names), 0.5,
        torch.as_tensor(d['F0PI']), controls=tc,
        delta_eddington=delta_eddington)
    assert got.shape == (NANG, 1, NWNO)
    _close(got, want)


@pytest.mark.parametrize('hard_surface', [False, True])
def test_thermal_twin_matches_pallas_fused(inputs, hard_surface):
    d = inputs
    names = ('all_b', 'taugas', 'tauray', 'copd', 'cw0', 'cg0')
    want = thermal_pallas_fused(
        *(jnp.asarray(d[k]) for k in names), 0.7, jnp.asarray(d['surf']),
        jnp.asarray(d['ubar1']), hard_surface=hard_surface, block_w=256,
        interpret=True)
    got = cuda_toon.thermal_toon_plain(
        *(torch.as_tensor(d[k]) for k in names), 0.7,
        torch.as_tensor(d['surf']), torch.as_tensor(d['ubar1']),
        hard_surface=hard_surface)
    assert got.shape == (NANG, 1, NWNO)
    _close(got, want)


def _props(d, test_mode, delta_eddington=True):
    """(JAX RTProps, port RTProps) of the same inputs."""
    names = ('taugas', 'tauray', 'copd', 'cw0', 'cg0', 'rf')
    jp = j_combine_optics(*(jnp.asarray(d[k]) for k in names),
                          test_mode=test_mode,
                          delta_eddington=delta_eddington, stream=2)
    tp = t_optics.combine_optics(*(torch.as_tensor(d[k]) for k in names),
                                 test_mode=test_mode,
                                 delta_eddington=delta_eddington, stream=2)
    return jp, tp


@pytest.mark.parametrize('delta_eddington', [True, False])
@pytest.mark.parametrize('test_mode', TEST_MODES)
def test_combine_optics_matches_jax(inputs, test_mode, delta_eddington):
    """With clear cells as well, for constant_tau's dtau floor (the RT
    tests leave them out: 1e-10 layers make the thermal solve
    ill-conditioned, JAX's own scan and Pallas paths differ by ~3e-6
    there)."""
    d = dict(inputs, copd=inputs['copd'].copy())
    d['copd'][::5, ::7] = 0.0
    jp, tp = _props(d, test_mode, delta_eddington)
    for name in t_optics.RTProps._fields:
        got, want = getattr(tp, name), np.asarray(getattr(jp, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=0,
                                   err_msg=name)


@pytest.mark.parametrize('single_phase', [0, 3])
@pytest.mark.parametrize('test_mode', TEST_MODES)
def test_reflected_props_twin_matches_reflected_pallas(inputs, test_mode,
                                                       single_phase):
    d = inputs
    jp, tp = _props(d, test_mode)
    jc, tc = _controls(single_phase)
    fields = cuda_toon.REFLECTED_FIELDS
    want = reflected_pallas(
        *(getattr(jp, f) for f in fields), jnp.asarray(d['surf']),
        jnp.asarray(d['ubar0']), jnp.asarray(d['ubar1']), 0.5,
        jnp.asarray(d['F0PI']), controls=jc, block_w=256, interpret=True)
    got = cuda_toon.reflected_toon_props_plain(
        *(getattr(tp, f) for f in fields), torch.as_tensor(d['surf']),
        torch.as_tensor(d['ubar0']), torch.as_tensor(d['ubar1']), 0.5,
        torch.as_tensor(d['F0PI']), controls=tc)
    assert got.shape == (NANG, 1, NWNO)
    _close(got, want)


@pytest.mark.parametrize('hard_surface', [False, True])
@pytest.mark.parametrize('test_mode', TEST_MODES)
def test_thermal_props_twin_matches_thermal_pallas(inputs, test_mode,
                                                   hard_surface):
    d = inputs
    jp, tp = _props(d, test_mode)
    want = thermal_pallas(
        jnp.asarray(d['all_b']), jp.dtau_og, jp.w0_no_raman, jp.cosb_og,
        jp.dtau_og[0] * 0.7, jnp.asarray(d['surf']),
        jnp.asarray(d['ubar1']), hard_surface=hard_surface, block_w=256,
        interpret=True)
    got = cuda_toon.thermal_toon_props_plain(
        torch.as_tensor(d['all_b']), tp.dtau_og, tp.w0_no_raman,
        tp.cosb_og, tp.dtau_og[0] * 0.7, torch.as_tensor(d['surf']),
        torch.as_tensor(d['ubar1']), hard_surface=hard_surface)
    assert got.shape == (NANG, 1, NWNO)
    _close(got, want)


def _wrapper_args(d, name):
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    tp = t_optics.combine_optics(t['taugas'], t['tauray'], t['copd'],
                                 t['cw0'], t['cg0'], t['rf'])
    geom = (t['surf'], t['ubar0'], t['ubar1'], 0.5, t['F0PI'])
    strips = (t['taugas'], t['tauray'], t['copd'], t['cw0'], t['cg0'])
    return {
        'reflected_toon': strips + (t['rf'],) + geom,
        'thermal_toon': (t['all_b'],) + strips + (0.7, t['surf'],
                                                  t['ubar1']),
        'reflected_toon_props': tuple(
            getattr(tp, f) for f in cuda_toon.REFLECTED_FIELDS) + geom,
        'thermal_toon_props': (t['all_b'], tp.dtau_og, tp.w0_no_raman,
                               tp.cosb_og, tp.dtau_og[0] * 0.7, t['surf'],
                               t['ubar1']),
    }[name]


@pytest.mark.parametrize('name', ['reflected_toon', 'thermal_toon',
                                  'reflected_toon_props',
                                  'thermal_toon_props'])
def test_wrapper_takes_the_twin_on_cpu(inputs, name):
    """On CPU tensors each new wrapper runs its twin and launches nothing,
    multi_phase=2 (isotropic) included; the reflected ones reject an
    unknown multi_phase before any work."""
    wrapper = getattr(cuda_toon, name)
    twin = getattr(cuda_toon, f'{name}_plain')
    args = _wrapper_args(inputs, name)
    before = wrapper.launches
    assert torch.equal(wrapper(*args), twin(*args))
    assert wrapper.launches == before
    if name.startswith('reflected'):
        iso = dict(controls=ttoon.ScatteringControls(multi_phase=2))
        assert torch.equal(wrapper(*args, **iso), twin(*args, **iso))
        with pytest.raises(ValueError, match='multi_phase'):
            wrapper(*args, controls=ttoon.ScatteringControls(multi_phase=3))
