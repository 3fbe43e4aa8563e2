"""The port's Toon spectrum twin and plain RT path against the JAX package.

Same inputs (numpy, from a seed) go through the JAX functions in float64
and through picaso_tpu_torch on the CPU in float64:
- spectrum_toon_plain (the twin of csrc/toon_spectrum.cu) against
  spectrum_pallas_fused in interpret mode: same arithmetic, rtol 1e-8;
- the same against combine_optics + reflected_1d/thermal_1d (the JAX scan
  path): rtol 2e-5, the tolerance tests/test_pallas_toon.py uses for the
  kernel-vs-scan comparison;
- the port's own combine_optics + reflected_1d/thermal_1d against the JAX
  scan path: same arithmetic, rtol 1e-10.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu.optics import combine_optics as j_combine_optics
from picaso_tpu.rt import toon as jtoon
from picaso_tpu.rt.pallas_toon import spectrum_pallas_fused

from picaso_tpu_torch import optics as t_optics
from picaso_tpu_torch.rt import toon as ttoon
from picaso_tpu_torch.rt.cuda_toon import spectrum_toon, spectrum_toon_plain

torch.set_num_threads(1)

NLAYER, NWNO, NANG = 20, 300, 3


@pytest.fixture(scope='module')
def inputs():
    rng = np.random.default_rng(11)
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
             plevel=np.logspace(-4, 2, NLAYER + 1) * 1e6,
             wno=np.linspace(300.0, 20000.0, NWNO))
    d['all_b'] = np.array(jtoon.blackbody(jnp.asarray(d['tlevel']),
                                            1.0 / jnp.asarray(d['wno'])))
    d['ptfac'] = d['plevel'][0] / (d['plevel'][1] - d['plevel'][0])
    return d


_SOURCES = ('all_b', 'taugas', 'tauray', 'copd', 'cw0', 'cg0', 'rf')
_TAIL = ('ptfac', 'surf', 'ubar0', 'ubar1')


def _args(d, conv):
    return ([conv(d[k]) for k in _SOURCES] + [conv(d[k]) for k in _TAIL]
            + [0.5, conv(d['F0PI'])])


def _jax_scan(d, controls, delta_eddington, hard_surface):
    j = {k: jnp.asarray(v) for k, v in d.items()}
    props = j_combine_optics(j['taugas'], j['tauray'], j['copd'], j['cw0'],
                             j['cg0'], j['rf'],
                             delta_eddington=delta_eddington, stream=2)
    xint, _ = jtoon.reflected_1d(
        props.dtau, props.tau, props.w0, props.cosb, props.gcos2,
        props.ftau_cld, props.ftau_ray, props.dtau_og, props.tau_og,
        props.w0_og, props.cosb_og, j['surf'], j['ubar0'], j['ubar1'], 0.5,
        j['F0PI'], controls)
    therm, _ = jtoon.thermal_1d(j['tlevel'], props.dtau_og,
                                props.w0_no_raman, props.cosb_og,
                                j['plevel'], j['ubar1'], j['surf'],
                                j['wno'], dwno=jnp.zeros(NWNO),
                                hard_surface=hard_surface, calc_type=0)
    return np.asarray(xint), np.asarray(therm)


@pytest.mark.parametrize('delta_eddington', [True, False])
@pytest.mark.parametrize('hard_surface', [False, True])
@pytest.mark.parametrize('single_phase', [0, 3])
def test_spectrum_twin_matches_pallas_and_scan(inputs, single_phase,
                                               hard_surface, delta_eddington):
    d = inputs
    kw = dict(stream=2, delta_eddington=delta_eddington,
              hard_surface=hard_surface)
    jc = jtoon.ScatteringControls(single_phase=single_phase)
    tc = ttoon.ScatteringControls(single_phase=single_phase)

    j_xint, j_therm = spectrum_pallas_fused(
        *_args(d, jnp.asarray), controls=jc, block_w=256, interpret=True,
        **kw)
    t_xint, t_therm = spectrum_toon_plain(*_args(d, torch.as_tensor),
                                          controls=tc, **kw)
    assert t_xint.shape == (NANG, 1, NWNO) and t_xint.dtype == torch.float64
    np.testing.assert_allclose(t_xint.numpy(), np.asarray(j_xint),
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(t_therm.numpy(), np.asarray(j_therm),
                               rtol=1e-8, atol=1e-12)

    s_xint, s_therm = _jax_scan(d, jc, delta_eddington, hard_surface)
    np.testing.assert_allclose(t_xint.numpy(), s_xint, rtol=2e-5, atol=1e-8)
    np.testing.assert_allclose(t_therm.numpy(), s_therm, rtol=2e-5,
                               atol=1e-8)


@pytest.mark.parametrize('delta_eddington', [True, False])
@pytest.mark.parametrize('hard_surface', [False, True])
def test_plain_rt_path_matches_jax_scan(inputs, hard_surface,
                                        delta_eddington):
    d = inputs
    c = ttoon.ScatteringControls()
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    props = t_optics.combine_optics(t['taugas'], t['tauray'], t['copd'],
                                    t['cw0'], t['cg0'], t['rf'],
                                    delta_eddington=delta_eddington)
    xint = ttoon.reflected_1d(
        props.dtau, props.tau, props.w0, props.cosb, props.gcos2,
        props.ftau_cld, props.ftau_ray, props.dtau_og, props.tau_og,
        props.w0_og, props.cosb_og, t['surf'], t['ubar0'], t['ubar1'], 0.5,
        t['F0PI'], c)
    therm = ttoon.thermal_1d(t['tlevel'], props.dtau_og, props.w0_no_raman,
                             props.cosb_og, t['plevel'], t['ubar1'],
                             t['surf'], t['wno'], hard_surface=hard_surface)
    s_xint, s_therm = _jax_scan(d, jtoon.ScatteringControls(),
                                delta_eddington, hard_surface)
    np.testing.assert_allclose(xint.numpy(), s_xint, rtol=1e-10)
    np.testing.assert_allclose(therm.numpy(), s_therm, rtol=1e-10)


def test_wrapper_takes_the_twin_on_cpu(inputs):
    """On CPU tensors the public wrapper runs the twin and launches
    nothing; an unknown multi_phase raises before any work."""
    args = _args(inputs, torch.as_tensor)
    before = spectrum_toon.launches
    out = spectrum_toon(*args)
    ref = spectrum_toon_plain(*args)
    assert spectrum_toon.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match='multi_phase'):
        spectrum_toon(*args, controls=ttoon.ScatteringControls(
            multi_phase=3))
