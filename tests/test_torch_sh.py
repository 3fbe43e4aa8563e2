"""The port's SH solver (rt/sh.py) and the SH kernels' twins (rt/cuda_sh.py)
against the JAX package.

Same inputs (numpy, from a seed) go through the JAX functions in float64
and through picaso_tpu_torch on the CPU in float64:
- block_tridiag_solve, _sh2_system/_sh4_system and _solve_sh under both
  groupings against their picaso_tpu.rt.sh namesakes, rtol 1e-10;
- reflected_sh/thermal_sh at stream 2 and 4 against picaso_tpu.rt.sh,
  rtol 1e-10, over the phase-function forms and the surface option;
- each kernel twin against its Pallas kernel run with interpret=True (as
  tests/test_pallas_sh.py runs it), rtol 1e-8 (same arithmetic; the
  triangular-matmul cumsum of the Pallas kernel against torch.cumsum), one
  float32 case at test_pallas_sh.py's tolerance (rtol 2e-4, atol 2e-5 of
  the largest value) and one case with 12 disk angles (the sweep-scratch
  regression of test_pallas_sh.py).
Each JAX output is computed once per module (interpret-mode calls take
seconds each here).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from picaso_tpu.optics import combine_optics as j_combine_optics
from picaso_tpu.rt import pallas_sh as jpallas
from picaso_tpu.rt import sh as jsh
from picaso_tpu.rt import toon as jtoon

from picaso_tpu_torch import optics as t_optics
from picaso_tpu_torch.rt import cuda_sh
from picaso_tpu_torch.rt import sh as tsh
from picaso_tpu_torch.rt import toon as ttoon

torch.set_num_threads(1)

NLAYER, NWNO, NANG = 30, 256, 5
_STRIPS = ('taugas', 'tauray', 'copd', 'cw0', 'cg0', 'rf')


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
             plevel=np.logspace(-4, 2, NLAYER + 1) * 1e6,
             wno=np.linspace(300.0, 20000.0, NWNO))
    # thin layers at the top, as a real profile has them
    d['taugas'][:4] *= 1e-4
    d['all_b'] = np.array(jtoon.blackbody(jnp.asarray(d['tlevel']),
                                            1.0 / jnp.asarray(d['wno'])))
    d['ptfac'] = d['plevel'][0] / (d['plevel'][1] - d['plevel'][0])
    return d


def _props(d, stream, lib):
    if lib == 'jax':
        return j_combine_optics(*[jnp.asarray(d[k]) for k in _STRIPS],
                                stream=stream)
    return t_optics.combine_optics(*[torch.as_tensor(d[k]) for k in _STRIPS],
                                   stream=stream)


def _close(got, want, rtol, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# (a) the block solver and the SH systems
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('nr', [None, 3])
@pytest.mark.parametrize('s', [2, 4])
def test_block_tridiag_solve_matches_jax(s, nr):
    rng = np.random.default_rng(s * 10 + (nr or 0))
    n, nw = 12, 17
    A = rng.normal(size=(n, s, s, nw))
    B = rng.normal(size=(n, s, s, nw)) + 4.0 * np.eye(s)[None, :, :, None]
    C = rng.normal(size=(n, s, s, nw))
    D = rng.normal(size=(n, s, nw) if nr is None else (n, s, nr, nw))
    want = jsh.block_tridiag_solve(*map(jnp.asarray, (A, B, C, D)))
    got = tsh.block_tridiag_solve(*map(torch.as_tensor, (A, B, C, D)))
    assert got.shape == D.shape
    _close(got, want, 1e-10)


def _system_inputs(d, s, calculation):
    """Coefficient inputs of _sh{2,4}_system from the seeded scene."""
    rng = np.random.default_rng(7 + s)
    n = NLAYER
    w0 = rng.uniform(0.05, 0.95, (n, NWNO))
    dtau = d['taugas'] + d['tauray']
    tau = np.concatenate([np.zeros((1, NWNO)), np.cumsum(dtau, 0)])
    wl = [np.ones((n, NWNO))] + [rng.uniform(0.0, 2.0, (n, NWNO))
                                 for _ in range(s - 1)]
    a = np.stack([(2 * l + 1) - w0 * wl[l] for l in range(s)])
    nr = NANG if calculation == 0 else 1
    b = rng.uniform(0.0, 0.1, (s, nr, n, NWNO))
    if calculation == 0:
        b_surface = rng.uniform(0.0, 0.05, (nr, NWNO))
        b_top = 0.0
    else:
        b_surface = rng.uniform(1.0, 2.0, NWNO)
        b_top = rng.uniform(0.0, 0.5, NWNO)
    b0 = d['all_b'][:-1]
    b1 = (d['all_b'][1:] - b0) / dtau
    return dict(w0=w0, dtau=dtau, tau=tau, a=a, b=b, b_top=b_top,
                b_surface=b_surface, b_surface_sh4=-b_surface / 4,
                surf_reflect=d['surf'], ubar0=d['ubar0'][:, 0], b0=b0, b1=b1)


def _system(lib, s, calculation, x):
    conv = jnp.asarray if lib is jsh else torch.as_tensor
    v = {k: conv(val) if isinstance(val, np.ndarray) else val
         for k, val in x.items()}
    if calculation == 1:
        v['ubar0'] = conv(np.ones(1))
    args = (v['w0'], v['dtau'], v['tau'], v['a'], v['b'], v['b_top'],
            v['b_surface'])
    tail = (v['surf_reflect'], v['ubar0'], calculation)
    kw = dict(b0=v['b0'], b1=v['b1']) if calculation == 1 else {}
    if s == 2:
        return lib._sh2_system(*args, *tail, **kw)
    return lib._sh4_system(*args, v['b_surface_sh4'], *tail, **kw)


@pytest.mark.parametrize('calculation', [0, 1])
@pytest.mark.parametrize('s', [2, 4])
def test_sh_system_and_solve_match_jax(inputs, s, calculation):
    x = _system_inputs(inputs, s, calculation)
    want = _system(jsh, s, calculation, x)
    got = _system(tsh, s, calculation, x)
    for g, w in zip(got[:6], want[:6]):     # T, Fm, z_down, z_up, b vectors
        assert tuple(g.shape) == w.shape
        _close(g, w, 1e-10)
    # the solve from the same (JAX-built) system, so only its own
    # arithmetic is compared
    system = [torch.as_tensor(np.array(w)) for w in want[:6]]
    for grouping in ('classic', 'incoming'):
        X = tsh._solve_sh(*system, torch.as_tensor(inputs['surf']), s,
                          grouping=grouping)
        jX = jsh._solve_sh(*want[:6], jnp.asarray(inputs['surf']), s,
                           grouping=grouping)
        _close(X, jX, 1e-10, atol=1e-12 * float(np.abs(jX).max()))


# ---------------------------------------------------------------------------
# (b) the plain SH path
# ---------------------------------------------------------------------------

_FORMS = [dict(w_multi_form=0, psingle_form=0, single_form=0),
          dict(w_multi_form=1, psingle_form=1, single_form=0),
          dict(w_multi_form=0, psingle_form=1, single_form=1)]


@pytest.mark.parametrize('form', range(len(_FORMS)))
@pytest.mark.parametrize('stream', [2, 4])
def test_reflected_sh_matches_jax(inputs, stream, form):
    d = inputs
    kw = dict(stream=stream, **_FORMS[form])
    want = jsh.reflected_sh(_props(d, stream, 'jax'), jnp.asarray(d['surf']),
                            jnp.asarray(d['ubar0']), jnp.asarray(d['ubar1']),
                            0.5, jnp.asarray(d['F0PI']), **kw)
    got = tsh.reflected_sh(_props(d, stream, 'torch'),
                           torch.as_tensor(d['surf']),
                           torch.as_tensor(d['ubar0']),
                           torch.as_tensor(d['ubar1']), 0.5,
                           torch.as_tensor(d['F0PI']), **kw)
    assert got.shape == (NANG, 1, NWNO) and got.dtype == torch.float64
    _close(got, want, 1e-10)


@pytest.mark.parametrize('hard_surface', [False, True])
@pytest.mark.parametrize('stream', [2, 4])
def test_thermal_sh_matches_jax(inputs, stream, hard_surface):
    d = inputs
    kw = dict(stream=stream, hard_surface=hard_surface)
    want, _ = jsh.thermal_sh(jnp.asarray(d['tlevel']),
                             _props(d, stream, 'jax'),
                             jnp.asarray(d['plevel']),
                             jnp.asarray(d['ubar1']), jnp.asarray(d['surf']),
                             jnp.asarray(d['wno']), **kw)
    got = tsh.thermal_sh(*[torch.as_tensor(d[k]) for k in ('tlevel',)],
                         _props(d, stream, 'torch'),
                         torch.as_tensor(d['plevel']),
                         torch.as_tensor(d['ubar1']),
                         torch.as_tensor(d['surf']),
                         torch.as_tensor(d['wno']), **kw)
    assert got.shape == (NANG, 1, NWNO) and got.dtype == torch.float64
    _close(got, want, 1e-10)


def test_precision_f32_casts_and_restores(inputs):
    """precision='f32' runs the incoming grouping in float32 and hands back
    float64; it stays within the f32 tolerance of the f64 answer."""
    d = inputs
    props = _props(d, 4, 'torch')
    args = (props, torch.as_tensor(d['surf']), torch.as_tensor(d['ubar0']),
            torch.as_tensor(d['ubar1']), 0.5, torch.as_tensor(d['F0PI']))
    ref = tsh.reflected_sh(*args, stream=4)
    out = tsh.reflected_sh(*args, stream=4, precision='f32')
    assert out.dtype == torch.float64
    _close(out, ref.numpy(), 2e-4, atol=2e-5 * ref.abs().max().item())
    with pytest.raises(ValueError):
        tsh.reflected_sh(*args, stream=4, precision='f16')


# ---------------------------------------------------------------------------
# (c) the kernels' twins against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

def _kernel_args(d, kind, conv, ubar0=None, ubar1=None, cos_theta=0.5):
    ub0 = d['ubar0'] if ubar0 is None else ubar0
    ub1 = d['ubar1'] if ubar1 is None else ubar1
    strips = [conv(d[k]) for k in _STRIPS]
    if kind == 'reflected':
        return strips + [conv(d['surf']), conv(ub0), conv(ub1), cos_theta,
                         conv(d['F0PI'])]
    return ([conv(d['all_b'])] + strips
            + [d['ptfac'], conv(d['surf']), conv(ub1)])


_PALLAS = {}


def _pallas(d, kind, stream, key='f64', dtype=np.float64, **geom):
    """Each interpret-mode Pallas output once per module."""
    name = (kind, stream, key)
    if name not in _PALLAS:
        fn = getattr(jpallas, f'{kind}_sh{stream}_pallas')
        cast = {k: v.astype(dtype) if isinstance(v, np.ndarray) else v
                for k, v in d.items()}
        geom = {k: v.astype(dtype) for k, v in geom.items()}
        _PALLAS[name] = np.asarray(fn(
            *_kernel_args(cast, kind, jnp.asarray, **geom), block_w=128,
            interpret=True))
    return _PALLAS[name]


def _twin(d, kind, stream, dtype=torch.float64, **geom):
    fn = getattr(cuda_sh, f'{kind}_sh{stream}_plain')
    return fn(*_kernel_args(d, kind, lambda x: torch.as_tensor(x, dtype=dtype),
                            **geom))


@pytest.mark.parametrize('kind', ['reflected', 'thermal'])
@pytest.mark.parametrize('stream', [2, 4])
def test_twin_matches_pallas_f64(inputs, kind, stream):
    want = _pallas(inputs, kind, stream)
    got = _twin(inputs, kind, stream)
    assert got.shape == want.shape == (NANG, 1, NWNO)
    _close(got, want, 1e-8, atol=1e-14 * float(np.abs(want).max()))


def test_twin_matches_pallas_f32(inputs):
    want = _pallas(inputs, 'reflected', 2, key='f32', dtype=np.float32)
    got = _twin(inputs, 'reflected', 2, dtype=torch.float32)
    assert got.dtype == torch.float32
    scale = float(np.abs(want).max())
    _close(got, want, 2e-4, atol=2e-5 * scale)


def _many_angles():
    """nang = 12 > 8: a 4 x 3 disco-ball geometry."""
    rng = np.random.default_rng(5)
    return dict(ubar0=rng.uniform(0.05, 1.0, (4, 3)),
                ubar1=rng.uniform(0.05, 1.0, (4, 3)))


def test_twin_many_angles(inputs):
    """The sweep-scratch regression of test_pallas_sh.py (nang > 8) on the
    SH2 twin (an interpret-mode SH4 call with 12 angles takes ~25 s here;
    the SH4 twin's 12 angles are held against the plain path below)."""
    geom = _many_angles()
    want = _pallas(inputs, 'reflected', 2, key='nang12', **geom)
    got = _twin(inputs, 'reflected', 2, **geom)
    assert got.shape == want.shape == (4, 3, NWNO)
    _close(got, want, 1e-8, atol=1e-14 * float(np.abs(want).max()))


def test_twin_many_angles_sh4(inputs):
    d = inputs
    geom = {k: torch.as_tensor(v) for k, v in _many_angles().items()}
    t = {k: torch.as_tensor(v) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    props = t_optics.combine_optics(*[t[k] for k in _STRIPS], stream=4)
    ref = tsh.reflected_sh(props, t['surf'], geom['ubar0'], geom['ubar1'],
                           0.5, t['F0PI'], stream=4)
    got = _twin(d, 'reflected', 4, **_many_angles())
    assert got.shape == ref.shape == (4, 3, NWNO)
    _close(got, ref.numpy(), 1e-6)


# options the Pallas comparison does not reach, against the port's own
# plain SH path (classic grouping, true expm1): the twin's Taylor expm1
# and the incoming grouping differ from it by rounding only
_TWIN_CASES = [
    dict(),
    dict(delta_eddington=False, b_top=0.2),
    dict(w_single_form=1, w_multi_form=1, psingle_form=1),
    dict(psingle_rayleigh=0, w_multi_rayleigh=0, single_form=1),
    dict(controls=ttoon.ScatteringControls(frac_a=0.8, constant_back=-0.4,
                                           constant_forward=0.9)),
]


@pytest.mark.parametrize('case', range(len(_TWIN_CASES)))
@pytest.mark.parametrize('stream', [2, 4])
def test_reflected_twin_matches_plain_path(inputs, stream, case):
    d = inputs
    kw = dict(_TWIN_CASES[case])
    dedd = kw.pop('delta_eddington', True)
    b_top = kw.pop('b_top', 0.0)
    t = {k: torch.as_tensor(v) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    props = t_optics.combine_optics(*[t[k] for k in _STRIPS], stream=stream,
                                    delta_eddington=dedd)
    ref = tsh.reflected_sh(props, t['surf'], t['ubar0'], t['ubar1'], 0.5,
                           t['F0PI'], stream=stream, b_top=b_top, **kw)
    got = getattr(cuda_sh, f'reflected_sh{stream}_plain')(
        *_kernel_args(d, 'reflected', torch.as_tensor),
        delta_eddington=dedd, b_top=b_top, **kw)
    _close(got, ref.numpy(), 1e-6)


@pytest.mark.parametrize('hard_surface', [False, True])
@pytest.mark.parametrize('delta_eddington', [True, False])
@pytest.mark.parametrize('stream', [2, 4])
def test_thermal_twin_matches_plain_path(inputs, stream, delta_eddington,
                                         hard_surface):
    d = inputs
    t = {k: torch.as_tensor(v) for k, v in d.items()
         if isinstance(v, np.ndarray)}
    props = t_optics.combine_optics(*[t[k] for k in _STRIPS], stream=stream,
                                    delta_eddington=delta_eddington)
    ref = tsh.thermal_sh(t['tlevel'], props, t['plevel'], t['ubar1'],
                         t['surf'], t['wno'], stream=stream,
                         hard_surface=hard_surface)
    got = getattr(cuda_sh, f'thermal_sh{stream}_plain')(
        *_kernel_args(d, 'thermal', torch.as_tensor),
        delta_eddington=delta_eddington, hard_surface=hard_surface)
    _close(got, ref.numpy(), 1e-6)


def test_wrappers_take_the_twin_on_cpu(inputs):
    """On CPU tensors each wrapper runs its twin and launches nothing;
    options the kernels do not take raise before any work."""
    for kind in ('reflected', 'thermal'):
        args = _kernel_args(inputs, kind, torch.as_tensor)
        for stream in (2, 4):
            wrapper = getattr(cuda_sh, f'{kind}_sh{stream}')
            twin = getattr(cuda_sh, f'{kind}_sh{stream}_plain')
            before = wrapper.launches
            assert torch.equal(wrapper(*args), twin(*args))
            assert wrapper.launches == before
    args = _kernel_args(inputs, 'reflected', torch.as_tensor)
    with pytest.raises(ValueError):
        cuda_sh.reflected_sh4(*args, w_multi_form=3)
    with pytest.raises(ValueError):
        cuda_sh.reflected_sh2(*args, single_form=2)
