"""The port's CUDA kernels against their plain twins, on the card.

Skipped without a CUDA device (the decision is made inside the fixture, so
every test worker collects the same tests).  Run on a GPU machine with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(--noconftest: tests/conftest.py imports jax, which a GPU machine for the
port need not have).

Tolerances, float32 on both sides with the same arithmetic order (the
kernels are built with -fmad=false): the gathers (K1, K8, the gather
probe's layer-inner kernel; K1 and K8 on a random-temperature, a
scattered and a clamped profile) and the sweep probe's two layouts to rtol
1e-5; the Toon (K2-K6) and SH spectrum kernels to max rel 1e-3 and median
rel 1e-5 (the recursions amplify the few-ulp differences of expf/cumsum
between the two).  The int16 forward is held against the float plain path
within the JAX package's int16 gate (max rel 5e-3, median 4e-3,
scripts/tpu_parity.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from picaso_tpu_torch import pipeline
from picaso_tpu_torch.opacities.cuda_interp import (interp_tau,
                                                    interp_tau_plain,
                                                    interp_tau_q,
                                                    interp_tau_q_plain,
                                                    quantize_table)
from picaso_tpu_torch.opacities.db import _find_indices
from picaso_tpu_torch.opacities.factory import synthetic_opacity_grid
from picaso_tpu_torch.optics import combine_optics
from picaso_tpu_torch.probes import (gather_ab, gather_probe,
                                     sweep_layout_probe)
from picaso_tpu_torch.rt import cuda_sh, cuda_toon
from picaso_tpu_torch.rt.cuda_toon import spectrum_toon, spectrum_toon_plain
from picaso_tpu_torch.rt.toon import ScatteringControls, blackbody

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('no CUDA device')
    return torch.device('cuda')


def _rel(a, b):
    a, b = a.double(), b.double()
    scale = torch.clamp(b.abs(), min=b.abs().max().item() * 1e-9 + 1e-300)
    return (a - b).abs() / scale


def _gather_inputs(dev, nwno, nlayer=12, seed=3, profile='random T'):
    """The gather's arguments on a 16 x 10 (T, P) grid of 3 molecules.
    Profiles: 'random T' (random temperatures, log-spaced pressures);
    'scattered' (every layer of a chunk reads 4 rows no other layer of it
    reads: the most distinct rows a chunk can need, for which the kernels
    size their shared memory); 'clamped' (beyond the grid's edges, some
    layers with one row in all four corners or two corners on one row)."""
    wno = np.linspace(1000.0, 15000.0, nwno)
    grid = synthetic_opacity_grid(wno, molecules=('H2O', 'CH4', 'CO'),
                                  ntemp=16, npress=10, dtype=torch.float32,
                                  device=dev)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    if profile == 'scattered':
        t, p = gather_ab.scattered_layers(grid.pt, nlayer, seed)
    elif profile == 'clamped':
        t = np.where(np.arange(nlayer) % 2 == 0, 70.0, 3450.0)
        p = np.where(np.arange(nlayer) % 3 == 0, 5e-7, 2e3)
    else:
        t, p = rng.uniform(200.0, 2400.0, nlayer), np.logspace(-5, 2, nlayer)
    mixcol = torch.tensor(rng.uniform(1e-6, 1e-3, (3, nlayer))
                          * rng.uniform(1.0, 100.0, nlayer), **f32)
    t_w, p_w, idx = _find_indices(grid.pt, torch.tensor(t, **f32),
                                  torch.tensor(p, **f32))
    if profile == 'clamped':
        idx[:, 1::4] = idx[0, 1::4].clone()
        idx[2, 2::4] = idx[1, 2::4].clone()
    return grid.log_kappa, idx, t_w, p_w, mixcol


_GATHER_PROFILES = ['random T', 'scattered', 'clamped']


@pytest.mark.parametrize('profile', _GATHER_PROFILES)
@pytest.mark.parametrize('nlayer', [12, 17])
@pytest.mark.parametrize('nwno', [256, 700, 37])
def test_interp_kernel_matches_twin(dev, nwno, nlayer, profile):
    args = _gather_inputs(dev, nwno, nlayer, profile=profile)
    before = interp_tau.launches
    out = interp_tau(*args)
    torch.cuda.synchronize()
    assert interp_tau.launches == before + 1
    ref = interp_tau_plain(*args)
    assert out.shape == ref.shape == (nlayer, nwno)
    assert torch.isfinite(out).all()
    assert _rel(out, ref).max().item() <= 1e-5


def test_interp_wrapper_rejects_bad_inputs(dev):
    log_kappa, idx, t_w, p_w, mixcol = _gather_inputs(dev, 300)
    with pytest.raises(TypeError):
        interp_tau(log_kappa.double(), idx, t_w, p_w, mixcol)
    with pytest.raises(ValueError):
        interp_tau(log_kappa.transpose(1, 2), idx, t_w, p_w, mixcol)
    with pytest.raises(ValueError):
        interp_tau(log_kappa, idx, t_w, p_w, mixcol.cpu())


def _toon_inputs(dev, nwno, nlayer=20, nang=3, seed=11):
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    shape = (nlayer, nwno)

    def t(x):
        return torch.tensor(x, **f32)

    tlevel = np.linspace(400.0, 1600.0, nlayer + 1)
    wno = np.linspace(300.0, 20000.0, nwno)
    all_b = blackbody(t(tlevel), 1.0 / t(wno))
    return [all_b, t(rng.uniform(1e-4, 1.5, shape)),
            t(rng.uniform(1e-5, 0.3, shape)), t(rng.uniform(0.0, 1.0, shape)),
            t(rng.uniform(0.3, 0.99, shape)), t(rng.uniform(0.0, 0.9, shape)),
            t(rng.uniform(0.9, 0.99999, shape)), t(0.7),
            t(np.full(nwno, 0.1)), t(rng.uniform(0.1, 1.0, (nang, 1))),
            t(rng.uniform(0.1, 1.0, (nang, 1))), t(0.5),
            t(rng.uniform(0.5, 1.5, nwno))]


_CASES = [
    dict(),
    dict(hard_surface=True, delta_eddington=False),
    dict(controls=ScatteringControls(single_phase=0, toon_coefficients=1)),
    dict(controls=ScatteringControls(single_phase=1, multi_phase=1)),
    dict(controls=ScatteringControls(single_phase=2, frac_c=1.5)),
    dict(controls=ScatteringControls(multi_phase=2)),
]


# disk angles of the two-stage reflected kernels: 9 and 36 cross stage B's
# 8-angle chunks; nwno 300 and 1000 are not multiples of its 32 columns
_NANGS = [3, 1, 5, 8, 9, 36]


@pytest.mark.parametrize('nang', _NANGS)
@pytest.mark.parametrize('nwno', [300, 1000])
@pytest.mark.parametrize('case', range(len(_CASES)))
def test_toon_kernel_matches_twin(dev, nwno, case, nang):
    args = _toon_inputs(dev, nwno, nang=nang)
    kw = _CASES[case]
    before = spectrum_toon.launches
    xint, therm = spectrum_toon(*args, **kw)
    torch.cuda.synchronize()
    assert spectrum_toon.launches == before + 1
    r_xint, r_therm = spectrum_toon_plain(*args, **kw)
    for out, ref in ((xint, r_xint), (therm, r_therm)):
        assert out.shape == ref.shape == (nang, 1, nwno)
        assert torch.isfinite(out).all()
        rel = _rel(out, ref)
        assert rel.max().item() <= 1e-3
        assert rel.median().item() <= 1e-5


def test_toon_wrapper_rejects_bad_inputs(dev):
    args = _toon_inputs(dev, 300)
    bad = list(args)
    bad[1] = args[1].double()
    with pytest.raises(TypeError):
        spectrum_toon(*bad)
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError):
        spectrum_toon(*bad)
    bad = list(args)
    bad[3] = args[3].cpu()
    with pytest.raises(ValueError):
        spectrum_toon(*bad)


def test_forward_kernels_match_plain_path(dev):
    scene, grid, config = pipeline.build_problem(2000, production=False,
                                                 device=dev)
    before = (interp_tau.launches, spectrum_toon.launches)
    out = pipeline.forward(scene, grid, config)
    torch.cuda.synchronize()
    assert (interp_tau.launches, spectrum_toon.launches) == (
        before[0] + 1, before[1] + 1)
    ref = pipeline.forward(scene, grid,
                           dataclasses.replace(config, use_kernels=False))
    for key in ('albedo', 'thermal', 'transit_depth'):
        assert torch.isfinite(out[key]).all()
        rel = _rel(out[key], ref[key])
        assert rel.max().item() <= 5e-3 and rel.median().item() <= 2e-4, key


def _sh_inputs(dev, kind, nwno, nang, nlayer=30, seed=17):
    """Arguments of the SH kernels: ragged nwno, nang angles as [nang, 1]
    (or a 4 x 3 grid for 12)."""
    args = _toon_inputs(dev, nwno, nlayer=nlayer, nang=nang, seed=seed)
    (all_b, tg, tr, copd, cw0, cg0, rf, ptfac, surf, u0, u1, ct, f0pi) = args
    if nang == 12:
        u0, u1 = u0.reshape(4, 3), u1.reshape(4, 3)
    strips = [tg, tr, copd, cw0, cg0, rf]
    if kind == 'reflected':
        return strips + [surf, u0, u1, ct, f0pi]
    return [all_b] + strips + [ptfac, surf, u1]


# every branch of the reflected stage B: w_multi_form, psingle_form and
# w_single_form 0/1/2, single_form 0/1, the Rayleigh switches off
_SH_CASES = {
    'reflected': [dict(), dict(delta_eddington=False, b_top=0.1),
                  dict(w_multi_form=1, psingle_form=1, single_form=1),
                  dict(controls=ScatteringControls(frac_c=1.5)),
                  dict(w_multi_form=2, psingle_form=2, w_single_form=1),
                  dict(w_single_form=2, single_form=1, w_single_rayleigh=0,
                       w_multi_rayleigh=0, psingle_rayleigh=0)],
    'thermal': [dict(), dict(hard_surface=True, delta_eddington=False)],
}


# disk angles: 9 and 36 cross the reflected stage B's 8-angle chunks; nwno
# 300 and 1000 are not multiples of its 32 columns
@pytest.mark.parametrize('nang', [1, 5, 12, 8, 9, 36])
@pytest.mark.parametrize('nwno', [300, 1000])
@pytest.mark.parametrize('stream', [2, 4])
@pytest.mark.parametrize('kind', ['reflected', 'thermal'])
def test_sh_kernels_match_twins(dev, kind, stream, nwno, nang):
    wrapper = getattr(cuda_sh, f'{kind}_sh{stream}')
    twin = getattr(cuda_sh, f'{kind}_sh{stream}_plain')
    args = _sh_inputs(dev, kind, nwno, nang)
    for kw in _SH_CASES[kind]:
        before = wrapper.launches
        out = wrapper(*args, **kw)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = twin(*args, **kw)
        assert out.shape == ref.shape and out.shape[-1] == nwno
        assert out.shape[0] * out.shape[1] == nang
        assert torch.isfinite(out).all(), kw
        rel = _rel(out, ref)
        assert rel.max().item() <= 1e-3, kw
        assert rel.median().item() <= 1e-5, kw


@pytest.mark.parametrize('kind', ['reflected', 'thermal'])
def test_sh_wrappers_reject_bad_inputs(dev, kind):
    wrapper = getattr(cuda_sh, f'{kind}_sh4')
    args = _sh_inputs(dev, kind, 300, 5)
    i = 1 if kind == 'reflected' else 2
    bad = list(args)
    bad[i] = args[i].double()
    with pytest.raises(TypeError):
        wrapper(*bad)
    bad = list(args)
    bad[i] = args[i].t().contiguous().t()
    with pytest.raises(ValueError):
        wrapper(*bad)
    bad = list(args)
    bad[i] = args[i].cpu()
    with pytest.raises(ValueError):
        wrapper(*bad)
    bad = list(args)
    bad[i] = args[i][:, :200].contiguous()
    with pytest.raises(ValueError):
        wrapper(*bad)
    if kind == 'reflected':
        with pytest.raises(ValueError):
            wrapper(*args, single_form=3)


@pytest.mark.parametrize('kind', ['reflected', 'thermal'])
@pytest.mark.parametrize('nang', [5, 36])
@pytest.mark.parametrize('stream', [2, 4])
def test_sh_reflected_split_event_keeps_outputs(dev, stream, nang, kind):
    """The two stages (reflected or thermal) with an event recorded between
    them give the same bits as without, and the event splits the time."""
    wrapper = getattr(cuda_sh, f'{kind}_sh{stream}')
    args = _sh_inputs(dev, kind, 1000, nang)
    out = wrapper(*args)
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    start.record()
    split = wrapper(*args, split_event=mid)
    end.record()
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.equal(out, split)
    assert start.elapsed_time(mid) > 0 and mid.elapsed_time(end) > 0


def test_sh_failed_launch_raises(dev, monkeypatch):
    """An entry that refuses its arguments returns a nonzero code, which
    `check` raises on; the wrapper raises when either stage fails, names
    the stage and does not count the call (reflected and thermal)."""
    from picaso_tpu_torch._build import check, library
    lib = library()
    null = [None] * 13
    flags = [0] * 11
    floats = [0.0] * 8
    for stream, stage in ((3, 0), (4, 2), (2, 5)):
        code = lib.sh_reflected_launch(stream, *null, 91, 300, 5, *flags[3:],
                                       *floats, stage, None)
        assert code != 0
        with pytest.raises(RuntimeError):
            check(code, 'sh_reflected_launch')
        code = lib.sh_thermal_launch(stream, *null[:12], 91, 300, 5, 1, 0,
                                     stage, None)
        assert code != 0
        with pytest.raises(RuntimeError):
            check(code, 'sh_thermal_launch')
    assert lib.sh_reflected_scratch_slots(3, 5) < 0
    assert lib.sh_thermal_scratch_slots(3) < 0
    for kind in ('reflected', 'thermal'):
        entry = getattr(lib, f'sh_{kind}_launch')
        wrapper = getattr(cuda_sh, f'{kind}_sh4')
        args = _sh_inputs(dev, kind, 300, 5)
        for bad_stage in (0, 1):
            def refuse(*a, bad_stage=bad_stage, entry=entry):
                return 1 if a[-2] == bad_stage else entry(*a)
            monkeypatch.setattr(lib, f'sh_{kind}_launch', refuse)
            before = wrapper.launches
            with pytest.raises(RuntimeError, match='stage ' + 'AB'[bad_stage]):
                wrapper(*args)
            assert wrapper.launches == before
        monkeypatch.setattr(lib, f'sh_{kind}_launch', entry)


@pytest.mark.parametrize('stream', [2, 4])
def test_sh_forward_kernels_match_plain_path(dev, stream):
    scene, grid, config = pipeline.build_problem(2000, production=False,
                                                 device=dev)
    config = dataclasses.replace(config, rt_method=1, stream=stream)
    r = getattr(cuda_sh, f'reflected_sh{stream}')
    t = getattr(cuda_sh, f'thermal_sh{stream}')
    before = (r.launches, t.launches, spectrum_toon.launches)
    out = pipeline.forward(scene, grid, config)
    torch.cuda.synchronize()
    assert (r.launches, t.launches, spectrum_toon.launches) == (
        before[0] + 1, before[1] + 1, before[2])
    ref = pipeline.forward(scene, grid,
                           dataclasses.replace(config, use_kernels=False))
    for key in ('albedo', 'thermal', 'transit_depth'):
        assert torch.isfinite(out[key]).all()
        rel = _rel(out[key], ref[key])
        assert rel.max().item() <= 8e-3 and rel.median().item() <= 1e-3, key


def _split_inputs(dev, name, nwno, nang, test_mode=None):
    """Arguments of the split Toon kernels (K3-K6): ragged nwno, nang
    angles as [nang, 1] (or a 4 x 3 grid for 12); K5/K6 read the props of
    combine_optics with ``test_mode``."""
    (all_b, tg, tr, copd, cw0, cg0, rf, ptfac, surf, u0, u1, ct,
     f0pi) = _toon_inputs(dev, nwno, nang=nang)
    if nang == 12:
        u0, u1 = u0.reshape(4, 3), u1.reshape(4, 3)
    geom = [surf, u0, u1, ct, f0pi]
    if name == 'reflected_toon':
        return [tg, tr, copd, cw0, cg0, rf] + geom
    if name == 'thermal_toon':
        return [all_b, tg, tr, copd, cw0, cg0, ptfac, surf, u1]
    props = combine_optics(tg, tr, copd, cw0, cg0, rf, test_mode=test_mode)
    if name == 'reflected_toon_props':
        return [getattr(props, f) for f in cuda_toon.REFLECTED_FIELDS] + geom
    return [all_b, props.dtau_og, props.w0_no_raman, props.cosb_og,
            (props.dtau_og[0] * ptfac).contiguous(), surf, u1]


_SPLIT_CASES = {
    'reflected_toon': [
        dict(), dict(delta_eddington=False, b_top=0.1),
        dict(controls=ScatteringControls(single_phase=0,
                                         toon_coefficients=1)),
        dict(controls=ScatteringControls(single_phase=1, multi_phase=1)),
        dict(controls=ScatteringControls(single_phase=2, frac_c=1.5)),
        dict(controls=ScatteringControls(single_phase=3)),
        dict(controls=ScatteringControls(multi_phase=2))],
    'thermal_toon': [dict(), dict(hard_surface=True)],
    'reflected_toon_props': [
        dict(), dict(controls=ScatteringControls(single_phase=0)),
        dict(controls=ScatteringControls(multi_phase=2))],
    'thermal_toon_props': [dict(), dict(hard_surface=True)],
}
_SPLIT = list(_SPLIT_CASES)


def _assert_matches_twin(out, ref, nwno, nang):
    assert out.shape == ref.shape and out.shape[-1] == nwno
    assert out.shape[0] * out.shape[1] == nang
    assert torch.isfinite(out).all()
    rel = _rel(out, ref)
    assert rel.max().item() <= 1e-3
    assert rel.median().item() <= 1e-5


@pytest.mark.parametrize('nang', [1, 5, 12, 8, 9, 36])
@pytest.mark.parametrize('nwno', [300, 1000])
@pytest.mark.parametrize('name', _SPLIT)
def test_toon_split_kernels_match_twins(dev, name, nwno, nang):
    wrapper = getattr(cuda_toon, name)
    twin = getattr(cuda_toon, f'{name}_plain')
    modes = [None, 'rayleigh', 'constant_tau'] if 'props' in name else [None]
    for mode in modes:
        args = _split_inputs(dev, name, nwno, nang, mode)
        for kw in _SPLIT_CASES[name]:
            before = wrapper.launches
            out = wrapper(*args, **kw)
            torch.cuda.synchronize()
            assert wrapper.launches == before + 1
            _assert_matches_twin(out, twin(*args, **kw), nwno, nang)


@pytest.mark.parametrize('nang', [1, 5, 9, 36])
@pytest.mark.parametrize('multi_phase', [0, 1, 2])
def test_spectrum_and_reflected_kernels_agree_bitwise(dev, nang, multi_phase):
    """K2's reflected half and K3 on the same strips (no Raman factor
    between them) run the same stage A rows and stage B: equal bit for
    bit, with or without an event recorded between the stages."""
    args = _toon_inputs(dev, 1000, nang=nang)
    (all_b, tg, tr, copd, cw0, cg0, rf, ptfac, surf, u0, u1, ct,
     f0pi) = args
    kw = dict(controls=ScatteringControls(multi_phase=multi_phase))
    xint, _ = spectrum_toon(*args, **kw)
    k3_args = (tg, tr, copd, cw0, cg0, rf, surf, u0, u1, ct, f0pi)
    k3 = cuda_toon.reflected_toon(*k3_args, **kw)
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    start.record()
    k3_split = cuda_toon.reflected_toon(*k3_args, split_event=mid, **kw)
    end.record()
    torch.cuda.synchronize()
    assert torch.isfinite(k3).all()
    assert torch.equal(xint, k3) and torch.equal(k3, k3_split)
    assert start.elapsed_time(mid) > 0 and mid.elapsed_time(end) > 0


@pytest.mark.parametrize('nang', [5, 36])
@pytest.mark.parametrize('name', ['thermal_toon', 'thermal_toon_props'])
def test_toon_thermal_split_event_keeps_outputs(dev, name, nang):
    """K4's and K6's two stages with an event recorded between them give
    the same bits as without, and the event splits the time."""
    wrapper = getattr(cuda_toon, name)
    args = _split_inputs(dev, name, 1000, nang)
    for kw in _SPLIT_CASES[name]:
        out = wrapper(*args, **kw)
        start, mid, end = (torch.cuda.Event(enable_timing=True)
                           for _ in range(3))
        start.record()
        split = wrapper(*args, split_event=mid, **kw)
        end.record()
        torch.cuda.synchronize()
        assert torch.isfinite(out).all() and torch.equal(out, split), kw
        assert start.elapsed_time(mid) > 0 and mid.elapsed_time(end) > 0


def test_toon_thermal_failed_launch_raises(dev, monkeypatch):
    """K4's and K6's entries refuse a stage other than 0 or 1 with a
    nonzero code, which `check` raises on; the wrapper raises when either
    stage fails, names the stage and does not count the call."""
    from picaso_tpu_torch._build import check, library
    lib = library()
    for stage in (-1, 2, 5):
        code = lib.toon_thermal_launch(*[None] * 11, 91, 300, 5, 0, stage,
                                       None)
        assert code != 0
        with pytest.raises(RuntimeError):
            check(code, 'toon_thermal_launch')
        assert lib.toon_thermal_props_launch(*[None] * 9, 91, 300, 5, 1,
                                             stage, None) != 0
    for name, entry_name in (('thermal_toon', 'toon_thermal_launch'),
                             ('thermal_toon_props',
                              'toon_thermal_props_launch')):
        entry = getattr(lib, entry_name)
        wrapper = getattr(cuda_toon, name)
        args = _split_inputs(dev, name, 300, 5)
        for bad_stage in (0, 1):
            def refuse(*a, bad_stage=bad_stage, entry=entry):
                return 1 if a[-2] == bad_stage else entry(*a)
            monkeypatch.setattr(lib, entry_name, refuse)
            before = wrapper.launches
            with pytest.raises(RuntimeError, match='stage ' + 'AB'[bad_stage]):
                wrapper(*args)
            assert wrapper.launches == before
        monkeypatch.setattr(lib, entry_name, entry)


@pytest.mark.parametrize('name', _SPLIT)
def test_toon_split_wrappers_reject_bad_inputs(dev, name):
    wrapper = getattr(cuda_toon, name)
    args = _split_inputs(dev, name, 300, 5)
    i = 2  # a [nlayer, nwno] input other than the one that picks the device
    for bad_value, error in ((args[i].double(), TypeError),
                             (args[i].t().contiguous().t(), ValueError),
                             (args[i].cpu(), ValueError),
                             (args[i][:, :200].contiguous(), ValueError)):
        bad = list(args)
        bad[i] = bad_value
        with pytest.raises(error):
            wrapper(*bad)
    if name.startswith('reflected'):
        # multi_phase=2 (isotropic) runs and matches the twin; 3 is unknown
        kw = dict(controls=ScatteringControls(multi_phase=2))
        twin = getattr(cuda_toon, f'{name}_plain')
        out = wrapper(*args, **kw)
        torch.cuda.synchronize()
        _assert_matches_twin(out, twin(*args, **kw), 300, 5)
        with pytest.raises(ValueError):
            wrapper(*args, controls=ScatteringControls(multi_phase=3))


_SPLIT_FORWARDS = {
    'reflected': (dict(thermal=False, raman=1), ('reflected_toon',)),
    'thermal': (dict(reflected=False), ('thermal_toon',)),
    'unfused': (dict(fuse_optics=False),
                ('reflected_toon_props', 'thermal_toon_props')),
    # reflected-only, as the literature-validation runs use the test modes
    # (scripts/run_dlugach.py): build_problem's clear top layer is floored
    # to dtau 1e-10 there, which leaves the f32 thermal solve
    # ill-conditioned
    'constant_tau': (dict(test_mode='constant_tau', thermal=False),
                     ('reflected_toon_props',)),
}


@pytest.mark.parametrize('case', list(_SPLIT_FORWARDS))
def test_toon_split_forwards_match_plain_path(dev, case):
    change, kernels = _SPLIT_FORWARDS[case]
    scene, grid, config = pipeline.build_problem(
        2000, production=False, device=dev, raman=change.get('raman', 2))
    config = dataclasses.replace(config, **change)
    names = ('spectrum_toon',) + tuple(_SPLIT)
    before = {n: getattr(cuda_toon, n).launches for n in names}
    out = pipeline.forward(scene, grid, config)
    torch.cuda.synchronize()
    for n in names:
        assert getattr(cuda_toon, n).launches == before[n] + (n in kernels), n
    ref = pipeline.forward(scene, grid,
                           dataclasses.replace(config, use_kernels=False))
    assert set(out) == set(ref)
    for key in out:
        assert torch.isfinite(out[key]).all()
        rel = _rel(out[key], ref[key])
        assert rel.max().item() <= 5e-3 and rel.median().item() <= 2e-4, key


@pytest.mark.parametrize('profile', _GATHER_PROFILES)
@pytest.mark.parametrize('nlayer', [12, 17])
@pytest.mark.parametrize('nwno', [256, 700, 37])
def test_interp_q_kernel_matches_twin(dev, nwno, nlayer, profile):
    log_kappa, idx, t_w, p_w, mixcol = _gather_inputs(dev, nwno, nlayer,
                                                      profile=profile)
    q, qp = quantize_table(log_kappa)
    before = interp_tau_q.launches
    out = interp_tau_q(q, idx, t_w, p_w, mixcol, qparams=qp)
    torch.cuda.synchronize()
    assert interp_tau_q.launches == before + 1
    ref = interp_tau_q_plain(q, idx, t_w, p_w, mixcol, qp)
    assert out.shape == ref.shape == (nlayer, nwno)
    assert torch.isfinite(out).all()
    assert _rel(out, ref).max().item() <= 1e-5
    # the int16 gather stays within its quantization of the float one
    assert _rel(out, interp_tau(log_kappa, idx, t_w, p_w, mixcol)
                ).max().item() <= 5e-3


def test_interp_failed_launch_raises(dev, monkeypatch):
    """A launch whose dynamic shared memory the card refuses (the column
    weights of 5000 molecules do not fit beside the staging ring) returns
    a nonzero code: both wrappers raise and do not count the call, and the
    next launch is not charged with the error.  An entry that reports a
    failure makes them raise as well."""
    from picaso_tpu_torch._build import library
    nmol, nlayer = 5000, 12
    f32 = dict(dtype=torch.float32, device=dev)
    table = torch.zeros((nmol, 2, 8), **f32)
    idx = torch.zeros((4, nlayer), dtype=torch.int64, device=dev)
    t_w = p_w = torch.full((nlayer,), 0.5, **f32)
    mixcol = torch.zeros((nmol, nlayer), **f32)
    qp = torch.tensor([1e-3, 0.0], **f32)
    calls = ((interp_tau, 'interp_tau_launch', (table, idx, t_w, p_w, mixcol)),
             (interp_tau_q, 'interp_tau_q_launch',
              (table.to(torch.int16), idx, t_w, p_w, mixcol, qp)))
    for wrapper, _, args in calls:
        before = wrapper.launches
        with pytest.raises(RuntimeError, match='CUDA error'):
            wrapper(*args)
        assert wrapper.launches == before
    args = _gather_inputs(dev, 300)
    ref = interp_tau(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(ref).all()
    lib = library()
    for wrapper, entry_name, _ in calls:
        monkeypatch.setattr(lib, entry_name, lambda *a: 1)
        q, qp = quantize_table(args[0])
        good = args if wrapper is interp_tau else (q,) + args[1:] + (qp,)
        before = wrapper.launches
        with pytest.raises(RuntimeError, match='CUDA error 1'):
            wrapper(*good)
        assert wrapper.launches == before
    monkeypatch.undo()
    assert torch.equal(interp_tau(*args), ref)


def test_interp_q_wrapper_rejects_bad_inputs(dev):
    log_kappa, idx, t_w, p_w, mixcol = _gather_inputs(dev, 300)
    q, qp = quantize_table(log_kappa)
    with pytest.raises(TypeError):
        interp_tau_q(log_kappa, idx, t_w, p_w, mixcol, qparams=qp)
    with pytest.raises(ValueError):
        interp_tau_q(q, idx, t_w, p_w, mixcol)
    with pytest.raises(ValueError):
        interp_tau_q(q, idx, t_w, p_w, mixcol, qparams=qp.cpu())


def test_quantize_on_card_equals_cpu(dev):
    log_kappa = _gather_inputs(dev, 700)[0]
    q, qp = quantize_table(log_kappa)
    q_cpu, qp_cpu = quantize_table(log_kappa.cpu())
    assert q.device.type == 'cuda'
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(qp.cpu(), qp_cpu)


def test_int16_forward_takes_k8(dev):
    scene, grid, config = pipeline.build_problem(2000, production=False,
                                                 device=dev, blocked='int16')
    before = (interp_tau.launches, interp_tau_q.launches,
              spectrum_toon.launches)
    out = pipeline.forward(scene, grid, config)
    torch.cuda.synchronize()
    assert (interp_tau.launches, interp_tau_q.launches,
            spectrum_toon.launches) == (before[0], before[1] + 1,
                                        before[2] + 1)
    ref = pipeline.forward(scene, grid,
                           dataclasses.replace(config, use_kernels=False))
    for key in ('albedo', 'thermal', 'transit_depth'):
        assert torch.isfinite(out[key]).all()
        rel = _rel(out[key], ref[key])
        assert rel.max().item() <= 5e-3 and rel.median().item() <= 4e-3, key


@pytest.mark.parametrize('slots', ['raw', 'stabilized', 'parity',
                                   'constant'])
def test_layer_inner_kernel_matches_twin(dev, slots):
    scene, grid, config = pipeline.build_problem(2000, production=False,
                                                 device=dev)
    log_kappa, mixcol, inputs = gather_probe.slot_inputs(scene, grid,
                                                         config)
    idx, w4 = inputs[slots]
    kernel = gather_probe.interp_tau_layer_inner
    before = kernel.launches
    out = kernel(log_kappa, idx, w4, mixcol)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = gather_probe.interp_tau_layer_inner_plain(log_kappa, idx, w4,
                                                    mixcol)
    assert _rel(out, ref).max().item() <= 1e-5
    if slots != 'constant':
        k1 = interp_tau(*pipeline.gather_args(scene, grid, config))
        assert _rel(out, k1).max().item() <= 1e-4


@pytest.mark.parametrize('layout', ['rows', 32, 64, 128])
def test_sweep_kernels_match_twin(dev, layout):
    b, c, d = sweep_layout_probe.sweep_inputs(90, 1000, dev, seed=5)
    if layout == 'rows':
        kernel, kw = sweep_layout_probe.sweep_rows, {}
    else:
        kernel, kw = sweep_layout_probe.sweep_staged, dict(tile=layout)
    before = kernel.launches
    out = kernel(b, c, d, **kw)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = sweep_layout_probe.sweep_plain(b, c, d)
    assert torch.isfinite(out).all()
    assert _rel(out, ref).max().item() <= 1e-5

