"""The port's CUDA kernels against their plain twins, on the card.

Skipped without a CUDA device (the decision is made inside the fixture, so
every test worker collects the same tests).  Run on a GPU machine with

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

(--noconftest: tests/conftest.py imports jax, which a GPU machine for the
port need not have).

Tolerances, float32 on both sides with the same arithmetic order (the
kernels are built with -fmad=false): the gather to rtol 1e-5; the spectrum
kernel to max rel 1e-3 and median rel 1e-5 (the recursions amplify the
few-ulp differences of expf/cumsum between the two).
"""

import dataclasses

import numpy as np
import pytest
import torch

from picaso_tpu_torch import pipeline
from picaso_tpu_torch.opacities.cuda_interp import (interp_tau,
                                                    interp_tau_plain)
from picaso_tpu_torch.opacities.db import _find_indices
from picaso_tpu_torch.opacities.factory import synthetic_opacity_grid
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


def _gather_inputs(dev, nwno, nlayer=12, seed=3):
    wno = np.linspace(1000.0, 15000.0, nwno)
    grid = synthetic_opacity_grid(wno, molecules=('H2O', 'CH4', 'CO'),
                                  ntemp=6, npress=5, dtype=torch.float32,
                                  device=dev)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=dev)
    tlayer = torch.tensor(rng.uniform(200.0, 2400.0, nlayer), **f32)
    player = torch.tensor(np.logspace(-5, 2, nlayer), **f32)
    mixcol = torch.tensor(rng.uniform(1e-6, 1e-3, (3, nlayer))
                          * rng.uniform(1.0, 100.0, nlayer), **f32)
    t_w, p_w, idx = _find_indices(grid.pt, tlayer, player)
    return grid.log_kappa, idx, t_w, p_w, mixcol


@pytest.mark.parametrize('nwno', [256, 700, 37])
def test_interp_kernel_matches_twin(dev, nwno):
    args = _gather_inputs(dev, nwno)
    before = interp_tau.launches
    out = interp_tau(*args)
    torch.cuda.synchronize()
    assert interp_tau.launches == before + 1
    ref = interp_tau_plain(*args)
    assert out.shape == ref.shape == (12, nwno)
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
]


@pytest.mark.parametrize('nwno', [300, 1000])
@pytest.mark.parametrize('case', range(len(_CASES)))
def test_toon_kernel_matches_twin(dev, nwno, case):
    args = _toon_inputs(dev, nwno)
    kw = _CASES[case]
    before = spectrum_toon.launches
    xint, therm = spectrum_toon(*args, **kw)
    torch.cuda.synchronize()
    assert spectrum_toon.launches == before + 1
    r_xint, r_therm = spectrum_toon_plain(*args, **kw)
    for out, ref in ((xint, r_xint), (therm, r_therm)):
        assert out.shape == ref.shape == (3, 1, nwno)
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
