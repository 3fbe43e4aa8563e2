"""The SH wrappers' contract on the CPU, and the SH forwards' memory.

The SH kernels, reflected and thermal, run in two launches on the card
(stage A per column, stage B per column and angle) and take
``split_event``, an event recorded between them; on CPU tensors the
wrappers run their twins, which take no event.  A forward through the plain SH path or through the twins
leaves nothing for the garbage collector: every tensor it made is freed
when its last reference goes, so a peak measured after a forward is not
inflated by the forward before it.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from picaso_tpu_torch import pipeline
from picaso_tpu_torch.rt import cuda_sh
from picaso_tpu_torch.rt.toon import blackbody


def _reflected_args(nwno=64, nlayer=12, nang=3, seed=4):
    rng = np.random.default_rng(seed)
    shape = (nlayer, nwno)

    def t(x):
        return torch.tensor(x, dtype=torch.float32)

    return [t(rng.uniform(1e-4, 1.5, shape)), t(rng.uniform(1e-5, 0.3, shape)),
            t(rng.uniform(0.0, 1.0, shape)), t(rng.uniform(0.3, 0.99, shape)),
            t(rng.uniform(0.0, 0.9, shape)),
            t(rng.uniform(0.9, 0.99999, shape)), t(np.full(nwno, 0.1)),
            t(rng.uniform(0.1, 1.0, (nang, 1))),
            t(rng.uniform(0.1, 1.0, (nang, 1))), 0.5,
            t(rng.uniform(0.5, 1.5, nwno))]


@pytest.mark.parametrize('stream', [2, 4])
def test_reflected_wrapper_ignores_split_event_on_cpu(stream):
    wrapper = getattr(cuda_sh, f'reflected_sh{stream}')
    twin = getattr(cuda_sh, f'reflected_sh{stream}_plain')
    args = _reflected_args()
    kw = dict(delta_eddington=False, b_top=0.1)
    before = wrapper.launches
    out = wrapper(*args, split_event=object(), **kw)
    assert wrapper.launches == before
    assert torch.equal(out, twin(*args, **kw))
    with pytest.raises(TypeError):
        twin(*args, split_event=None)


@pytest.mark.parametrize('stream', [2, 4])
def test_thermal_wrapper_ignores_split_event_on_cpu(stream):
    wrapper = getattr(cuda_sh, f'thermal_sh{stream}')
    twin = getattr(cuda_sh, f'thermal_sh{stream}_plain')
    tlevel = torch.tensor(np.linspace(400.0, 1600.0, 13))
    wno = torch.tensor(np.linspace(300.0, 20000.0, 64))
    all_b = blackbody(tlevel, 1.0 / wno).float()
    strips = _reflected_args(nang=4)
    args = [all_b] + strips[:6] + [0.7, strips[6], strips[8]]
    kw = dict(hard_surface=True)
    before = wrapper.launches
    out = wrapper(*args, split_event=object(), **kw)
    assert wrapper.launches == before
    assert out.shape == (4, 1, 64) and torch.isfinite(out).all()
    assert torch.equal(out, twin(*args, **kw))
    with pytest.raises(TypeError):
        twin(*args, split_event=None)


@pytest.mark.parametrize('use_kernels', [False, True])
@pytest.mark.parametrize('stream', [2, 4])
def test_sh_forward_leaves_no_reference_cycles(stream, use_kernels):
    """use_kernels=False: the plain path (rt/sh.py); True: the twins."""
    scene, grid, config = pipeline.build_problem(
        200, production=False, device='cpu', dtype=torch.float32)
    config = dataclasses.replace(config, rt_method=1, stream=stream,
                                 use_kernels=use_kernels)
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        out = pipeline.forward(scene, grid, config)
        assert torch.isfinite(out['albedo']).all()
        del out
        gc.collect()
        left = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert left == []
