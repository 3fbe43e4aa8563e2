"""The Toon thermal kernels' two stages, built as host C++, against their twins.

``csrc/toon_spectrum.cu`` compiles without nvcc as plain C++ (the CUDA
qualifiers empty, the thread indices globals): its ``toon_thermal_host``
entry runs stage A's threads (``toon_thermal_columns``, one per column) and
then stage B's (``toon_thermal_angles_kernel``, one per column and angle,
in blocks of 32 columns by at most 8 angles) as loops, on host memory, for
K4 (optics from the strips) and K6 (optics given).  This holds the
kernels' own arithmetic and their thread and chunk indexing against
``thermal_toon_plain`` and ``thermal_toon_props_plain`` on the CPU; the
card runs the same source through nvcc
(``tests/test_torch_kernels_cuda.py``).

Built with ``g++ -std=c++17 -O1 -ffp-contract=off`` (no contraction into
fused multiply-adds, as ``-fmad=false`` on the card) into a temporary
directory and loaded with ctypes.  Tolerances: float32 on both sides,
max rel <= 1e-3 and median rel <= 1e-5 (the card tests' gates; glibc's
expf and torch's exp differ by an ulp, which the layer recursions
amplify).
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from picaso_tpu_torch.optics import combine_optics
from picaso_tpu_torch.rt import cuda_toon
from picaso_tpu_torch.rt.toon import blackbody

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'picaso_tpu_torch', 'csrc', 'toon_spectrum.cu')
_P, _I = ctypes.c_void_p, ctypes.c_int
_NWNO, _NLAYER = 300, 12


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ to build csrc/toon_spectrum.cu as host C++')
    out = tmp_path_factory.mktemp('toon_host') / 'libtoon_host.so'
    subprocess.run([gxx, '-std=c++17', '-O1', '-ffp-contract=off', '-shared',
                    '-fPIC', '-x', 'c++', _SRC, '-o', str(out)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.toon_thermal_host.argtypes = [_I] + [_P] * 15 + [_I] * 4
    lib.toon_thermal_host.restype = _I
    lib.toon_thermal_scratch_slots.argtypes = [_I]
    lib.toon_thermal_scratch_slots.restype = _I
    return lib


def _inputs(kind, nang, nwno=_NWNO, nlayer=_NLAYER, seed=31):
    """thermal_toon's (K4) or thermal_toon_props' (K6) arguments, float32
    on the CPU, angles [nang, 1]; K6 reads the OG props of
    combine_optics on the same strips."""
    rng = np.random.default_rng(seed)
    shape = (nlayer, nwno)

    def t(x):
        return torch.tensor(x, dtype=torch.float32)

    all_b = blackbody(t(np.linspace(400.0, 1600.0, nlayer + 1)),
                      1.0 / t(np.linspace(300.0, 20000.0, nwno)))
    strips = [t(rng.uniform(1e-4, 1.5, shape)),
              t(rng.uniform(1e-5, 0.3, shape)),
              t(rng.uniform(0.0, 1.0, shape)),
              t(rng.uniform(0.3, 0.99, shape)),
              t(rng.uniform(0.0, 0.9, shape))]
    rf = t(rng.uniform(0.9, 0.99999, shape))
    surf = t(np.full(nwno, 0.1))
    u1 = t(rng.uniform(0.1, 1.0, (nang, 1)))
    if kind == 'thermal_toon':
        return [all_b.contiguous()] + strips + [t([0.7]), surf, u1]
    props = combine_optics(*strips, rf)
    return [all_b.contiguous(), props.dtau_og, props.w0_no_raman,
            props.cosb_og, (props.dtau_og[0] * 0.7).contiguous(), surf, u1]


def _call_host(lib, kind, args, out, scratch, hard_surface=False,
               props=None):
    """toon_thermal_host on ``args`` (K4's or K6's); ``props`` overrides
    the selector the kind implies."""
    if kind == 'thermal_toon':
        all_b, *strips, ptfac, surf, u1 = args
        given = [None] * 4
        picked = 0
    else:
        all_b, dtau, w0, cosb, tau_top, surf, u1 = args
        strips, ptfac = [None] * 5, None
        given = [dtau, w0, cosb, tau_top]
        picked = 1
    ptrs = [None if x is None else x.data_ptr()
            for x in [all_b, *strips, ptfac, *given, surf, u1]]
    return lib.toon_thermal_host(
        picked if props is None else props, *ptrs, out.data_ptr(),
        scratch.data_ptr(), _NLAYER, out.shape[1], u1.numel(),
        int(hard_surface))


def _run_host(lib, kind, args, **kw):
    out = torch.full((args[-1].numel(), _NWNO), float('nan'))
    scratch = torch.full((lib.toon_thermal_scratch_slots(out.shape[0]),
                          _NLAYER + 1, _NWNO), float('nan'))
    assert _call_host(lib, kind, args, out, scratch, **kw) == 0
    return out


def _rel(a, b):
    a, b = a.double(), b.double()
    scale = torch.clamp(b.abs(), min=b.abs().max().item() * 1e-9 + 1e-300)
    return (a - b).abs() / scale


_KINDS = ['thermal_toon', 'thermal_toon_props']


# nang 9 crosses stage B's 8-angle chunk (two chunks of 5, one thread idle);
# nwno 300 is not a multiple of its 32 columns nor of stage A's 128
@pytest.mark.parametrize('hard_surface', [False, True])
@pytest.mark.parametrize('nang', [1, 5, 9])
@pytest.mark.parametrize('kind', _KINDS)
def test_host_thermal_stages_match_twin(lib, kind, nang, hard_surface):
    args = _inputs(kind, nang)
    out = _run_host(lib, kind, args, hard_surface=hard_surface)
    ref = getattr(cuda_toon, f'{kind}_plain')(*args,
                                              hard_surface=hard_surface)
    assert ref.shape == (nang, 1, _NWNO)
    assert torch.isfinite(out).all()
    rel = _rel(out, ref.reshape(nang, _NWNO))
    assert rel.max().item() <= 1e-3
    assert rel.median().item() <= 1e-5


@pytest.mark.parametrize('kind', _KINDS)
def test_host_thermal_angles_are_independent(lib, kind):
    """Each (column, angle) thread of stage B gives the bits it gives when
    its angle is swept alone: the chunking does not mix angles."""
    args = _inputs(kind, 9)
    out = _run_host(lib, kind, args)
    u1 = args[-1]
    for a in (0, 4, 5, 8):
        alone = _run_host(lib, kind, args[:-1] + [u1[a:a + 1].clone()])
        assert torch.equal(alone[0], out[a])


def test_host_thermal_refuses_other_props(lib):
    assert lib.toon_thermal_scratch_slots(5) == lib.toon_thermal_scratch_slots(
        36) > 0
    args = _inputs('thermal_toon', 1)
    out = torch.zeros(1, _NWNO)
    scratch = torch.zeros(lib.toon_thermal_scratch_slots(1), _NLAYER + 1,
                          _NWNO)
    assert _call_host(lib, 'thermal_toon', args, out, scratch, props=2) != 0
    assert torch.equal(out, torch.zeros(1, _NWNO))
