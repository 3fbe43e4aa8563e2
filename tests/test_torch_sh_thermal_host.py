"""The SH thermal kernels' two stages, built as host C++, against their twins.

``csrc/sh_spectrum.cu`` compiles without nvcc as plain C++ (the CUDA
qualifiers empty, the thread indices globals): its ``sh_thermal_host``
entry runs stage A's threads (``sh_thermal_columns``, one per column) and
then stage B's (``sh_thermal_angles``, one per column and angle, in blocks
of 32 columns by at most 8 angles) as loops, on host memory.  This holds
the kernels' own arithmetic and their thread and chunk indexing against
``thermal_sh{4,2}_plain`` on the CPU; the card runs the same source through
nvcc (``tests/test_torch_kernels_cuda.py``).

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

from picaso_tpu_torch.rt import cuda_sh
from picaso_tpu_torch.rt.toon import blackbody

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'picaso_tpu_torch', 'csrc', 'sh_spectrum.cu')
_P, _I = ctypes.c_void_p, ctypes.c_int


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ to build csrc/sh_spectrum.cu as host C++')
    out = tmp_path_factory.mktemp('sh_host') / 'libsh_host.so'
    subprocess.run([gxx, '-std=c++17', '-O1', '-ffp-contract=off', '-shared',
                    '-fPIC', '-x', 'c++', _SRC, '-o', str(out)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.sh_thermal_host.argtypes = [_I] + [_P] * 12 + [_I] * 5
    lib.sh_thermal_host.restype = _I
    lib.sh_thermal_scratch_slots.argtypes = [_I]
    lib.sh_thermal_scratch_slots.restype = _I
    lib.sh_scratch_row.argtypes = [_I]
    lib.sh_scratch_row.restype = _I
    return lib


def _inputs(nwno=300, nlayer=12, nang=5, seed=29):
    """thermal_sh{4,2}'s arguments, float32 on the CPU, angles [nang, 1]."""
    rng = np.random.default_rng(seed)
    shape = (nlayer, nwno)

    def t(x):
        return torch.tensor(x, dtype=torch.float32)

    all_b = blackbody(t(np.linspace(400.0, 1600.0, nlayer + 1)),
                      1.0 / t(np.linspace(300.0, 20000.0, nwno)))
    return [all_b.contiguous(), t(rng.uniform(1e-4, 1.5, shape)),
            t(rng.uniform(1e-5, 0.3, shape)), t(rng.uniform(0.0, 1.0, shape)),
            t(rng.uniform(0.3, 0.99, shape)), t(rng.uniform(0.0, 0.9, shape)),
            t(rng.uniform(0.9, 0.99999, shape)), t([0.7]),
            t(np.full(nwno, 0.1)), t(rng.uniform(0.1, 1.0, (nang, 1)))]


def _call_host(lib, stream, args, out, scratch, hard_surface=False,
               delta_eddington=True):
    all_b, tg, tr, copd, cw0, cg0, rf, ptfac, surf, u1 = args
    nlayer, nwno = tg.shape
    return lib.sh_thermal_host(
        stream, *(x.data_ptr() for x in (all_b, tg, tr, copd, cw0, cg0, rf,
                                         surf, u1.reshape(-1), ptfac)),
        out.data_ptr(), scratch.data_ptr(), nlayer, nwno, u1.numel(),
        int(delta_eddington), int(hard_surface))


def _run_host(lib, stream, args, **kw):
    nlayer, nwno = args[1].shape
    out = torch.full((args[-1].numel(), nwno), float('nan'))
    scratch = torch.full((lib.sh_thermal_scratch_slots(stream), nlayer + 1,
                          lib.sh_scratch_row(nwno)), float('nan'))
    assert _call_host(lib, stream, args, out, scratch, **kw) == 0
    return out


def _rel(a, b):
    a, b = a.double(), b.double()
    scale = torch.clamp(b.abs(), min=b.abs().max().item() * 1e-9 + 1e-300)
    return (a - b).abs() / scale


_CASES = [dict(), dict(hard_surface=True, delta_eddington=False)]


# nang 9 crosses stage B's 8-angle chunk (two chunks of 5, one thread idle);
# nwno 300 is not a multiple of its 32 columns nor of stage A's 128
@pytest.mark.parametrize('case', range(len(_CASES)))
@pytest.mark.parametrize('nang', [1, 5, 9])
@pytest.mark.parametrize('stream', [2, 4])
def test_host_thermal_stages_match_twin(lib, stream, nang, case):
    kw = _CASES[case]
    args = _inputs(nang=nang)
    out = _run_host(lib, stream, args, **kw)
    ref = getattr(cuda_sh, f'thermal_sh{stream}_plain')(*args, **kw)
    assert ref.shape == (nang, 1, 300)
    assert torch.isfinite(out).all()
    rel = _rel(out, ref.reshape(nang, 300))
    assert rel.max().item() <= 1e-3
    assert rel.median().item() <= 1e-5


@pytest.mark.parametrize('stream', [2, 4])
def test_host_thermal_angles_are_independent(lib, stream):
    """Each (column, angle) thread of stage B gives the bits it gives when
    its angle is swept alone: the chunking does not mix angles."""
    args = _inputs(nang=9)
    out = _run_host(lib, stream, args)
    u1 = args[-1]
    for a in (0, 4, 5, 8):
        alone = _run_host(lib, stream, args[:-1] + [u1[a:a + 1].clone()])
        assert torch.equal(alone[0], out[a])


def test_host_thermal_refuses_other_streams(lib):
    assert lib.sh_thermal_scratch_slots(3) < 0
    assert lib.sh_thermal_scratch_slots(4) > lib.sh_thermal_scratch_slots(2)
    args = _inputs(nwno=40, nang=1)
    out = torch.zeros(1, 40)
    scratch = torch.zeros(lib.sh_thermal_scratch_slots(4), 13,
                          lib.sh_scratch_row(40))
    assert _call_host(lib, 3, args, out, scratch) != 0
    assert torch.equal(out, torch.zeros(1, 40))
