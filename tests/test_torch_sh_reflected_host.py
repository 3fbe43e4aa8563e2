"""The SH reflected kernels' two stages, built as host C++, against their twins.

``csrc/sh_spectrum.cu`` compiles without nvcc as plain C++ (the CUDA
qualifiers empty, the thread indices globals): its ``sh_reflected_host``
entry runs stage A's threads (``sh_reflected_columns``, one per column:
the optics, the layer values stage B reads, the factorised block rows)
and then stage B's (``sh_reflected_angles``, one per column and angle, in
blocks of 32 columns by at most 8 angles) as loops, on host memory.  This
holds the kernels' own arithmetic, their scratch layout and their thread
and chunk indexing against ``reflected_sh{4,2}_plain`` on the CPU, at
every form switch; the card runs the same source through nvcc
(``tests/test_torch_kernels_cuda.py``).

Built with ``g++ -std=c++17 -O1 -ffp-contract=off`` (no contraction into
fused multiply-adds, as ``-fmad=false`` on the card) into a temporary
directory and loaded with ctypes.  Tolerances: float32 on both sides,
max rel <= 1e-3 and median rel <= 1e-5, as
``tests/test_torch_sh_thermal_host.py`` and the card tests.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from picaso_tpu_torch.rt import cuda_sh
from picaso_tpu_torch.rt.toon import ScatteringControls

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'picaso_tpu_torch', 'csrc', 'sh_spectrum.cu')
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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
    lib.sh_reflected_host.argtypes = ([_I] + [_P] * 13 + [_I] * 11
                                      + [_F] * 8)
    lib.sh_reflected_host.restype = _I
    lib.sh_reflected_scratch_slots.argtypes = [_I, _I]
    lib.sh_reflected_scratch_slots.restype = _I
    lib.sh_scratch_row.argtypes = [_I]
    lib.sh_scratch_row.restype = _I
    return lib


def _inputs(nwno=300, nlayer=12, nang=5, seed=31):
    """reflected_sh{4,2}'s arguments, float32 on the CPU, angles [nang,
    1]."""
    rng = np.random.default_rng(seed)
    shape = (nlayer, nwno)

    def t(x):
        return torch.tensor(x, dtype=torch.float32)

    return [t(rng.uniform(1e-4, 1.5, shape)), t(rng.uniform(1e-5, 0.3, shape)),
            t(rng.uniform(0.0, 1.0, shape)), t(rng.uniform(0.3, 0.99, shape)),
            t(rng.uniform(0.0, 0.9, shape)), t(rng.uniform(0.9, 0.99999, shape)),
            t(np.full(nwno, 0.1)), t(rng.uniform(0.1, 1.0, (nang, 1))),
            t(rng.uniform(0.1, 1.0, (nang, 1))), t(0.6),
            t(rng.uniform(0.5, 2.0, nwno))]


def _call_host(lib, stream, args, out, scratch,
               controls=ScatteringControls(), b_top=0.0,
               delta_eddington=True, w_single_form=0, w_multi_form=0,
               psingle_form=0, w_single_rayleigh=1, w_multi_rayleigh=1,
               psingle_rayleigh=1, single_form=0):
    """sh_reflected_host with the arguments as the card's wrapper passes
    them (``rt/cuda_sh._launch_reflected``); its return code."""
    tg, tr, copd, cw0, cg0, rf, surf, u0, u1, ct, f0pi = args
    nlayer, nwno = tg.shape
    c = controls
    return lib.sh_reflected_host(
        stream, *(x.data_ptr() for x in (tg, tr, copd, cw0, cg0, rf, surf,
                                         f0pi, u0.reshape(-1),
                                         u1.reshape(-1), ct.reshape(1),
                                         out, scratch)),
        nlayer, nwno, u0.numel(), int(delta_eddington), w_single_form,
        w_multi_form, psingle_form, w_single_rayleigh, w_multi_rayleigh,
        psingle_rayleigh, single_form, c.frac_a, c.frac_b, c.frac_c,
        c.constant_back, c.constant_forward, b_top,
        c.constant_forward ** stream, c.constant_back ** stream)


def _run_host(lib, stream, args, **kw):
    """Both stages on the host: out [nang, nwno]."""
    nlayer, nwno = args[0].shape
    nang = args[7].numel()
    out = torch.full((nang, nwno), float('nan'))
    scratch = torch.full((lib.sh_reflected_scratch_slots(stream, nang),
                          nlayer + 1, lib.sh_scratch_row(nwno)), float('nan'))
    assert _call_host(lib, stream, args, out, scratch, **kw) == 0
    return out


def _rel(a, b):
    a, b = a.double(), b.double()
    scale = torch.clamp(b.abs(), min=b.abs().max().item() * 1e-9 + 1e-300)
    return (a - b).abs() / scale


# every switch stage A now folds into the stored layer values: the w_*
# forms 0 (TTHG) and 1 (OTHG), single_form 0 (the phase function at
# cos_theta) and 1 (its Legendre weights), each Rayleigh switch off and
# on, delta_eddington off and on; a non-integer frac_c (pow_noint's expf
# and logf) and a nonzero b_top
_CASES = [dict(),
          dict(w_single_form=1, w_multi_form=1, psingle_form=1),
          dict(single_form=1),
          dict(w_single_form=1, single_form=1, w_single_rayleigh=0,
               w_multi_rayleigh=0, psingle_rayleigh=0),
          dict(psingle_rayleigh=0, w_multi_rayleigh=0, delta_eddington=False,
               b_top=0.1),
          dict(w_multi_form=1, w_single_rayleigh=0, delta_eddington=False,
               controls=ScatteringControls(frac_c=1.5))]


# nang 1, 8, 9 and 36 are stage B's chunk edges (one angle; one full chunk
# of 8; two chunks of 5, one thread idle; five chunks of 8, four idle);
# nwno 300 is not a multiple of its 32 columns nor of stage A's 128
@pytest.mark.parametrize('case', range(len(_CASES)))
@pytest.mark.parametrize('nang', [1, 8, 9, 36])
@pytest.mark.parametrize('stream', [2, 4])
def test_host_reflected_stages_match_twin(lib, stream, nang, case):
    kw = _CASES[case]
    args = _inputs(nang=nang)
    out = _run_host(lib, stream, args, **kw)
    ref = getattr(cuda_sh, f'reflected_sh{stream}_plain')(*args, **kw)
    assert ref.shape == (nang, 1, 300)
    assert torch.isfinite(out).all()
    rel = _rel(out, ref.reshape(nang, 300))
    assert rel.max().item() <= 1e-3
    assert rel.median().item() <= 1e-5


@pytest.mark.parametrize('case', [0, 3])
@pytest.mark.parametrize('stream', [2, 4])
def test_host_reflected_angle_permutation_permutes_outputs(lib, stream,
                                                           case):
    """Permuting the angles permutes the outputs bitwise: each (column,
    angle) thread of stage B reads only its own angle and the layer values
    stage A stored, whatever chunk and warp it lands in."""
    kw = _CASES[case]
    args = _inputs(nang=9)
    out = _run_host(lib, stream, args, **kw)
    perm = torch.tensor([8, 3, 0, 5, 1, 7, 2, 6, 4])
    u0, u1 = args[7], args[8]
    permuted = args[:7] + [u0[perm].contiguous(), u1[perm].contiguous()] \
        + args[9:]
    assert torch.equal(_run_host(lib, stream, permuted, **kw), out[perm])


@pytest.mark.parametrize('nwno', [1, 31, 32, 33, 300, 58681])
def test_host_scratch_rows_are_whole_lines(lib, nwno):
    """Each scratch row is padded to 32 floats (128 bytes), no further."""
    row = lib.sh_scratch_row(nwno)
    assert row % 32 == 0 and nwno <= row < nwno + 32


def test_host_reflected_refuses_other_streams(lib):
    assert lib.sh_reflected_scratch_slots(3, 5) < 0
    assert (lib.sh_reflected_scratch_slots(4, 5)
            > lib.sh_reflected_scratch_slots(2, 5))
    assert (lib.sh_reflected_scratch_slots(4, 6)
            == lib.sh_reflected_scratch_slots(4, 5) + 4)
    args = _inputs(nwno=40, nang=1)
    out = torch.zeros(1, 40)
    scratch = torch.zeros(lib.sh_reflected_scratch_slots(4, 1), 13,
                          lib.sh_scratch_row(40))
    assert _call_host(lib, 3, args, out, scratch) != 0
    assert torch.equal(out, torch.zeros(1, 40))
