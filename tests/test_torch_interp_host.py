"""The gather kernels K1 and K8, built as host C++, against their twins.

``csrc/interp_tau.cu`` compiles without nvcc as plain C++ (the CUDA
qualifiers empty, the asynchronous copies plain copies): its
``interp_tau_host`` entry runs each block of K1 (float32 table) or K8
(int16 table) as loops, in the kernel's order -- the prologue that numbers
the distinct rows of the block's layer chunk, then per molecule the staging
of those rows' tile and every thread's blend -- on host memory.  This holds
the kernels' own arithmetic, their row deduplication and their chunk, tile
and alignment handling against ``interp_tau_plain`` and
``interp_tau_q_plain`` on the CPU; the card runs the same source through
nvcc (``tests/test_torch_kernels_cuda.py``).

Built with ``g++ -std=c++17 -O1 -ffp-contract=off`` (no contraction into
fused multiply-adds, as ``-fmad=false`` on the card) into a temporary
directory and loaded with ctypes.  Tolerance: float32 on both sides, max
rel <= 1e-6 (glibc's expf and torch's exp may differ by an ulp per term).

Cases: nlayer 12, 17 and 90 against the kernel's chunk of L layers (a
lone short chunk, a ragged last chunk, whole chunks); nwno 1000 (a ragged
last tile), 1004, 1002 and 1037 and a table that starts 4 bytes past an
aligned address, so that the staging takes each of its copy widths (16,
8 and 4 bytes, and int16 elements one by one); 1, 3 and 16 molecules; and
three profiles of row ids: a smooth one (few distinct rows per chunk), a
scattered one (``probes.gather_ab.scattered_layers``: 4L distinct rows in
a chunk, more than a staging stage holds, so the kernels take it in
passes) and one clamped at the grid's edge,
where layers share all their rows and some layers repeat a row among their
own four corners.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from picaso_tpu_torch.opacities.cuda_interp import (interp_tau_plain,
                                                    interp_tau_q_plain,
                                                    quantize_table)
from picaso_tpu_torch.opacities.db import (LOG_AVO, PTGrid, _find_indices,
                                           corner_weights)
from picaso_tpu_torch.opacities.factory import (default_pt_grid,
                                                synthetic_opacity_grid_ragged)
from picaso_tpu_torch.probes.gather_ab import scattered_layers

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'picaso_tpu_torch', 'csrc', 'interp_tau.cu')
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LN10 = float(np.log(10.0))
_NT, _NP = 16, 10   # the (T, P) grid: 160 table rows


@pytest.fixture(scope='module')
def lib(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('no g++ to build csrc/interp_tau.cu as host C++')
    out = tmp_path_factory.mktemp('interp_host') / 'libinterp_host.so'
    subprocess.run([gxx, '-std=c++17', '-O1', '-ffp-contract=off', '-shared',
                    '-fPIC', '-x', 'c++', _SRC, '-o', str(out)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    lib.interp_tau_host.argtypes = [_I] + [_P] * 6 + [_I] * 4 + [_F] * 2
    lib.interp_tau_host.restype = _I
    lib.interp_tau_chunk.restype = _I
    lib.interp_tau_max_rows.restype = _I
    return lib


def _pt_grid():
    temps, pressures = default_pt_grid(_NT, _NP)
    return PTGrid(t_inv_grid=torch.tensor(1.0 / temps, dtype=torch.float32),
                  p_log_grid=torch.tensor(np.log10(pressures),
                                          dtype=torch.float32),
                  nc_p=torch.full((_NT,), _NP, dtype=torch.int32),
                  t_offset=torch.arange(_NT, dtype=torch.int32) * _NP)


def _profile(kind, nlayer, rng):
    """(idx [4, nlayer] int64, t_w, p_w) of a profile of the given kind."""
    if kind == 'smooth':
        t = np.linspace(300.0, 2600.0, nlayer)
        p = np.logspace(-5.5, 2.5, nlayer)
    elif kind == 'scattered':
        t, p = scattered_layers(_pt_grid(), nlayer, seed=int(rng.integers(99)))
    else:   # clamped: beyond the grid's edges, weights outside [0, 1]
        t = np.where(np.arange(nlayer) % 2 == 0, 70.0, 3450.0)
        p = np.where(np.arange(nlayer) % 3 == 0, 5e-7, 2e3)
    t_w, p_w, idx = _find_indices(_pt_grid(),
                                  torch.tensor(t, dtype=torch.float32),
                                  torch.tensor(p, dtype=torch.float32))
    if kind == 'clamped':
        idx = idx.clone()
        idx[:, 1::4] = idx[0, 1::4]          # one row in all four corners
        idx[2, 2::4] = idx[1, 2::4]          # two corners share a row
    return idx, t_w, p_w


def _inputs(kind, nlayer, nwno, nmol, seed):
    rng = np.random.default_rng(seed)
    log_kappa = torch.tensor(rng.uniform(-30.0, -18.0, (nmol, _NT * _NP,
                                                        nwno)),
                             dtype=torch.float32)
    mixcol = torch.tensor(rng.uniform(1e-6, 1e-3, (nmol, nlayer))
                          * rng.uniform(1.0, 100.0, nlayer),
                          dtype=torch.float32)
    idx, t_w, p_w = _profile(kind, nlayer, rng)
    return log_kappa, idx, t_w, p_w, mixcol


def _offset_copy(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    aligned address."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype)
    start = next(i for i in range(1, 17)
                 if (flat.data_ptr() + i * t.element_size()) % 16 == 4)
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def _run_host(lib, quant, table, idx, t_w, p_w, mixcol, qparams=None):
    nmol, npt, nwno = table.shape
    nlayer = idx.shape[1]
    idx32 = idx.to(torch.int32).contiguous()
    w4 = corner_weights(t_w, p_w).to(torch.float32).contiguous()
    mixcol = mixcol.to(torch.float32).contiguous()
    out = torch.full((nlayer, nwno), float('nan'))
    code = lib.interp_tau_host(
        quant, table.data_ptr(), idx32.data_ptr(), w4.data_ptr(),
        mixcol.data_ptr(), None if qparams is None else qparams.data_ptr(),
        out.data_ptr(), nmol, npt, nwno, nlayer, _LN10, LOG_AVO)
    assert code == 0
    return out


def _max_rel(a, b):
    a, b = a.double(), b.double()
    return ((a - b).abs() / b.abs().clamp(min=1e-300)).max().item()


# (nlayer, nwno, nmol, table 4 bytes past alignment)
_SHAPES = [(12, 1000, 3, False), (17, 1037, 16, False),
           (90, 1002, 1, False), (90, 1000, 16, False),
           (12, 1004, 3, False), (17, 1000, 3, True)]


@pytest.mark.parametrize('shape', _SHAPES, ids=lambda s: '-'.join(map(str, s)))
@pytest.mark.parametrize('profile', ['smooth', 'scattered', 'clamped'])
@pytest.mark.parametrize('kind', ['K1', 'K8'])
def test_host_gather_matches_twin(lib, kind, profile, shape):
    nlayer, nwno, nmol, offset = shape
    log_kappa, idx, t_w, p_w, mixcol = _inputs(profile, nlayer, nwno, nmol,
                                               seed=nlayer + nwno + nmol)
    if kind == 'K1':
        table = _offset_copy(log_kappa) if offset else log_kappa
        out = _run_host(lib, 0, table, idx, t_w, p_w, mixcol)
        ref = interp_tau_plain(log_kappa, idx, t_w, p_w, mixcol)
    else:
        q, qp = quantize_table(log_kappa)
        table = _offset_copy(q) if offset else q
        out = _run_host(lib, 1, table, idx, t_w, p_w, mixcol, qp)
        ref = interp_tau_q_plain(q, idx, t_w, p_w, mixcol, qp)
    assert ref.dtype == torch.float32 and ref.shape == (nlayer, nwno)
    assert torch.isfinite(out).all() and (out > 0).all()
    assert _max_rel(out, ref) <= 1e-6


@pytest.mark.parametrize('profile', ['smooth', 'scattered', 'clamped'])
def test_host_gather_profiles_cover_the_row_counts(lib, profile):
    """The scattered profile gives every chunk 4L distinct rows, more than
    a stage holds, so the kernels run it in passes; the smooth one fits a
    stage in one pass; the clamped one repeats rows inside a layer."""
    chunk, max_rows = lib.interp_tau_chunk(), lib.interp_tau_max_rows()
    assert 1 < chunk < 90 and 4 <= max_rows < 4 * chunk
    idx = _profile(profile, 90, np.random.default_rng(7))[0].numpy()
    rows = [len(np.unique(idx[:, l0:l0 + chunk]))
            for l0 in range(0, 90, chunk)]
    if profile == 'scattered':
        assert rows == [4 * min(chunk, 90 - l0) for l0 in range(0, 90, chunk)]
    elif profile == 'smooth':
        assert max(rows) <= max_rows
    else:
        assert any(len(np.unique(idx[:, j])) < 4 for j in range(90))


@pytest.mark.parametrize('chunk', [9, 15, 18, 30])
def test_scattered_layers_on_the_production_grid(chunk):
    """On the ragged 1060-point grid the scattered profile (the card tests'
    and chip_smoke's worst case) reads 4L distinct rows in each chunk."""
    pt = synthetic_opacity_grid_ragged(np.linspace(300.0, 33000.0, 8),
                                       ('H2O',), device='cpu').pt
    t, p = scattered_layers(pt, 90, seed=chunk)
    _, _, idx = _find_indices(pt, torch.tensor(t), torch.tensor(p))
    idx = idx.numpy()
    for l0 in range(0, 90, chunk):
        assert len(np.unique(idx[:, l0:l0 + chunk])) == 4 * min(chunk,
                                                                90 - l0)


def test_host_gather_refuses_other_quant(lib):
    log_kappa, idx, t_w, p_w, mixcol = _inputs('smooth', 12, 300, 2, 1)
    out = torch.zeros(12, 300)
    w4 = torch.zeros(4, 12)
    idx32 = idx.to(torch.int32)
    assert lib.interp_tau_host(
        2, log_kappa.data_ptr(), idx32.data_ptr(), w4.data_ptr(),
        mixcol.data_ptr(), None, out.data_ptr(), 2, _NT * _NP, 300, 12,
        _LN10, LOG_AVO) != 0
    assert torch.equal(out, torch.zeros(12, 300))
