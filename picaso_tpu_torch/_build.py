"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with :mod:`ctypes`.  No
PyTorch header is included, so the build takes seconds, not minutes.  The
library lands in ``build/picaso_tpu_torch/<hash of sources and flags>/``
beside the package, so an edited source is rebuilt and an unchanged one
is loaded from disk.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a nonzero code.

``-fmad=false`` keeps nvcc from contracting a*b+c into one fused
multiply-add: every operation is then rounded on its own, as in the eager
PyTorch twins the kernels are held against (no ``-use_fast_math``).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess

__all__ = ['library', 'check', 'kernel_wrappers', 'NVCC_FLAGS']

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD_ROOT = os.path.join(os.path.dirname(_PKG), 'build', 'picaso_tpu_torch')

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-fmad=false')

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# argument types of every C entry point in csrc/
_SIGNATURES = {
    # log_kappa, idx, w4, mixcol, out, nmol, npt, nwno, nlayer, ln10,
    # log_avo, stream
    'interp_tau_launch': [_P] * 5 + [_I] * 4 + [_F] * 2 + [_P],
    # q, idx, w4, mixcol, qparams, out, nmol, npt, nwno, nlayer, ln10,
    # log_avo, stream
    'interp_tau_q_launch': [_P] * 6 + [_I] * 4 + [_F] * 2 + [_P],
    # log_kappa, idx, w4, mixcol, out, nmol, npt, nwno, nlayer, ln10,
    # log_avo, stream (probes/gather_probe.py)
    'interp_tau_layer_inner_launch': [_P] * 5 + [_I] * 4 + [_F] * 2 + [_P],
    # b, c, d, out, nlayer, ncol, staged, tile, stream
    # (probes/sweep_layout_probe.py)
    'sweep_layout_launch': [_P] * 4 + [_I] * 4 + [_P],
    # all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect,
    # F0PI, ubar0, ubar1, cos_theta, ptfac, xint, thermal, scratch,
    # nlayer, nwno, nang, single_phase, multi_phase, toon_coefficients,
    # frac_a, frac_b, frac_c, constant_back, constant_forward, b_top,
    # stream, delta_eddington, hard_surface, stage (0: A, 1: B), cuda stream
    'toon_spectrum_launch': [_P] * 16 + [_I] * 6 + [_F] * 6
                            + [_I] * 4 + [_P],
    # taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect, F0PI,
    # ubar0, ubar1, cos_theta, xint, scratch, nlayer, nwno, nang,
    # single_phase, multi_phase, toon_coefficients, frac_a, frac_b, frac_c,
    # constant_back, constant_forward, b_top, stream, delta_eddington,
    # stage, cuda stream
    'toon_reflected_launch': [_P] * 13 + [_I] * 6 + [_F] * 6 + [_I] * 3
                             + [_P],
    # all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, ptfac, surf_reflect,
    # ubar1, thermal, scratch, nlayer, nwno, nang, hard_surface,
    # stage (0: A, 1: B), cuda stream
    'toon_thermal_launch': [_P] * 11 + [_I] * 5 + [_P],
    # dtau, tau, w0, cosb, gcos2, ftau_cld, ftau_ray, dtau_og, tau_og,
    # w0_og, cosb_og, surf_reflect, F0PI, ubar0, ubar1, cos_theta, xint,
    # scratch, nlayer, nwno, nang, single_phase, multi_phase,
    # toon_coefficients, frac_a, frac_b, frac_c, constant_back,
    # constant_forward, b_top, stage, cuda stream
    'toon_reflected_props_launch': [_P] * 18 + [_I] * 6 + [_F] * 6 + [_I]
                                   + [_P],
    # all_b, dtau, w0, cosb, tau_top, surf_reflect, ubar1, thermal, scratch,
    # nlayer, nwno, nang, hard_surface, stage (0: A, 1: B), cuda stream
    'toon_thermal_props_launch': [_P] * 9 + [_I] * 5 + [_P],
    # number of [nlayer + 1, nwno] scratch slots each Toon kernel expects
    # at nang disk angles
    'toon_spectrum_scratch_slots': [_I],
    'toon_reflected_scratch_slots': [_I],
    'toon_thermal_scratch_slots': [_I],
    # stream, taugas, tauray, cld_opd, cld_w0, cld_g0, rf, surf_reflect,
    # F0PI, ubar0, ubar1, cos_theta, out, scratch, nlayer, nwno, nang,
    # delta_eddington, w_single_form, w_multi_form, psingle_form,
    # w_single_rayleigh, w_multi_rayleigh, psingle_rayleigh, single_form,
    # frac_a, frac_b, frac_c, constant_back, constant_forward, b_top,
    # constant_forward**stream, constant_back**stream, stage (0: A, 1: B),
    # cuda stream
    'sh_reflected_launch': [_I] + [_P] * 13 + [_I] * 11 + [_F] * 8 + [_I]
                           + [_P],
    # stream, all_b, taugas, tauray, cld_opd, cld_w0, cld_g0, rf,
    # surf_reflect, ubar1, ptfac, out, scratch, nlayer, nwno, nang,
    # delta_eddington, hard_surface, stage (0: A, 1: B), cuda stream
    'sh_thermal_launch': [_I] + [_P] * 12 + [_I] * 6 + [_P],
    # scratch slots of the SH kernels: (stream, nang) and (stream); the
    # length of a slot's rows (nwno)
    'sh_reflected_scratch_slots': [_I, _I],
    'sh_thermal_scratch_slots': [_I],
    'sh_scratch_row': [_I],
}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME/bin): the CUDA '
                       'kernels of picaso_tpu_torch cannot be built')


def _sources():
    return sorted(glob.glob(os.path.join(_CSRC, '*.cu'))
                  + glob.glob(os.path.join(_CSRC, '*.cuh')))


def _digest(paths):
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile ``csrc/*.cu`` if the library for these sources is missing;
    return its path.  Each source compiles in its own ``nvcc`` process, all
    started together, then one link; ptxas's register and spill report
    (``-Xptxas -v``) is kept in ``ptxas.log`` beside the library.  A
    missing nvcc or a failed build raises with the compiler's output."""
    paths = _sources()
    out_dir = os.path.join(_BUILD_ROOT, _digest(paths))
    lib = os.path.join(out_dir, 'libpicaso_kernels.so')
    if os.path.exists(lib):
        return lib
    os.makedirs(out_dir, exist_ok=True)
    tag = f'{os.getpid()}.tmp'
    nvcc = _nvcc()
    jobs = []
    for src in (p for p in paths if p.endswith('.cu')):
        obj = os.path.join(out_dir, f'{os.path.basename(src)}.{tag}.o')
        cmd = [nvcc, *(f for f in NVCC_FLAGS if f != '-shared'), '-Xptxas',
               '-v', '-c', '-o', obj, src]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}): '
                               f'{" ".join(cmd)}\n{out}\n{err}')
        logs.append(f'{cmd[-1]}\n{out}{err}')
    tmp = f'{lib}.{tag}'
    cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, *[obj for _, obj, _ in jobs]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for _, obj, _ in jobs:
        os.remove(obj)
    if res.returncode != 0:
        raise RuntimeError(f'nvcc failed ({res.returncode}): {" ".join(cmd)}'
                           f'\n{res.stdout}\n{res.stderr}')
    with open(os.path.join(out_dir, 'ptxas.log'), 'w') as f:
        f.write('\n'.join(logs))
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built on first use), argtypes set."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(code, name):
    """Raise if a launch returned a nonzero cudaError_t."""
    if code != 0:
        raise RuntimeError(f'{name}: CUDA error {code} at launch')


def kernel_wrappers():
    """{name: wrapper} of every hand-written kernel's Python wrapper; each
    adds one to its ``.launches`` where it launches its kernel and nowhere
    else (its twin, on CPU tensors, counts nothing)."""
    from .opacities import cuda_interp
    from .probes import gather_probe, sweep_layout_probe
    from .rt import cuda_sh, cuda_toon
    return {
        'interp_tau': cuda_interp.interp_tau,
        'interp_tau_q': cuda_interp.interp_tau_q,
        **{name: getattr(cuda_toon, name) for name in (
            'spectrum_toon', 'reflected_toon', 'thermal_toon',
            'reflected_toon_props', 'thermal_toon_props')},
        **{name: getattr(cuda_sh, name) for name in (
            'reflected_sh4', 'thermal_sh4', 'reflected_sh2', 'thermal_sh2')},
        'interp_tau_layer_inner': gather_probe.interp_tau_layer_inner,
        'sweep_rows': sweep_layout_probe.sweep_rows,
        'sweep_staged': sweep_layout_probe.sweep_staged}
