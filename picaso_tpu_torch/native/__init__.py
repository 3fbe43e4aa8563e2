"""Native (C++) opacity-database decode, built on demand.

Port of ``picaso_tpu/native`` (``__init__.py`` and ``fastload.cpp``, whose
copy sits beside this file): a small C++ library compiled on first use
with the system g++ against the system libsqlite3 and bound through
ctypes.  It decodes the numpy ``.npy`` blobs of a reference-schema sqlite
database with one connection per molecule thread and fuses the
resample, the wavenumber window and the log10 into the decode.  It is a
host library, not a GPU kernel: :func:`picaso_tpu_torch.opacities.db.
load_opacity_db` uses it for float32 loads and moves the arrays to the
device afterwards.

Two changes from the JAX module: the library is built into the package's
build directory (``build/picaso_tpu_torch/native/<hash of the source and
flags>/``, as ``_build.py`` builds the CUDA kernels) instead of beside
the source, and a failed build or load is not swallowed silently:
:func:`unavailable_reason` says why, and the loader warns with it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

import numpy as np

from .._build import _BUILD_ROOT

__all__ = ['available', 'unavailable_reason', 'load_molecular',
           'load_continuum', 'build', 'FLAGS']

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    'fastload.cpp')
# no -ffast-math: the loader's output is bitwise the Python decode's
FLAGS = ('-O3', '-std=c++17', '-march=native', '-fopenmp-simd', '-shared',
         '-fPIC')
_lock = threading.Lock()
_lib = None
_reason = None


def _find_sqlite():
    for pat in ('/lib/x86_64-linux-gnu/libsqlite3.so*',
                '/usr/lib/x86_64-linux-gnu/libsqlite3.so*',
                '/usr/lib/libsqlite3.so*'):
        hits = sorted(glob.glob(pat))
        if hits:
            return hits[0]
    return None


def build(force=False):
    """Compile fastload.cpp into the build directory; returns the .so
    path.  Raises RuntimeError when libsqlite3 is missing,
    FileNotFoundError when g++ is, CalledProcessError when it fails."""
    sqlite = _find_sqlite()
    if sqlite is None:
        raise RuntimeError('libsqlite3 shared library not found')
    with open(_SRC, 'rb') as f:
        key = hashlib.sha256(f.read() + repr((FLAGS, sqlite)).encode())
    out_dir = os.path.join(_BUILD_ROOT, 'native', key.hexdigest()[:16])
    so = os.path.join(out_dir, '_fastload.so')
    if os.path.exists(so) and not force:
        return so
    os.makedirs(out_dir, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    subprocess.run(['g++', *FLAGS, _SRC, sqlite, '-lpthread', '-o', tmp],
                   check=True, capture_output=True, text=True)
    os.replace(tmp, so)
    return so


def _load():
    """The bound library, or None with the reason kept (a missing g++ or
    libsqlite3, a failed compile, a library that does not load)."""
    global _lib, _reason
    with _lock:
        if _lib is not None or _reason is not None:
            return _lib
        try:
            lib = ctypes.CDLL(build())
        except subprocess.CalledProcessError as e:
            _reason = f'g++ failed: {e.stderr.strip()[-500:]}'
            return None
        except (RuntimeError, OSError) as e:
            _reason = f'{type(e).__name__}: {e}'
            return None
        lib.fastload_molecular.restype = ctypes.c_int
        lib.fastload_molecular.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
        lib.fastload_continuum.restype = ctypes.c_int
        lib.fastload_continuum.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available():
    """True when the native loader can be built and loaded here."""
    return _load() is not None


def unavailable_reason():
    """Why the library cannot be used (None when it can)."""
    _load()
    return _reason


def _cstrs(names):
    arr = (ctypes.c_char_p * len(names))()
    keep = [n.encode() for n in names]
    arr[:] = keep
    return arr, keep


def load_molecular(db_path, molecules, npt, loc, resample=1):
    """log10-opacity cube [nmol, npt, nloc] float32 (fill -50) via the
    C++ path; None when the library is unavailable.  Raises RuntimeError
    on a decode error (schema or blob-format mismatch)."""
    lib = _load()
    if lib is None:
        return None
    loc = np.ascontiguousarray(loc, dtype=np.int64)
    out = np.full((len(molecules), npt, len(loc)), -50.0, dtype=np.float32)
    names, keep = _cstrs(molecules)
    rc = lib.fastload_molecular(
        os.fsencode(db_path), names, len(molecules), npt,
        loc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(loc),
        int(resample), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f'fastload_molecular failed (code {rc})')
    return out


def load_continuum(db_path, molecules, cia_temps, loc, resample=1):
    """Continuum cube [nmol, ntemp, nloc] float32; None when the library
    is unavailable; raises RuntimeError on a decode error."""
    lib = _load()
    if lib is None:
        return None
    loc = np.ascontiguousarray(loc, dtype=np.int64)
    temps = np.ascontiguousarray(cia_temps, dtype=np.float64)
    out = np.zeros((len(molecules), len(temps), len(loc)), dtype=np.float32)
    names, keep = _cstrs(molecules)
    rc = lib.fastload_continuum(
        os.fsencode(db_path), names, len(molecules),
        temps.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(temps),
        loc.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(loc),
        int(resample), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise RuntimeError(f'fastload_continuum failed (code {rc})')
    return out
