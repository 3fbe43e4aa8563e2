"""Reference-data location.

Copy of ``picaso_tpu/refdata.py`` for the PyTorch port, which must not
import the JAX package: the small tables that ship with the repository
(``config.json``, Raman cross sections, cloud wavelength grids, base-case
profiles) are read by path from ``picaso_tpu/refdata``; larger artifacts
(opacity databases, stellar grids) live wherever the ``picaso_refdata`` /
``picaso_tpu_refdata`` environment variable points, in the reference
distribution's layout, and are preferred when present.
"""

from __future__ import annotations

import json
import os

__all__ = ['refdata_path', 'bundled_refdata', 'external_refdata',
           'load_default_config']

_BUNDLED = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    'picaso_tpu', 'refdata')


def bundled_refdata() -> str:
    return _BUNDLED


def external_refdata():
    """User-pointed refdata dir (reference-compatible layout), or None."""
    return (os.environ.get('picaso_tpu_refdata')
            or os.environ.get('picaso_refdata'))


def refdata_path(*parts) -> str:
    """Resolve a refdata-relative path, preferring the external dir."""
    ext = external_refdata()
    if ext is not None:
        p = os.path.join(ext, *parts)
        if os.path.exists(p):
            return p
    p = os.path.join(_BUNDLED, *parts)
    if os.path.exists(p):
        return p
    raise FileNotFoundError(
        f'reference data {"/".join(parts)} not found in '
        f'{ext or "(no external refdata set)"} or bundled {_BUNDLED}')


def load_default_config() -> dict:
    """The master default configuration tree (reference config.json layout)."""
    with open(refdata_path('config.json')) as f:
        return json.load(f)
