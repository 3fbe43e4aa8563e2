"""Minimal read-only FITS parser (pure numpy, no astropy).

Copy of ``picaso_tpu/fits_lite.py`` for the PyTorch port, which must not
import the JAX package.  Keep the two in step.

Supports exactly what the bundled stellar-grid artifacts need (the
STScI PHOENIX / Castelli-Kurucz ck04models trees referenced by data.py
and justdoit.star): primary headers, IMAGE extensions with numeric
data, and BINTABLE extensions with E/D/J/I/A/B columns.  FITS layout:
2880-byte logical records, 80-char header cards, big-endian binary
data (NASA FITS 4.0 standard sections 3-7).
"""

from __future__ import annotations

import numpy as np

__all__ = ['read_fits']

_BLOCK = 2880

_TFORM_DTYPES = {
    'L': '>i1', 'B': '>u1', 'I': '>i2', 'J': '>i4', 'K': '>i8',
    'E': '>f4', 'D': '>f8',
}

_BITPIX_DTYPES = {8: '>u1', 16: '>i2', 32: '>i4', 64: '>i8',
                  -32: '>f4', -64: '>f8'}


def _parse_header(buf, pos):
    """Return (dict, new_pos) for one header unit starting at pos."""
    hdr = {}
    while True:
        block = buf[pos:pos + _BLOCK]
        if len(block) < _BLOCK:
            raise ValueError('truncated FITS header')
        pos += _BLOCK
        done = False
        for i in range(0, _BLOCK, 80):
            card = block[i:i + 80].decode('ascii', errors='replace')
            key = card[:8].strip()
            if key == 'END':
                done = True
                break
            if not key or card[8] != '=':
                continue
            val = card[10:]
            if '/' in val and not val.lstrip().startswith("'"):
                val = val.split('/')[0]
            val = val.strip()
            if val.startswith("'"):
                hdr[key] = val.strip("'").strip()
            elif val in ('T', 'F'):
                hdr[key] = val == 'T'
            else:
                try:
                    hdr[key] = int(val)
                except ValueError:
                    try:
                        hdr[key] = float(val)
                    except ValueError:
                        hdr[key] = val
        if done:
            return hdr, pos


def _data_size(hdr):
    naxis = hdr.get('NAXIS', 0)
    if naxis == 0:
        return 0, ()
    shape = tuple(hdr[f'NAXIS{i}'] for i in range(naxis, 0, -1))
    n = abs(hdr['BITPIX']) // 8
    for s in shape:
        n *= s
    return n, shape


def _parse_bintable(hdr, raw):
    nrows = hdr['NAXIS2']
    nfields = hdr['TFIELDS']
    names, dtypes = [], []
    for i in range(1, nfields + 1):
        name = str(hdr.get(f'TTYPE{i}', f'col{i}'))
        tform = str(hdr[f'TFORM{i}']).strip()
        j = 0
        while j < len(tform) and tform[j].isdigit():
            j += 1
        repeat = int(tform[:j]) if j else 1
        code = tform[j]
        if code == 'A':
            dt = (f'S{repeat}',)
        elif code in _TFORM_DTYPES:
            dt = ((_TFORM_DTYPES[code], (repeat,)) if repeat > 1
                  else (_TFORM_DTYPES[code],))
        else:
            raise ValueError(f'unsupported TFORM {tform!r}')
        names.append(name)
        dtypes.append(dt)
    rec = np.dtype({'names': names,
                    'formats': [d[0] if len(d) == 1 else d for d in dtypes]})
    if rec.itemsize != hdr['NAXIS1']:
        raise ValueError(f'row size mismatch: dtype {rec.itemsize} vs '
                         f'NAXIS1 {hdr["NAXIS1"]}')
    table = np.frombuffer(raw[:rec.itemsize * nrows], dtype=rec)
    out = {}
    for name in names:
        col = table[name]
        if col.dtype.kind == 'S':
            out[name] = np.array([v.decode('ascii').strip() for v in col])
        else:
            out[name] = col.astype(col.dtype.newbyteorder('='))
    return out


def read_fits(path):
    """Read a FITS file into a list of (header_dict, data) HDUs.

    IMAGE HDUs give ndarray data (native byte order); BINTABLE HDUs give
    a dict of column name -> ndarray.  Empty data units give None.
    """
    with open(path, 'rb') as f:
        buf = f.read()
    hdus = []
    pos = 0
    while pos < len(buf):
        hdr, pos = _parse_header(buf, pos)
        nbytes, shape = _data_size(hdr)
        raw = buf[pos:pos + nbytes]
        pos += -(-nbytes // _BLOCK) * _BLOCK if nbytes else 0
        if hdr.get('XTENSION', '').startswith('BINTABLE'):
            data = _parse_bintable(hdr, raw)
        elif nbytes:
            dt = np.dtype(_BITPIX_DTYPES[hdr['BITPIX']])
            data = np.frombuffer(raw, dtype=dt).reshape(shape).astype(
                dt.newbyteorder('='))
            if 'BSCALE' in hdr or 'BZERO' in hdr:
                data = data * hdr.get('BSCALE', 1.0) + hdr.get('BZERO', 0.0)
        else:
            data = None
        hdus.append((hdr, data))
    return hdus
