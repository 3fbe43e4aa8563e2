"""Minimal NetCDF reader/writer (xarray-free).

Copy of ``picaso_tpu/ncio.py`` for the PyTorch port, which must not import
the JAX package.  Classic NetCDF (the ``CDF`` magic bytes, e.g. the bundled
WASP-17b transmission spectrum) is read with ``scipy.io.netcdf_file``;
NetCDF-4 files are HDF5 files with a dimension-scale convention, read and
written over h5py, which is imported only when such a file is met (a
classic file needs no h5py).

The NetCDF-4 convention (what xarray/netcdf4-python emits):
  - each dimension is an HDF5 "dimension scale" dataset
    (CLASS='DIMENSION_SCALE', NAME=<dimension name>); when a scale holds
    real values it is simultaneously the coordinate variable;
  - every data variable carries a DIMENSION_LIST attribute of object
    references to its scales;
  - attributes are plain HDF5 attributes (strings often json-encoded);
  - the root carries a '_NCProperties' provenance string.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ['NCVar', 'NCDataset', 'read_netcdf', 'write_netcdf',
           'gcm_dict']

_PHONY = 'This is a netCDF dimension but not a netCDF variable.'


class NCVar(NamedTuple):
    """One variable: values + dimension names + attributes."""
    values: np.ndarray
    dims: tuple
    attrs: dict


class NCDataset(NamedTuple):
    """A decoded NetCDF file: xarray.Dataset-shaped, stdlib types only."""
    data_vars: dict     # name -> NCVar
    coords: dict        # name -> NCVar (1-d, name == its dimension)
    attrs: dict
    dims: dict          # name -> length

    def __getitem__(self, name):
        if name in self.data_vars:
            return self.data_vars[name]
        return self.coords[name]

    def __contains__(self, name):
        return name in self.data_vars or name in self.coords

    def keys(self):
        return self.data_vars.keys()


def _decode(v):
    if isinstance(v, bytes):
        return v.decode('utf-8', 'replace')
    if isinstance(v, np.bytes_):
        return bytes(v).decode('utf-8', 'replace')
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray) and v.size == 1:
        return _decode(v.reshape(())[()])
    return v


def _clean_attrs(h5attrs):
    skip = {'DIMENSION_LIST', 'REFERENCE_LIST', 'CLASS', 'NAME',
            '_Netcdf4Dimid', '_Netcdf4Coordinates', '_NCProperties',
            '_FillValue'}
    return {k: _decode(v) for k, v in h5attrs.items() if k not in skip}


def _h5py(path):
    """The h5py module, imported for a NetCDF-4 (HDF5) file; an
    ImportError naming ``path`` where it is not installed."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError(f'{path} is a NetCDF-4 (HDF5) file: reading or '
                          'writing it needs h5py, which is not '
                          'installed') from err
    return h5py


def read_netcdf(path, group='/'):
    """Read a NetCDF file into NCDataset.

    Classic NetCDF (CDF-1/2/5 magic, the format of many community
    datasets, e.g. the bundled WASP-17 transmission spectrum) goes through
    scipy.io.netcdf_file, told apart by its first bytes before h5py is
    imported; NetCDF-4 (HDF5-with-scales) is parsed over h5py.
    """
    with open(path, 'rb') as fh:
        magic = fh.read(3)
    if magic == b'CDF':
        return _read_netcdf_classic(path)
    h5py = _h5py(path)

    with h5py.File(path, 'r') as f:
        root = f[group]
        scales = {}
        variables = {}
        for name, obj in root.items():
            if not isinstance(obj, h5py.Dataset):
                continue
            cls = obj.attrs.get('CLASS')
            if cls is not None and _decode(cls) == 'DIMENSION_SCALE':
                nm = _decode(obj.attrs.get('NAME', name))
                phony = isinstance(nm, str) and nm.startswith(_PHONY[:20])
                scales[name] = (None if phony else np.asarray(obj[()]),
                                _clean_attrs(obj.attrs), obj.shape[0])
            else:
                variables[name] = obj

        def dim_names(ds):
            out = []
            if 'DIMENSION_LIST' in ds.attrs:
                for refs in ds.attrs['DIMENSION_LIST']:
                    ref = refs[0] if len(refs) else None
                    out.append(f[ref].name.rsplit('/', 1)[-1]
                               if ref else None)
            else:
                out = [None] * ds.ndim
            return tuple(d if d is not None else f'dim_{i}'
                         for i, d in enumerate(out))

        data_vars = {}
        for name, ds in variables.items():
            data_vars[name] = NCVar(np.asarray(ds[()]), dim_names(ds),
                                    _clean_attrs(ds.attrs))
        coords = {}
        dims = {}
        for name, (vals, attrs, length) in scales.items():
            dims[name] = length
            if vals is not None:
                coords[name] = NCVar(vals, (name,), attrs)
        return NCDataset(data_vars, coords, _clean_attrs(f.attrs), dims)


def _read_netcdf_classic(path):
    """Classic (CDF) NetCDF via scipy.io.netcdf_file -> NCDataset."""
    from scipy.io import netcdf_file

    with netcdf_file(path, 'r', mmap=False) as f:
        dims = {k: (v if v is not None else 0)
                for k, v in f.dimensions.items()}
        data_vars, coords = {}, {}
        for name, var in f.variables.items():
            vals = np.asarray(var.data)
            attrs = _clean_attrs({k: v for k, v in var._attributes.items()})
            nc = NCVar(vals, tuple(var.dimensions), attrs)
            if var.dimensions == (name,):
                coords[name] = nc
            else:
                data_vars[name] = nc
        attrs = _clean_attrs({k: v for k, v in f._attributes.items()})
    return NCDataset(data_vars, coords, attrs, dims)


def write_netcdf(path, data_vars, coords=None, attrs=None):
    """Write a NetCDF-4-convention file readable by xarray/netcdf4.

    data_vars : dict name -> (dims tuple, values, attrs dict) or NCVar
    coords : dict name -> values or (values, attrs); each coordinate IS
        its dimension (1-d, length defines the dim).
    attrs : global attributes (dicts are json-encoded, as the reference's
        output_xarray does for planet_params etc.).
    """
    import json

    h5py = _h5py(path)
    coords = coords or {}
    attrs = attrs or {}

    def norm(v):
        if isinstance(v, NCVar):
            return v
        if isinstance(v, tuple) and len(v) in (2, 3) and isinstance(
                v[0], (tuple, list)):
            dims, values = v[0], v[1]
            a = v[2] if len(v) == 3 else {}
            return NCVar(np.asarray(values), tuple(dims), dict(a))
        raise TypeError('data_vars values must be NCVar or '
                        '(dims, values[, attrs])')

    data_vars = {k: norm(v) for k, v in data_vars.items()}

    with h5py.File(path, 'w') as f:
        dimid = 0
        scale_ds = {}
        for name, v in coords.items():
            vals, cattrs = (v if isinstance(v, tuple) else (v, {}))
            ds = f.create_dataset(name, data=np.asarray(vals))
            ds.make_scale(name)
            ds.attrs['_Netcdf4Dimid'] = np.int32(dimid)
            for k, a in cattrs.items():
                ds.attrs[k] = a
            scale_ds[name] = ds
            dimid += 1
        # dims used by variables but lacking a coordinate get phony scales
        for var in data_vars.values():
            for d, n in zip(var.dims, var.values.shape):
                if d not in scale_ds:
                    ds = f.create_dataset(d, data=np.arange(n, dtype='f4'))
                    ds.make_scale(_PHONY)
                    ds.attrs['_Netcdf4Dimid'] = np.int32(dimid)
                    scale_ds[d] = ds
                    dimid += 1
        for name, var in data_vars.items():
            ds = f.create_dataset(name, data=np.asarray(var.values))
            for axis, d in enumerate(var.dims):
                ds.dims[axis].attach_scale(scale_ds[d])
            for k, a in var.attrs.items():
                ds.attrs[k] = json.dumps(a) if isinstance(a, dict) else a
        for k, a in attrs.items():
            f.attrs[k] = json.dumps(a) if isinstance(a, dict) else a
        f.attrs['_NCProperties'] = np.bytes_(
            b'version=2,netcdf=4.9.2,hdf5=1.14.3')
    return path


def gcm_dict(path_or_ds):
    """Convert an xarray-convention GCM NetCDF (the reference's
    atmosphere_3d/_4d + clouds_4d input format, justdoit.py:3414) into
    the plain-dict layout justdoit.atmosphere_3d consumes.

    Coordinates lat/lon (degrees) and pressure (bar) — plus wno for cloud
    files — are read from the dimension scales; every data variable is
    transposed to [pressure(, wno), lon, lat] regardless of its stored
    dimension order.
    """
    ds = (read_netcdf(path_or_ds) if isinstance(path_or_ds, (str, bytes))
          else path_or_ds)
    alias = {'latitude': 'lat', 'longitude': 'lon', 'lat': 'lat',
             'lon': 'lon', 'pressure': 'pressure', 'wno': 'wno',
             'wavenumber': 'wno'}
    coord_names = {}
    for name in ds.coords:
        key = alias.get(name)
        if key:
            coord_names[key] = name
    missing = {'lat', 'lon', 'pressure'} - set(coord_names)
    if missing:
        raise ValueError(f'GCM file lacks coordinates: {sorted(missing)}')
    out = {k: np.asarray(ds.coords[v].values, np.float64)
           for k, v in coord_names.items()}
    if 'wno' in out:
        out['wavenumber'] = out.pop('wno')
    for name, var in ds.data_vars.items():
        dims = list(var.dims)
        order = [d for d in (coord_names['pressure'],
                             coord_names.get('wno'),
                             coord_names['lon'], coord_names['lat'])
                 if d in dims]
        if len(order) != len(dims):
            continue   # not a gridded field (e.g. aux scalars)
        out[name] = np.transpose(var.values,
                                 [dims.index(d) for d in order])
    return out
