"""Build 3D (GCM) inputs on the Gauss-Chebyshev disco grid.

Copy of ``picaso_tpu/build_3d_input.py`` for the PyTorch port, which must
not import the JAX package (numpy over ``ncio.NCDataset``; the facet
coordinates from the port's ``disco.make_geometry``).  As there, no
xarray/xesmf: GCM cubes come in as plain arrays (or MITgcm-style flat
text files) and are regridded to the disk-integration facet coordinates
by bilinear lat/lon interpolation.  The outputs feed
``justdoit.inputs.atmosphere_3d`` / ``clouds_3d`` and
``three_d.picaso_3d``.
"""

from __future__ import annotations

import numpy as np

from . import disco as disco_mod

__all__ = ['regrid_xarray', 'regrid_to_gauss_cheby', 'rebin_mitgcm_pt',
           'rebin_mitgcm_cld', 'make_3d_pt_input', 'make_3d_cld_input',
           'synthetic_gcm', 'write_mitgcm_pt', 'write_mitgcm_cld']


def _wrap_longitude(src_lon, lon_t, vals, lon_axis=-2):
    """Periodic-longitude handling for a global source grid.

    GCM grids commonly span [0, 360) while disco facet longitudes come
    out of make_geometry in [-180, 180]: map the targets into the
    source's window modulo 360 and append a wrap column (src_lon[0]+360,
    data of column 0) so interpolation crosses the anti-meridian instead
    of clamping to the seam edge (the reference's xesmf path is periodic,
    build_3d_input.py:12).  Limited-area grids (span well below 360) are
    left alone.  Returns (src_lon, lon_t, vals)."""
    src_lon = np.asarray(src_lon, float)
    lon_t = np.asarray(lon_t, float)
    step = np.median(np.abs(np.diff(src_lon))) if len(src_lon) > 1 else 0.0
    if 360.0 - (src_lon.max() - src_lon.min()) > 2.5 * step:
        return src_lon, lon_t, vals            # not a global grid
    lon_t = src_lon.min() + np.mod(lon_t - src_lon.min(), 360.0)
    src_lon = np.concatenate([src_lon, src_lon[:1] + 360.0])
    first = np.take(vals, [0], axis=lon_axis)
    vals = np.concatenate([vals, first], axis=lon_axis)
    return src_lon, lon_t, vals


def regrid_xarray(dataset, num_gangle=None, num_tangle=None,
                  phase_angle=None, latitude=None, longitude=None):
    """Regrid a GCM dataset onto disco facet coordinates
    (build_3d_input.py:12-62, without the xesmf dependency).

    ``dataset`` is an ncio Dataset (read_netcdf), an xarray Dataset, or
    any mapping of name -> array-with-``dims`` whose spatial dims are
    named lat/lon (or latitude/longitude).  Supply either
    (num_gangle, num_tangle, phase_angle) to target the Gauss-Chebyshev
    grid, or explicit latitude/longitude arrays [degrees].  Returns a
    dict {'latitude': deg, 'longitude': deg, <var>: regridded array}.
    """
    coords = getattr(dataset, 'coords', {})

    def coord(*names):
        for n in names:
            if n in coords:
                v = coords[n]
                return np.asarray(getattr(v, 'values', v))
        raise KeyError(f'dataset has no coordinate named any of {names}')

    src_lat = coord('lat', 'latitude')
    src_lon = coord('lon', 'longitude')

    if num_gangle is not None and num_tangle is not None:
        geom = disco_mod.make_geometry(phase_angle or 0.0,
                                       num_gangle=num_gangle,
                                       num_tangle=num_tangle)
        latitude = np.degrees(geom.latitude)
        longitude = np.degrees(geom.longitude)
    elif latitude is None or longitude is None:
        raise ValueError('supply (num_gangle, num_tangle, phase_angle) '
                         'or explicit latitude/longitude arrays')

    out = {'latitude': np.asarray(latitude),
           'longitude': np.asarray(longitude)}
    spatial = {'lat', 'latitude', 'lon', 'longitude'}
    for name, var in dataset.data_vars.items():
        dims = tuple(getattr(var, 'dims', ()))
        if not (spatial & set(dims)):
            continue
        vals = np.asarray(getattr(var, 'values', var))
        # move (lon, lat) to the trailing axes regrid_to_gauss_cheby expects
        lon_ax = next(i for i, d in enumerate(dims)
                      if d in ('lon', 'longitude'))
        lat_ax = next(i for i, d in enumerate(dims)
                      if d in ('lat', 'latitude'))
        vals = np.moveaxis(vals, (lon_ax, lat_ax), (-2, -1))
        src_lon_v, lon_tgt, vals = _wrap_longitude(src_lon,
                                                   out['longitude'], vals)
        idx_hi_lon = np.clip(np.searchsorted(src_lon_v, lon_tgt),
                             1, len(src_lon_v) - 1)
        idx_hi_lat = np.clip(np.searchsorted(src_lat, out['latitude']),
                             1, len(src_lat) - 1)
        lo_lon, lo_lat = idx_hi_lon - 1, idx_hi_lat - 1
        w_lon = np.clip((lon_tgt - src_lon_v[lo_lon])
                        / (src_lon_v[idx_hi_lon] - src_lon_v[lo_lon]), 0, 1)
        w_lat = np.clip((out['latitude'] - src_lat[lo_lat])
                        / (src_lat[idx_hi_lat] - src_lat[lo_lat]), 0, 1)
        c_ll = vals[..., lo_lon[:, None], lo_lat[None, :]]
        c_hl = vals[..., idx_hi_lon[:, None], lo_lat[None, :]]
        c_lh = vals[..., lo_lon[:, None], idx_hi_lat[None, :]]
        c_hh = vals[..., idx_hi_lon[:, None], idx_hi_lat[None, :]]
        wl = w_lon[:, None]
        wt = w_lat[None, :]
        out[name] = ((1 - wl) * (1 - wt) * c_ll + wl * (1 - wt) * c_hl
                     + (1 - wl) * wt * c_lh + wl * wt * c_hh)
    return out


def regrid_to_gauss_cheby(lat, lon, cube, num_gangle=10, num_tangle=10,
                          phase=0.0):
    """Interpolate a [..., nlon, nlat] cube onto disco facet coordinates.

    Returns (geometry, regridded [..., ng, nt]).  Replaces the xesmf path
    of build_3d_input.regrid_xarray (build_3d_input.py:12).
    """
    geom = disco_mod.make_geometry(phase, num_gangle=num_gangle,
                                   num_tangle=num_tangle)
    lat_t = np.degrees(geom.latitude)
    lon_t = np.degrees(geom.longitude)
    lat = np.asarray(lat)
    lon = np.asarray(lon)
    cube = np.asarray(cube)
    lon, lon_t, cube = _wrap_longitude(lon, lon_t, cube)

    def interp1(grid, targets, axis_vals):
        idx_hi = np.clip(np.searchsorted(axis_vals, targets), 1,
                         len(axis_vals) - 1)
        idx_lo = idx_hi - 1
        w = ((targets - axis_vals[idx_lo])
             / (axis_vals[idx_hi] - axis_vals[idx_lo]))
        return idx_lo, idx_hi, np.clip(w, 0, 1)

    lo_lon, hi_lon, w_lon = interp1(None, lon_t, lon)
    lo_lat, hi_lat, w_lat = interp1(None, lat_t, lat)
    # bilinear over the last two axes
    c_ll = cube[..., lo_lon[:, None], lo_lat[None, :]]
    c_hl = cube[..., hi_lon[:, None], lo_lat[None, :]]
    c_lh = cube[..., lo_lon[:, None], hi_lat[None, :]]
    c_hh = cube[..., hi_lon[:, None], hi_lat[None, :]]
    wl = w_lon[:, None]
    wt = w_lat[None, :]
    out = ((1 - wl) * (1 - wt) * c_ll + wl * (1 - wt) * c_hl
           + (1 - wl) * wt * c_lh + wl * wt * c_hh)
    return geom, out


def rebin_mitgcm_pt(filename, num_gangle=10, num_tangle=10, phase=0.0,
                    n_hdr=0):
    """Read a flat MITgcm PT dump and regrid (build_3d_input.py:64).

    Expected columns: lon, lat, pressure(bar), temperature(K) [, kzz],
    grouped by column (all levels of one (lon, lat) in sequence).
    """
    raw = np.loadtxt(filename, skiprows=n_hdr)
    lons = np.unique(raw[:, 0])
    lats = np.unique(raw[:, 1])
    nlon, nlat = len(lons), len(lats)
    nlevel = raw.shape[0] // (nlon * nlat)
    has_kzz = raw.shape[1] > 4
    pressure = raw[:nlevel, 2]
    tmap = np.zeros((nlevel, nlon, nlat))
    kmap = np.zeros((nlevel, nlon, nlat)) if has_kzz else None
    i = 0
    for col in range(nlon * nlat):
        block = raw[i:i + nlevel]
        ilon = int(np.searchsorted(lons, block[0, 0]))
        ilat = int(np.searchsorted(lats, block[0, 1]))
        order = np.argsort(block[:, 2])
        tmap[:, ilon, ilat] = block[order, 3]
        if has_kzz:
            kmap[:, ilon, ilat] = block[order, 4]
        i += nlevel
    geom, t_regrid = regrid_to_gauss_cheby(lats, lons, tmap,
                                           num_gangle, num_tangle, phase)
    out = {'pressure': np.sort(pressure), 'temperature': t_regrid,
           'lat': np.degrees(geom.latitude),
           'lon': np.degrees(geom.longitude)}
    if has_kzz:
        _, out['kz'] = regrid_to_gauss_cheby(lats, lons, kmap,
                                             num_gangle, num_tangle, phase)
    return out


def rebin_mitgcm_cld(filename, nwno_cld=196, num_gangle=10, num_tangle=10,
                     phase=0.0, n_hdr=0):
    """Read a flat 3D cloud dump (lon, lat, level, wave, opd, g0, w0) and
    regrid to facets (build_3d_input.py:180)."""
    raw = np.loadtxt(filename, skiprows=n_hdr)
    lons = np.unique(raw[:, 0])
    lats = np.unique(raw[:, 1])
    nlon, nlat = len(lons), len(lats)
    nrows_per_col = raw.shape[0] // (nlon * nlat)
    nlayer = nrows_per_col // nwno_cld
    cubes = {k: np.zeros((nlayer, nwno_cld, nlon, nlat))
             for k in ('opd', 'g0', 'w0')}
    i = 0
    for col in range(nlon * nlat):
        block = raw[i:i + nrows_per_col]
        ilon = int(np.searchsorted(lons, block[0, 0]))
        ilat = int(np.searchsorted(lats, block[0, 1]))
        for ic, key in enumerate(('opd', 'g0', 'w0')):
            cubes[key][:, :, ilon, ilat] = block[:, 4 + ic].reshape(
                nlayer, nwno_cld)
        i += nrows_per_col
    out = {}
    geom = None
    for key, cube in cubes.items():
        geom, out[key] = regrid_to_gauss_cheby(lats, lons, cube,
                                               num_gangle, num_tangle,
                                               phase)
    out['lat'] = np.degrees(geom.latitude)
    out['lon'] = np.degrees(geom.longitude)
    return out


def make_3d_pt_input(pressure, temperature_fn, lat=None, lon=None,
                     molecules=None):
    """Construct a 3D profile dict from a callable T(p, lon_deg, lat_deg)
    (build_3d_input.py:278 analog for programmatic maps)."""
    lat = np.asarray(lat if lat is not None else np.linspace(-85, 85, 10))
    lon = np.asarray(lon if lon is not None
                     else np.linspace(-180, 175, 20))
    nlevel = len(pressure)
    tmap = np.zeros((nlevel, len(lon), len(lat)))
    for i, lo in enumerate(lon):
        for j, la in enumerate(lat):
            tmap[:, i, j] = temperature_fn(np.asarray(pressure), lo, la)
    out = {'pressure': np.asarray(pressure), 'temperature': tmap,
           'lat': lat, 'lon': lon}
    for mol, vmr in (molecules or {}).items():
        out[mol] = np.zeros_like(tmap) + vmr
    return out


def make_3d_cld_input(opd_fn, pressure_layer, lat, lon, nwno_cld=196):
    """Construct facet-dependent clouds from opd(p, lon, lat) callables."""
    nlayer = len(pressure_layer)
    out = np.zeros((nlayer, nwno_cld, len(lon), len(lat)))
    for i, lo in enumerate(lon):
        for j, la in enumerate(lat):
            out[:, :, i, j] = np.asarray(
                opd_fn(np.asarray(pressure_layer), lo, la))[:, None]
    return out


# ---------------------------------------------------------------------------
# synthetic GCM inputs at a GCM's size
# ---------------------------------------------------------------------------

def _hot_spot(lon, lat, shift=20.0):
    """cos(lon - shift) cos(lat) on the dayside, 0 on the night side:
    [nlon, nlat]."""
    day = (np.cos(np.radians(lon - shift))[:, None]
           * np.cos(np.radians(lat))[None, :])
    return np.maximum(day, 0.0)


def synthetic_gcm(nlon=128, nlat=64, nlevel=53):
    """A hot Jupiter's GCM output as an ``ncio.NCDataset`` in the
    xarray layout ``regrid_xarray`` reads: a global lon-lat grid (lon in
    [-180, 180), lat inside (-90, 90)), ``nlevel`` pressures from 1e-6 to
    300 bar, and [nlevel, nlon, nlat] fields 'temperature' (a 1200 K
    profile, the dayside up to 30 % hotter, the hot spot 20 degrees east)
    and 'H2O' (a volume mixing ratio, depleted on the night side)."""
    from .ncio import NCDataset, NCVar
    lon = np.linspace(-180.0, 180.0, nlon, endpoint=False)
    lat = np.linspace(-90.0, 90.0, nlat + 2)[1:-1]
    pressure = np.logspace(-6, 2.5, nlevel)
    column = np.clip(1200.0 * (pressure / 50.0) ** 0.08, 150.0, None)
    heat = _hot_spot(lon, lat)
    temperature = column[:, None, None] * (1.0 + 0.3 * heat[None])
    h2o = 4e-4 * (0.5 + 0.5 * heat[None]) * np.ones((nlevel, 1, 1))
    dims = ('pressure', 'lon', 'lat')
    return NCDataset(
        data_vars={'temperature': NCVar(temperature, dims, {'units': 'K'}),
                   'H2O': NCVar(h2o, dims, {'units': 'v/v'})},
        coords={'lon': NCVar(lon, ('lon',), {'units': 'degrees'}),
                'lat': NCVar(lat, ('lat',), {'units': 'degrees'}),
                'pressure': NCVar(pressure, ('pressure',), {'units': 'bar'})},
        attrs={}, dims={'lon': nlon, 'lat': nlat, 'pressure': nlevel})


def write_mitgcm_pt(filename, dataset):
    """Write the temperature of :func:`synthetic_gcm`'s dataset as the flat
    MITgcm dump ``rebin_mitgcm_pt`` reads: rows of lon, lat, pressure
    (bar), temperature (K) and kzz (cm^2/s), all levels of one column in
    sequence, every number to 7 significant digits."""
    lon = np.asarray(dataset.coords['lon'].values)
    lat = np.asarray(dataset.coords['lat'].values)
    p = np.asarray(dataset.coords['pressure'].values)
    t = np.asarray(dataset.data_vars['temperature'].values)
    nlev, nlon, nlat = t.shape
    ilon, ilat, ilev = np.meshgrid(np.arange(nlon), np.arange(nlat),
                                   np.arange(nlev), indexing='ij')
    rows = np.stack([lon[ilon], lat[ilat], p[ilev],
                     t[ilev, ilon, ilat],
                     1e9 * (p[ilev] / 1.0) ** -0.5], axis=-1)
    np.savetxt(filename, rows.reshape(-1, 5), fmt='%.6e')
    return filename


def write_mitgcm_cld(filename, nlon=8, nlat=4, nlayer=52, nwno_cld=196):
    """Write a flat 3D cloud dump as ``rebin_mitgcm_cld`` reads it: rows
    of lon, lat, level, wave index, opd, g0 and w0, all (layer, wave)
    rows of one column in sequence (layer-major), a deck deepening with
    pressure and thicker on the night side, every number to 7
    significant digits."""
    lon = np.linspace(-180.0, 180.0, nlon, endpoint=False)
    lat = np.linspace(-90.0, 90.0, nlat + 2)[1:-1]
    night = 1.0 - _hot_spot(lon, lat)
    ilon, ilat, ilay, iw = np.meshgrid(
        np.arange(nlon), np.arange(nlat), np.arange(nlayer),
        np.arange(nwno_cld), indexing='ij')
    depth = (ilay / (nlayer - 1.0)) ** 2
    opd = depth * (0.2 + night[ilon, ilat]) * (1.0 + 0.5 * iw / nwno_cld)
    rows = np.stack([lon[ilon], lat[ilat], ilay, iw, opd,
                     0.8 - 0.3 * iw / nwno_cld,
                     0.95 - 0.1 * depth], axis=-1)
    np.savetxt(filename, rows.reshape(-1, 7), fmt='%.6e')
    return filename
