"""3D (disco-ball) spectra.

Port of ``picaso_tpu/three_d.py``: ``regrid_to_disco`` (numpy, as there)
selects the GCM columns nearest to each Gauss-Chebyshev facet, and
:func:`picaso_3d` computes the facets' spectra and integrates them over
the disk.  The JAX package stacks the facets' RTProps and vmaps its
solves over them; here the facets run one after another, each through
``justdoit.compute_rtprops`` (K1 for the molecular opacity) and the Toon
kernels on its own single-angle geometry (K5 reflected, K6 thermal), so
only one facet's RTProps is alive at a time: the kernels have no batch
axis, and the whole stack at nwno = 50 000 would take ~360 MB a facet.

3D profile input: a dict of arrays {'pressure': [nlevel] (bar),
'temperature': [nlevel, nlon, nlat], '<mol>': [nlevel, nlon, nlat], 'lat':
[nlat] (deg), 'lon': [nlon] (deg)}.
"""

from __future__ import annotations

import numpy as np
import torch

from . import disco as disco_mod
from .atmosphere import build_atmosphere
from .constants import SB_SIGMA

__all__ = ['regrid_to_disco', 'picaso_3d']


def regrid_to_disco(data, geometry: disco_mod.Geometry, field_lon_axis=1):
    """Select GCM columns at the facet lat/lon (nearest neighbour).

    ``field_lon_axis`` is the longitude axis of the gridded fields (1 for
    [nlevel, nlon, nlat] atmospheres; 2 for [nlayer, nwno, nlon, nlat]
    clouds); latitude is the next axis.  Returns dict of [..., ng, nt]
    arrays (plus untouched 1D vectors such as 'pressure').
    """
    lat_deg = np.degrees(geometry.latitude)
    lon_deg = np.degrees(geometry.longitude)
    glat = np.asarray(data['lat'])
    glon = np.asarray(data['lon'])
    ilat = np.array([np.abs(glat - la).argmin() for la in lat_deg])
    ilon = np.array([np.abs(glon - lo).argmin() for lo in lon_deg])
    out = {}
    for key, val in data.items():
        if key in ('lat', 'lon'):
            continue
        val = np.asarray(val)
        if val.ndim <= field_lon_axis:
            out[key] = val
        else:
            # [..., nlon, nlat] -> [..., ng, nt]
            sel = np.take(val, ilon, axis=field_lon_axis)
            out[key] = np.take(sel, ilat, axis=field_lon_axis + 1)
    return out


def _facet_atmospheres(bundle, wno, geometry):
    """Yield ((g, t), Atmosphere) for every facet, gauss-major."""
    prof3d = bundle.inputs['atmosphere']['profile']
    if isinstance(prof3d, dict) and 'lat' in prof3d:
        prof3d = regrid_to_disco(prof3d, geometry)
    cld = bundle.inputs['clouds'].get('profile')
    if isinstance(cld, dict) and 'lat' in cld:
        # a cloud map on the GCM grid -> select facet columns
        # ([nlayer, nwno, nlon, nlat] fields, lon axis 2)
        cld = regrid_to_disco(cld, geometry, field_lon_axis=2)
    cld_wno = bundle.inputs['clouds'].get('wavenumber')
    planet = bundle.inputs['planet']
    for g in range(geometry.ng):
        for t in range(geometry.nt):
            prof = {}
            for key, val in prof3d.items():
                val = np.asarray(val)
                prof[key] = val if val.ndim == 1 else val[:, g, t]
            cld_dict = None
            if cld is not None:
                if isinstance(cld, dict) and any(
                        np.asarray(v).ndim > 1 for v in cld.values()):
                    cld_dict = {k: np.asarray(cld[k])[..., g, t].ravel()
                                for k in ('opd', 'g0', 'w0')}
                else:
                    cld_dict = {k: np.asarray(cld[k]) for k in
                                ('opd', 'g0', 'w0')}
            yield (g, t), build_atmosphere(
                prof, gravity=planet['gravity'] or np.nan,
                radius=planet['radius'] or np.nan,
                mass=planet['mass'] or np.nan,
                p_reference=bundle.inputs['approx']['p_reference'],
                wno=wno if cld_dict is not None else None,
                cld_profile=cld_dict, cld_wno=cld_wno)


def picaso_3d(bundle, opacityclass, calculation='thermal',
              full_output=False, as_dict=True):
    """3D spectrum (justdoit.py:407-516 of the reference; three_d.py:
    103-215 of the JAX package): each facet's RTProps, its Toon solves at
    its own (ubar0, ubar1) -- K5 and K6, one launch each per gauss point
    -- then the disk integration."""
    from .justdoit import (_np, _trapz, compute_rtprops, scattering_controls,
                           toon_reflected, toon_thermal)
    from .rt import toon

    inp = bundle.inputs
    opa = opacityclass
    t = opa.tensor
    wno = np.asarray(opa.wno)
    nwno = opa.nwno
    gauss_wts = np.asarray(opa.gauss_wts)
    geom: disco_mod.Geometry = inp['disco']
    ng, nt = geom.ng, geom.nt
    controls = scattering_controls(bundle)
    reflected = 'reflected' in calculation
    thermal = 'thermal' in calculation

    radius_star = inp['star'].get('radius')
    if inp['star'].get('database') == 'nostar' or radius_star == 'nostar':
        F0PI = t(np.ones(nwno))
    else:
        F0PI = t(opa.relative_flux)
    surf_reflect = inp.get('surface_reflect', 0.0)
    if isinstance(surf_reflect, (int, float)):
        surf_reflect = np.zeros(nwno) + surf_reflect
    surf_reflect = t(surf_reflect)
    hard_surface = bool(inp.get('hard_surface', 0))
    u0 = t(geom.ubar0)
    u1 = t(geom.ubar1)
    cos_theta = geom.cos_theta
    gweight, tweight = t(geom.gweight), t(geom.tweight)
    wno_t = t(wno)

    xint_at_top = torch.zeros((ng, nt, nwno), dtype=opa.dtype,
                              device=opa.device)
    flux_at_top = torch.zeros_like(xint_at_top)
    for (g, k), atm in _facet_atmospheres(bundle, wno, geom):
        props = compute_rtprops(bundle, opa, atm)
        u0f, u1f = u0[g:g + 1, k:k + 1], u1[g:g + 1, k:k + 1]
        if thermal:
            # the monochromatic Planck function (calc_type=0, dwno zero)
            all_b = toon.blackbody(t(atm.temperature), 1.0 / wno_t).to(
                opa.dtype)
            plevel = t(atm.pressure)
        for ig in range(opa.ngauss):
            p = props.slice_gauss(ig)
            if reflected:
                xint, _ = toon_reflected(p, surf_reflect, u0f, u1f,
                                         cos_theta, F0PI, controls)
                xint_at_top[g, k] += xint[0, 0] * float(gauss_wts[ig])
            if thermal:
                flux, _ = toon_thermal(all_b, p, plevel, surf_reflect, u1f,
                                       hard_surface)
                flux_at_top[g, k] += flux[0, 0] * float(gauss_wts[ig])
        del props

    returns = {'wavenumber': wno}
    if reflected:
        albedo = _np(disco_mod.compress_disco(xint_at_top, gweight, tweight,
                                              cos_theta, F0PI))
        returns['albedo'] = albedo
        sa = inp['star'].get('semi_major', np.nan)
        r_planet = inp['planet'].get('radius') or np.nan
        if (isinstance(sa, float) and not np.isnan(sa)
                and not np.isnan(r_planet)):
            returns['fpfs_reflected'] = albedo * (r_planet / sa) ** 2
        if full_output:
            returns.setdefault('full_output', {})['xint_at_top'] = \
                _np(xint_at_top)

    if thermal:
        therm = _np(disco_mod.compress_thermal(flux_at_top, gweight,
                                               tweight))
        returns['thermal'] = therm
        returns['thermal_unit'] = 'erg/s/(cm^2)/(cm)'
        returns['effective_temperature'] = float(
            (_trapz(x=1 / wno[::-1], y=therm[::-1]) / SB_SIGMA) ** 0.25)
        if (opa.unshifted_stellar_spec is not None
                and isinstance(radius_star, float)):
            r_planet = inp['planet'].get('radius') or np.nan
            if not np.isnan(r_planet) and not np.isnan(radius_star):
                returns['fpfs_thermal'] = (
                    therm / np.asarray(opa.unshifted_stellar_spec)
                    * (r_planet / radius_star) ** 2)
        if full_output:
            returns.setdefault('full_output', {})['flux_at_top'] = \
                _np(flux_at_top)
    return returns
