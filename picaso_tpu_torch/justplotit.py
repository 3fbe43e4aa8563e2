"""Visualization layer (matplotlib).

Port of ``picaso_tpu/justplotit.py`` (the reference ``justplotit.py``
plotting surface) for the PyTorch port: numpy where the JAX module uses
``jax.numpy``, and the port's ``rt.toon.blackbody`` and
``rt.transit.transit_depth`` on CPU float64 tensors for the contribution
plots.  The reference renders with bokeh; every function here returns a
matplotlib Figure (same names, same science content: spectra, P-T
profiles, mixing ratios, photon-attenuation / tau=1 maps, disco maps,
brightness temperature, climate convergence animation, phase curves).
matplotlib is imported inside each function: the rest of the port runs
without it.  Inputs may be numpy arrays, torch tensors or the port's
dicts of columns (``model_compare``'s tables for :func:`rt_heatmap`).
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import PCONV
from .wavelength import mean_regrid

__all__ = ['spectrum', 'pt', 'mixing_ratio', 'photon_attenuation',
           'plot_format', 'explore', 'numba_cumsum',
           'taumap', 'disco', 'brightness_temperature',
           'animate_convergence', 'phase_curve', 'pt_adiabat',
           'mean_regrid', 'plot_errorbar', 'plot_multierror',
           'bin_errors', 'plot_cld_input', 'cloud', 'map',
           'spectrum_hires', 'flux_at_top', 'plot_evolution',
           'all_optics_1d', 'heatmap_taus', 'create_heat_map',
           'rt_heatmap', 'thermal_contribution', 'molecule_contribution',
           'transmission_contribution', 'phase_snaps',
           'find_nearest_1d', 'find_nearest_2d', 'find_nearest_old',
           'lon_lat_to_cartesian']


def _fig(**kw):
    import matplotlib.pyplot as plt
    return plt.subplots(**kw)


def _t64(x):
    """A CPU float64 tensor of ``x``."""
    return torch.as_tensor(np.asarray(x, np.float64))


def _frame(data, index=None):
    """(row labels, column labels, values [nrow, ncol]) of a table: a
    DataFrame-like (``.index``, ``.columns``, ``.values``) or a dict of
    columns whose row labels sit under ``index`` (default: the first key,
    as ``model_compare`` returns them)."""
    if hasattr(data, 'columns'):
        return (list(data.index), list(data.columns),
                np.asarray(data.values, dtype=float))
    index = index or next(iter(data))
    cols = [c for c in data if c != index]
    return (list(data[index]), cols,
            np.stack([np.asarray(data[c], float) for c in cols], axis=1))


def spectrum(wno, alb_or_flux, R=None, x_unit='micron', y_label='spectrum',
             ax=None, **plot_kwargs):
    """Plot (optionally binned-down) spectra (justplotit.py:31-120)."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = _fig(figsize=(9, 5))
    wno = np.asarray(wno)
    ys = (alb_or_flux if isinstance(alb_or_flux, (list, tuple))
          else [alb_or_flux])
    for y in ys:
        x, yy = (mean_regrid(wno, np.asarray(y), R=R) if R
                 else (wno, np.asarray(y)))
        xs = 1e4 / x if x_unit == 'micron' else x
        order = np.argsort(xs)
        ax.plot(xs[order], yy[order], **plot_kwargs)
    ax.set_xlabel('wavelength (micron)' if x_unit == 'micron'
                  else 'wavenumber (cm-1)')
    ax.set_ylabel(y_label)
    return ax.figure


def pt(full_output=None, pressure=None, temperature=None, ax=None,
       **plot_kwargs):
    """Pressure-temperature profile (log P inverted)."""
    if ax is None:
        _, ax = _fig(figsize=(5, 6))
    if full_output is not None:
        pressure = full_output['level']['pressure']
        temperature = full_output['level']['temperature']
    ax.semilogy(temperature, pressure, **plot_kwargs)
    ax.invert_yaxis()
    ax.set_xlabel('temperature (K)')
    ax.set_ylabel('pressure (bar)')
    return ax.figure


def mixing_ratio(profile_df, limit=1e-9, ax=None):
    """Abundance profiles vs pressure."""
    if ax is None:
        _, ax = _fig(figsize=(7, 6))
    p = np.asarray(profile_df['pressure'])
    for col in profile_df.keys():
        if col in ('pressure', 'temperature', 'kz', 'e-'):
            continue
        y = np.asarray(profile_df[col])
        if np.nanmax(y) < limit:
            continue
        ax.loglog(y, p, label=col)
    ax.invert_yaxis()
    ax.set_xlabel('mixing ratio (v/v)')
    ax.set_ylabel('pressure (bar)')
    ax.legend(fontsize=8, ncol=2)
    return ax.figure


def photon_attenuation(tau_p_surface, wno, at_tau=1, ax=None):
    """tau = at_tau pressure surfaces per species (justplotit.py:426)."""
    if ax is None:
        _, ax = _fig(figsize=(9, 5))
    wave = 1e4 / np.asarray(wno)
    order = np.argsort(wave)
    for name, press in tau_p_surface.items():
        ax.semilogy(wave[order], np.asarray(press)[order], label=name)
    ax.invert_yaxis()
    ax.set_xlabel('wavelength (micron)')
    ax.set_ylabel(f'pressure at tau={at_tau} (bar)')
    ax.legend(fontsize=8, ncol=2)
    return ax.figure


def taumap(full_output_or_xint, wno_index=0, title='tau map'):
    """Facet map of a disk quantity [ng, nt, nwno] (justplotit.py:1019)."""
    import matplotlib.pyplot as plt
    data = np.asarray(full_output_or_xint)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(data[:, :, wno_index].T, origin='lower', aspect='auto')
    fig.colorbar(im, ax=ax)
    ax.set_xlabel('gauss angle index (longitude)')
    ax.set_ylabel('chebyshev angle index (latitude)')
    ax.set_title(title)
    return fig


def disco(xint_at_top, wno, wavelength=None):
    """Disk intensity maps at chosen wavelengths (justplotit.py:692)."""
    import matplotlib.pyplot as plt
    wno = np.asarray(wno)
    waves = wavelength if wavelength is not None else [1e4 / wno[len(wno)
                                                                 // 2]]
    n = len(waves)
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 4), squeeze=False)
    for ax, wv in zip(axes[0], waves):
        iw = int(np.argmin(np.abs(1e4 / wno - wv)))
        im = ax.imshow(np.asarray(xint_at_top)[:, :, iw].T,
                       origin='lower', aspect='auto')
        fig.colorbar(im, ax=ax)
        ax.set_title(f'{wv:.2f} um')
    return fig


def brightness_temperature(wno, flux, ax=None):
    """T_bright(lambda) from a thermal spectrum (justplotit.py:1781)."""
    from .constants import PLANCK_C1, PLANCK_C2
    if ax is None:
        _, ax = _fig(figsize=(9, 5))
    wno = np.asarray(wno)
    flux = np.asarray(flux)
    # flux = pi * B_l => invert Planck in per-cm wavelength units
    w_cm = 1.0 / wno
    with np.errstate(all='ignore'):
        tb = (PLANCK_C2 / w_cm
              / np.log(1.0 + np.pi * PLANCK_C1 / (flux * w_cm ** 5)))
    wave = 1e4 / wno
    order = np.argsort(wave)
    ax.plot(wave[order], tb[order])
    ax.set_xlabel('wavelength (micron)')
    ax.set_ylabel('brightness temperature (K)')
    return ax.figure


def animate_convergence(all_profiles, pressure, interval=200):
    """Climate iteration animation (justplotit.py:1839)."""
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation
    profs = np.asarray(all_profiles).reshape(-1, len(pressure))
    fig, ax = plt.subplots(figsize=(5, 6))
    line, = ax.semilogy(profs[0], pressure)
    ax.invert_yaxis()
    ax.set_xlim(profs.min() * 0.9, profs.max() * 1.1)
    ax.set_xlabel('temperature (K)')
    ax.set_ylabel('pressure (bar)')

    def update(i):
        line.set_xdata(profs[i])
        ax.set_title(f'iteration {i}')
        return line,

    return FuncAnimation(fig, update, frames=len(profs),
                         interval=interval)


def phase_curve(allout, to_plot='thermal', collapse='sum', R=None, ax=None):
    """Integrated quantity vs phase angle (justplotit.py:1325)."""
    if ax is None:
        _, ax = _fig(figsize=(7, 5))
    phases = sorted(allout.keys())
    vals = []
    for ph in phases:
        y = np.asarray(allout[ph][to_plot])
        vals.append(y.sum() if collapse == 'sum' else y.mean())
    ax.plot(phases, vals, marker='o')
    ax.set_xlabel('phase angle (radians)')
    ax.set_ylabel(f'{collapse}({to_plot})')
    return ax.figure


def pt_adiabat(climate_out, ax=None):
    """Converged climate P-T with the convective zone marked
    (justplotit.py:2157)."""
    if ax is None:
        _, ax = _fig(figsize=(5, 6))
    p = np.asarray(climate_out['pressure'])
    t = np.asarray(climate_out['temperature'])
    nstr = climate_out['cvz_locs']
    ax.semilogy(t, p, label='T(P)')
    conv = slice(nstr[1], nstr[2] + 2)
    ax.semilogy(t[conv], p[conv], lw=4, alpha=0.5, label='convective zone')
    if len(nstr) > 4 and nstr[4] > 0:
        conv2 = slice(nstr[4], nstr[5] + 2)
        ax.semilogy(t[conv2], p[conv2], lw=4, alpha=0.5,
                    label='convective zone 2')
    ax.invert_yaxis()
    ax.set_xlabel('temperature (K)')
    ax.set_ylabel('pressure (bar)')
    ax.legend()
    return ax.figure


def plot_errorbar(x, y, e, ax=None, plot_kwargs=None, **kw):
    """Data + error bars (justplotit.py plot_errorbar)."""
    fig = None
    if ax is None:
        fig, ax = _fig()
    ax.errorbar(np.asarray(x), np.asarray(y), yerr=np.asarray(e), fmt='o',
                **(plot_kwargs or {}), **kw)
    return fig or ax.figure


def plot_multierror(x, y, ax=None, dx_low=0, dx_up=0, dy_low=0, dy_up=0,
                    **kw):
    """Asymmetric x/y error bars (justplotit.py plot_multierror)."""
    fig = None
    if ax is None:
        fig, ax = _fig()
    ax.errorbar(np.asarray(x), np.asarray(y),
                xerr=[np.atleast_1d(dx_low), np.atleast_1d(dx_up)]
                if np.any(dx_low) or np.any(dx_up) else None,
                yerr=[np.atleast_1d(dy_low), np.atleast_1d(dy_up)]
                if np.any(dy_low) or np.any(dy_up) else None,
                fmt='o', **kw)
    return fig or ax.figure


def bin_errors(newx, oldx, dy):
    """Quadrature-rebin uncertainties onto a coarser grid
    (justplotit.py bin_errors)."""
    newx = np.asarray(newx, float)
    oldx = np.asarray(oldx, float)
    dy = np.asarray(dy, float)
    edges = np.concatenate([[newx[0] - (newx[1] - newx[0]) / 2],
                            (newx[1:] + newx[:-1]) / 2,
                            [newx[-1] + (newx[-1] - newx[-2]) / 2]])
    out = np.zeros(len(newx))
    for i in range(len(newx)):
        sel = (oldx >= edges[i]) & (oldx < edges[i + 1])
        n = sel.sum()
        out[i] = np.sqrt(np.sum(dy[sel] ** 2)) / max(n, 1)
    return out


def plot_cld_input(nwno, nlayer, filename=None, df=None, pressure=None,
                   wavenumber=None, **kw):
    """Heatmaps of a cloud input file's opd/g0/w0 (justplotit.py
    plot_cld_input)."""
    import matplotlib.pyplot as plt
    if df is None and filename is not None:
        from .justdoit import _read_table
        df = _read_table(filename, {'sep': r'\s+'})
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    for ax, key in zip(axes, ('opd', 'g0', 'w0')):
        m = np.reshape(np.asarray(df[key]), (nlayer, nwno))
        im = ax.imshow(m, aspect='auto', origin='lower', **kw)
        ax.set_title(key)
        ax.set_xlabel('wavenumber index')
        ax.set_ylabel('layer')
        fig.colorbar(im, ax=ax)
    return fig


def cloud(full_output, wno_index=None):
    """Cloud optical-depth / ssa / asymmetry heatmaps from full_output
    (justplotit.py cloud)."""
    import matplotlib.pyplot as plt
    lay = full_output['layer']
    pressure = np.asarray(lay['pressure'])
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    for ax, key in zip(axes, ('opd', 'g0', 'w0')):
        m = np.asarray(lay['cloud'][key])
        im = ax.imshow(m, aspect='auto', origin='upper',
                       extent=[0, m.shape[1], pressure[-1], pressure[0]])
        ax.set_yscale('log')
        ax.set_title(f'cloud {key}')
        ax.set_xlabel('wavenumber index')
        ax.set_ylabel('pressure [bar]')
        fig.colorbar(im, ax=ax)
    return fig


def map(full_output_or_xint, wno=None, wno_index=0, pressure=None,
        to_plot=None):
    """Lat/lon facet map of TOA intensity at one wavelength
    (justplotit.py map)."""
    return taumap(full_output_or_xint, wno_index=wno_index,
                  title='disk map')


def map_4d(profiles, phases, field='temperature', iz_plot=0):
    """Per-phase lat/lon maps of a rotated 4D profile list (the
    auto-plot of the reference's atmosphere_4d, justdoit.py:3867-3869)."""
    import matplotlib.pyplot as plt
    n = len(profiles)
    ncols = min(4, n)
    nrows = (n + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=(3.2 * ncols,
                                                    2.6 * nrows))
    axes = np.atleast_1d(axes).ravel()
    for ax, prof, ph in zip(axes, profiles, np.atleast_1d(phases)):
        ax.pcolormesh(np.asarray(prof['lon']), np.asarray(prof['lat']),
                      np.asarray(prof[field])[iz_plot].T, shading='auto')
        ax.set_title(f'phase {np.degrees(float(ph)):.0f} deg')
    for ax in axes[n:]:
        ax.set_visible(False)
    fig.tight_layout()
    return fig


def spectrum_hires(wno, alb_or_flux, ax=None, **kw):
    """Unbinned high-resolution spectrum (justplotit.py spectrum_hires)."""
    return spectrum(wno, alb_or_flux, R=None, ax=ax, **kw)


def flux_at_top(full_output_or_flux, wno=None, pressures=None, ax=None,
                **kw):
    """TOA flux spectrum helper (justplotit.py flux_at_top)."""
    if isinstance(full_output_or_flux, dict):
        wno = full_output_or_flux['wavenumber']
        flux = full_output_or_flux.get('thermal',
                                       full_output_or_flux.get('flux'))
    else:
        flux = full_output_or_flux
    return spectrum(wno, flux, y_label='flux at top', ax=ax, **kw)


def plot_evolution(evo_table, y='Teff', ax=None):
    """Evolution-track plot (justplotit.py plot_evolution): y vs age for
    the hot/cold start tables from justdoit.evolution_track."""
    fig = None
    if ax is None:
        fig, ax = _fig()
    for kind in ('hot', 'cold'):
        t = evo_table.get(kind) if isinstance(evo_table, dict) else None
        if t is None:
            continue
        age = np.asarray(t['age_years'])
        cols = [c for c in t.keys() if str(c).startswith(y)]
        for c in cols:
            ax.loglog(age, np.asarray(t[c]), label=f'{kind} {c}')
    ax.set_xlabel('age [yr]')
    ax.set_ylabel(y)
    ax.legend(fontsize=7)
    return fig or ax.figure


def all_optics_1d(full_output, wave_range=None, ax=None):
    """Layer-integrated taugas/taucld/tauray profiles
    (justplotit.py all_optics_1d); needs taus from get_contribution."""
    fig = None
    if ax is None:
        fig, ax = _fig()
    pressure = np.asarray(full_output['layer']['pressure'])
    for key in ('taugas', 'taucld', 'tauray'):
        if key in full_output:
            prof = np.asarray(full_output[key]).sum(axis=1)
            ax.loglog(prof, pressure, label=key)
    ax.invert_yaxis()
    ax.set_xlabel('column optical depth')
    ax.set_ylabel('pressure [bar]')
    ax.legend()
    return fig or ax.figure


def heatmap_taus(out, wno=None):
    """Per-species cumulative-tau heatmaps (justplotit.py heatmap_taus);
    ``out`` is get_contribution's return."""
    import matplotlib.pyplot as plt
    taus = out['taus_per_layer'] if 'taus_per_layer' in out else out
    keys = [k for k in taus.keys()]
    n = len(keys)
    fig, axes = plt.subplots(1, max(n, 1), figsize=(4 * max(n, 1), 4),
                             squeeze=False)
    for ax, k in zip(axes[0], keys):
        m = np.asarray(taus[k])
        im = ax.imshow(np.log10(np.maximum(m, 1e-30)), aspect='auto',
                       origin='lower')
        ax.set_title(k)
        fig.colorbar(im, ax=ax)
    return fig


def create_heat_map(matrix, x=None, y=None, title='', ax=None,
                    log=True, **kw):
    """Generic (wavelength x pressure) heatmap (justplotit.py
    create_heat_map / rt_heatmap)."""
    fig = None
    if ax is None:
        fig, ax = _fig()
    m = np.asarray(matrix)
    if log:
        m = np.log10(np.maximum(np.abs(m), 1e-30))
    im = ax.imshow(m, aspect='auto', origin='lower', **kw)
    ax.set_title(title)
    ax.figure.colorbar(im, ax=ax)
    return fig or ax.figure


rt_heatmap = create_heat_map


def _contribution(contrib_key):
    def plot(out, full_output=None, R=None, ax=None, norm=None, **kw):
        fig = None
        if ax is None:
            fig, ax = _fig()
        wno = np.asarray(out['wavenumber']) if 'wavenumber' in out else None
        taus = out.get(contrib_key, out)
        pressure = None
        if full_output is not None:
            pressure = np.asarray(full_output['layer']['pressure'])
        if isinstance(taus, dict):
            for k, v in taus.items():
                prof = np.asarray(v)
                if prof.ndim == 2 and wno is not None:
                    ax.semilogy(1e4 / wno, prof.sum(0), label=str(k))
                elif prof.ndim == 1 and wno is not None:
                    ax.semilogy(1e4 / wno, prof, label=str(k))
            ax.set_xlabel('wavelength [micron]')
            ax.set_ylabel('cumulative optical depth')
            ax.legend(fontsize=7)
        else:
            m = np.asarray(taus)
            create_heat_map(m, ax=ax, title=contrib_key)
        return fig or ax.figure
    return plot


# (the full reference-semantics contribution plotters are defined below;
# _contribution remains for simple per-species overlays)
species_contribution = _contribution('taus_per_layer')


def phase_snaps(allout, to_plot='thermal', ncols=4):
    """Grid of disk maps across phase (justplotit.py phase_snaps)."""
    import matplotlib.pyplot as plt
    phases = list(allout.keys())
    n = len(phases)
    ncols = min(ncols, max(n, 1))
    nrows = -(-n // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 3 * nrows),
                             squeeze=False)
    for k, phase in enumerate(phases):
        ax = axes[k // ncols][k % ncols]
        out = allout[phase]
        v = np.asarray(out[to_plot])
        ax.plot(np.asarray(out.get('wavenumber', np.arange(v.shape[-1]))),
                v if v.ndim == 1 else v.reshape(-1, v.shape[-1]).mean(0))
        ax.set_title(f'phase {float(phase):.2f}')
    return fig


# ---------------------------------------------------------------------------
# contribution-function plots (justplotit.py:1584-1779) + heatmap tail
# ---------------------------------------------------------------------------

def thermal_contribution(full_output, tau_max=1.0, R=100, ax=None, **kwargs):
    """Emission contribution function heatmap (justplotit.py:1584-1644;
    Dobbs-Dixon & Cowan 2017 eqn 4): CF = B(T) e^{-tau} dtau/dlnP per
    (layer, wavelength), summed over CK gauss points.

    Returns (fig, ax, CF) with CF [nlayer-1, nwno_binned]."""
    from matplotlib import colors as mcolors
    from .rt.toon import blackbody
    from .wavelength import mean_regrid

    import matplotlib.pyplot as plt

    kwargs.setdefault('norm', mcolors.LogNorm())
    kwargs.setdefault('shading', 'auto')
    all_taus = np.squeeze(np.asarray(full_output['taugas'])
                          + np.asarray(full_output['taucld'])
                          + np.asarray(full_output['tauray']))
    if all_taus.ndim == 3:
        all_taus = all_taus.sum(axis=2)
    all_taus = np.minimum(all_taus, tau_max)
    sum_taus = np.cumsum(all_taus, axis=0)
    wno = np.asarray(full_output['wavenumber'])
    press = np.asarray(full_output['layer']['pressure'])
    temp = np.asarray(full_output['layer']['temperature'])
    bb = blackbody(_t64(temp), 1.0 / _t64(wno)).numpy()
    dlnp = np.diff(np.log(press))[:, None]
    CF = (bb[:-1] * np.exp(-sum_taus[:-1]) * all_taus[:-1] / dlnp)
    if R is not None:
        wno_b, _ = mean_regrid(wno, wno, R=R)
        CF_bin = np.stack([mean_regrid(wno, CF[i], newx=wno_b)[1]
                           for i in range(CF.shape[0])])
    else:
        CF_bin, wno_b = CF, wno
    if ax is None:
        fig, ax = plt.subplots(figsize=(11, 7))
    else:
        fig = ax.figure
    smap = ax.pcolormesh(1e4 / wno_b, press[:-1], CF_bin, **kwargs)
    ax.set_ylim(press.max(), press.min())
    ax.set_yscale('log')
    ax.set_ylabel('Pressure (bar)')
    ax.set_xlabel(r'Wavelength ($\mu$m)')
    fig.colorbar(smap, ax=ax, label='Emission Contribution Function')
    return fig, ax, CF_bin


def molecule_contribution(contribution_out, opa, min_pressure=4.5, R=100,
                          ax=None, **kwargs):
    """Tau~1 pressure surfaces per molecule (justplotit.py:1646-1695):
    plots every species whose tau-surface rises above ``min_pressure``."""
    from .wavelength import mean_regrid

    import matplotlib.pyplot as plt

    tau_p_surface = contribution_out['tau_p_surface']
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    plotted = []
    for mol in tau_p_surface:
        x, y = mean_regrid(np.asarray(opa.wno),
                           np.asarray(tau_p_surface[mol]), R=R)
        if np.nanmin(y) < min_pressure:
            ax.plot(1e4 / x, y, label=mol, **kwargs)
            plotted.append(mol)
    ax.set_yscale('log')
    ax.invert_yaxis()
    ax.set_xlabel(r'Wavelength ($\mu$m)')
    ax.set_ylabel('Tau Pressure (bars)')
    ax.legend(fontsize=8)
    ax.set_title('Tau Pressure Surface')
    return fig


def transmission_contribution(full_output, R=None, ax=None, **kwargs):
    """Transmission contribution function (justplotit.py:1697-1779,
    petitRADTRANS convention): per-layer effect on the transit depth of
    zeroing that layer's opacity, normalized per wavelength.

    Returns (fig, ax, um, CF)."""
    from matplotlib import colors as mcolors
    from .rt.transit import transit_depth as _transit
    from .wavelength import mean_regrid

    dtau = (np.asarray(full_output['taugas'])[:, :, 0]
            + np.asarray(full_output['taucld'])[:, :, 0]
            + np.asarray(full_output['tauray'])[:, :, 0])
    lvl, lay = full_output['level'], full_output['layer']
    z, dz = np.asarray(lvl['z']), np.asarray(lvl['dz'])
    player = np.asarray(lay['pressure'])
    tlayer = np.asarray(lay['temperature'])
    colden = np.asarray(lay['column_density'])
    mmw = np.asarray(lay['mmw'])

    plevel = np.asarray(lvl['pressure']) * PCONV
    tlevel = np.asarray(lvl['temperature'])

    def depth(d):
        # rstar=1 as in the reference (only relative differences matter)
        return _transit(_t64(z), _t64(dz), 1.0, _t64(mmw), _t64(plevel),
                        _t64(tlevel), _t64(colden), _t64(d)).numpy()

    norm = depth(dtau)
    zs = []
    for i in range(dtau.shape[0]):
        d = dtau.copy()
        d[i, :] = 0.0
        zs.append(depth(d))
    zs = np.asarray(zs)
    CF = (norm - zs) / np.maximum((norm - zs).sum(axis=0), 1e-300)
    wno = np.asarray(full_output['wavenumber'])
    if R is not None:
        wno_b, _ = mean_regrid(wno, wno, R=R)
        CF_bin = np.stack([mean_regrid(wno, CF[i], newx=wno_b)[1]
                           for i in range(CF.shape[0])])
    else:
        CF_bin, wno_b = CF, wno
    import matplotlib.pyplot as plt

    kwargs.setdefault('norm', mcolors.LogNorm())
    kwargs.setdefault('shading', 'auto')
    if ax is None:
        fig, ax = plt.subplots()
    else:
        fig = ax.figure
    smap = ax.pcolormesh(1e4 / wno_b, player, CF_bin, **kwargs)
    ax.set_ylim(player.max(), player.min())
    ax.set_yscale('log')
    ax.set_ylabel('Pressure (bar)')
    ax.set_xlabel(r'Wavelength ($\mu$m)')
    fig.colorbar(smap, ax=ax, label='Transmission CF')
    return fig, ax, 1e4 / wno_b, CF_bin


def rt_heatmap(data, figure_kwargs=None, cmap_kwargs=None, ax=None):
    """w0 x g0 %-difference heatmap for the model_compare harnesses
    (justplotit.py:2083-2155; Batalha+2019 fig 9 / Rooney+2023 fig 6
    layout — index = asymmetry, columns = single-scattering albedo).
    ``data``: a DataFrame-like or ``model_compare``'s dict of columns."""
    import matplotlib.pyplot as plt

    figure_kwargs = figure_kwargs or {}
    cmap_kwargs = cmap_kwargs or {}
    index, columns, vals = _frame(data)
    bd = np.abs(vals).max()
    if ax is None:
        fig, ax = plt.subplots(
            figsize=figure_kwargs.get('figsize', (6, 6)))
    else:
        fig = ax.figure
    im = ax.imshow(vals.T[::-1], aspect='auto',
                   cmap=cmap_kwargs.get('palette', 'RdGy'),
                   vmin=cmap_kwargs.get('low', -bd),
                   vmax=cmap_kwargs.get('high', bd))
    ax.set_xticks(range(len(index)))
    ax.set_xticklabels([str(i) for i in index], rotation=60, fontsize=8)
    ax.set_yticks(range(len(columns)))
    ax.set_yticklabels([str(c) for c in reversed(columns)], fontsize=8)
    ax.set_xlabel('Asymmetry')
    ax.set_ylabel('Single Scattering Albedo')
    ax.set_title(figure_kwargs.get('title', '% Diff'))
    fig.colorbar(im, ax=ax)
    return fig


def plot_format(ax):
    """Apply the reference's large-font axis formatting
    (justplotit.py:538-549) to a matplotlib Axes."""
    ax.xaxis.label.set_fontsize(14)
    ax.yaxis.label.set_fontsize(14)
    ax.tick_params(axis='both', labelsize=14)


def explore(df, key):
    """Fetch ``key`` from a dict up to three levels deep
    (justplotit.py:982-1017)."""
    if isinstance(df, dict) and df.get(key) is not None:
        return df[key]
    for v in (df.values() if isinstance(df, dict) else []):
        if isinstance(v, dict):
            if v.get(key) is not None:
                return v[key]
            for vv in v.values():
                if isinstance(vv, dict) and vv.get(key) is not None:
                    return vv[key]
    raise KeyError(f'{key!r} not found within three levels')


def numba_cumsum(mat):
    """Axis-0 cumulative sum (API-parity shim for fluxes.py:872)."""
    return np.cumsum(mat, axis=0)


def lon_lat_to_cartesian(lon_r, lat_r, R=1):
    """(lon, lat) radians on a sphere of radius R -> (x, y, z)
    (justplotit.py:682)."""
    x = R * np.cos(lat_r) * np.cos(lon_r)
    y = R * np.cos(lat_r) * np.sin(lon_r)
    z = R * np.sin(lat_r)
    return x, y, z


def find_nearest_old(array, value):
    """Row index of the nearest value along axis 0 (justplotit.py:843)."""
    return np.abs(np.asarray(array) - value).argmin(axis=0)


def find_nearest_1d(array, value):
    """Index of the nearest element, resolving ties in favor of the LAST
    occurrence of a duplicated value (justplotit.py:861 semantics: useful
    for monotone-with-plateaus profiles like tau columns).  As in the
    reference, the last-duplicate arithmetic assumes duplicates are
    CONTIGUOUS (first_index + count - 1); on non-monotone data with
    repeats scattered apart both give the same wrong answer."""
    arr = np.asarray(array)
    uniq, first, counts = np.unique(arr, return_index=True,
                                    return_counts=True)
    k = np.abs(uniq - value).argmin(axis=0)
    return first[k] + (counts[k] - 1) if counts[k] > 1 else first[k]


def find_nearest_2d(array, value, axis=1):
    """Per-column nearest-element indices with the same last-duplicate
    tie-break as :func:`find_nearest_1d` (justplotit.py:848)."""
    arr = np.asarray(array)
    return [find_nearest_1d(arr[:, i], value) for i in range(arr.shape[axis])]
