"""Retrieval templates and posterior analysis.

Copy of ``picaso_tpu/retrieval.py`` for the PyTorch port, which must not
import the JAX package: stamp runnable retrieval scripts (free / grid /
grid-plus / line retrievals against the port's driver and samplers, data
read with numpy), and analyze finished runs (summary statistics,
equal-weight posterior bands, the max-likelihood chi-square).  Host numpy;
the plots (``plot_pair``, ``spread_plot``, ``plot_spectra_bands``,
``plot_pressure_bands``) import matplotlib inside each function.
"""

from __future__ import annotations

import os
import textwrap

import numpy as np

__all__ = ['create_template', 'get_info', 'get_evaluations',
           'get_chisq_max', 'plot_pair', 'spread_plot', 'data_output',
           'summary', 'plot_spectra_bands', 'plot_pressure_bands']


def _numpy(x):
    """A model's output as numpy (a torch tensor from the card too)."""
    if hasattr(x, 'detach'):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_TEMPLATES = {
    'free': '''\
        """Free retrieval template (picaso_tpu_torch).

        Edit the prior blocks + data path, then `python this_script.py`.
        Each likelihood is one front-door spectrum on the card.
        """
        import numpy as np
        from picaso_tpu_torch import driver

        config = driver.load_toml('{toml}')
        # supply data directly: (wavelength_micron, y, err)
        io = config['InputOutput']
        df = np.genfromtxt(io['observation_data'], delimiter=',',
                           names=True)
        data = (df[io['coord_key']], df[io['y_key']], df[io['error_key']])
        result = driver.run(config, data=data, sampler='nested',
                            nlive=400, checkpoint_file='run.ckpt')
        np.savez('posterior.npz', samples=result['samples_equal'],
                 logz=result['logz'],
                 names=[p['path'] for p in result['fitpars']])
    ''',
    'grid': '''\
        """Grid retrieval template: chi-square fit a precomputed model grid."""
        import numpy as np
        from picaso_tpu_torch.analyze import GridFitter

        fitter = GridFitter('my_grid', location='path/to/models')
        df = np.genfromtxt('data.csv', delimiter=',', names=True)
        res = fitter.fit_grid('my_grid', 'dataset1',
                              df['central_wavelength'], df['y'], df['err'],
                              offset=True)
        print(fitter.best_fit('my_grid', 'dataset1'))
    ''',
    'gridplus': '''\
        """Grid-plus retrieval: interpolated grid + free offset/scale
        parameters sampled with the nested sampler."""
        import numpy as np
        from picaso_tpu_torch.analyze import GridFitter
        from picaso_tpu_torch.sampler import nested_sample

        fitter = GridFitter('my_grid', location='path/to/models')
        df = np.genfromtxt('data.csv', delimiter=',', names=True)
        wl = df['central_wavelength']
        y, e = df['y'], df['err']
        pnames = ['tint', 'mh']       # grid axes to interpolate
        los = np.array([np.min(fitter.grid_params[p]) for p in pnames])
        his = np.array([np.max(fitter.grid_params[p]) for p in pnames])

        def transform(u):
            return los + u * (his - los)

        def loglike(thetas):
            out = []
            for t in np.atleast_2d(thetas):
                model = fitter.interp_models(pnames, t)
                binned = np.interp(wl, 1e4 / fitter.wavenumber[::-1],
                                   model[::-1])
                out.append(-0.5 * np.sum((y - binned) ** 2 / e ** 2))
            return np.array(out)

        res = nested_sample(loglike, transform, len(pnames), nlive=200)
        np.savez('posterior.npz', samples=res['samples_equal'])
    ''',
    'line': '''\
        """Line (on-the-fly chemistry) retrieval: visscher equilibrium
        chemistry with retrieved mh/cto + PT parameters."""
        import numpy as np
        from picaso_tpu_torch import driver
        config = driver.load_toml('{toml}')
        config['chemistry']['method'] = 'visscher'
        result = driver.run(config, sampler='nested', nlive=400)
        np.savez('posterior.npz', samples=result['samples_equal'])
    ''',
}


def create_template(kind='free', output_dir='.', toml=None):
    """Write a runnable retrieval script (retrieval.py:38 semantics)."""
    if kind not in _TEMPLATES:
        raise ValueError(f'kind must be one of {list(_TEMPLATES)}')
    from .refdata import refdata_path
    toml = toml or refdata_path('input_tomls', 'driver_example.toml')
    script = textwrap.dedent(_TEMPLATES[kind]).format(toml=toml)
    path = os.path.join(output_dir, f'{kind}_retrieval.py')
    with open(path, 'w') as f:
        f.write(script)
    return path


def get_info(result):
    """Summary of a sampler result: medians + 1-sigma (retrieval.py:139)."""
    samples = np.asarray(result['samples_equal'])
    names = [p['path'] for p in result.get('fitpars',
                                           [{'path': f'p{i}'} for i in
                                            range(samples.shape[1])])]
    info = {}
    for i, name in enumerate(names):
        lo, med, hi = np.percentile(samples[:, i], [16, 50, 84])
        info[name] = dict(median=med, minus=med - lo, plus=hi - med)
    if 'logz' in result:
        info['ln_evidence'] = result['logz']
    return info


def summary(result):
    info = get_info(result)
    lines = []
    for k, v in info.items():
        if isinstance(v, dict):
            lines.append(f"{k} = {v['median']:.4g} "
                         f"(+{v['plus']:.2g}/-{v['minus']:.2g})")
        else:
            lines.append(f'{k} = {v:.4g}')
    return '\n'.join(lines)


def plot_pair(result, parameters=None, bins=25):
    """Corner plot of the equal-weight posterior (retrieval.py:605)."""
    import matplotlib.pyplot as plt
    samples = np.asarray(result['samples_equal'])
    names = [p['path'] for p in result.get('fitpars',
                                           [{'path': f'p{i}'} for i in
                                            range(samples.shape[1])])]
    if parameters is not None:
        idx = [names.index(p) for p in parameters]
        samples = samples[:, idx]
        names = parameters
    n = samples.shape[1]
    fig, axes = plt.subplots(n, n, figsize=(2.2 * n, 2.2 * n))
    axes = np.atleast_2d(axes)
    for i in range(n):
        for j in range(n):
            ax = axes[i][j]
            if j > i:
                ax.axis('off')
            elif i == j:
                ax.hist(samples[:, i], bins=bins, histtype='step')
                ax.set_yticks([])
            else:
                ax.hist2d(samples[:, j], samples[:, i], bins=bins)
            if i == n - 1:
                ax.set_xlabel(names[j], fontsize=8)
            if j == 0 and i > 0:
                ax.set_ylabel(names[i], fontsize=8)
    fig.tight_layout()
    return fig


def spread_plot(result, model_fn, wl, y=None, e=None, n_draws=50,
                percentiles=(16, 50, 84), seed=0):
    """Posterior predictive band (retrieval.py:370-455)."""
    import matplotlib.pyplot as plt
    rng = np.random.default_rng(seed)
    samples = np.asarray(result['samples_equal'])
    draws = samples[rng.integers(0, len(samples), n_draws)]
    models = np.array([_numpy(model_fn(t)) for t in draws])
    lo, med, hi = np.percentile(models, percentiles, axis=0)
    fig, ax = plt.subplots(figsize=(9, 5))
    ax.fill_between(wl, lo, hi, alpha=0.3, label='posterior band')
    ax.plot(wl, med, label='median model')
    if y is not None:
        ax.errorbar(wl, y, yerr=e, fmt='.', color='k', label='data')
    ax.set_xlabel('wavelength (micron)')
    ax.legend()
    return fig, (lo, med, hi)


def data_output(result, filename):
    """Persist posterior samples + metadata (retrieval.py:456)."""
    np.savez(filename,
             samples=np.asarray(result['samples_equal']),
             weights=np.asarray(result.get('weights', [])),
             logz=result.get('logz', np.nan),
             names=[p['path'] for p in result.get('fitpars', [])])
    return filename


def get_evaluations(samples_equal, max_logl, model, n_draws, regrid=False,
                    pressure_bands=('temperature', 'H2O', 'CO2'),
                    rng_seed=0):
    """Max-logL model + 1/2/3-sigma posterior bands (retrieval.py:199-311).

    ``model(theta)`` returns ``(wno, y, offsets, err_inflation)``; with
    ``return_ptchem=True`` it returns the inputs class (or dict of them)
    so per-draw chemistry/temperature bands can be extracted.  Bands are
    straight numpy quantiles over ``n_draws`` posterior draws (the
    reference uses ultranest's PredictionBand — same math).  ``regrid``:
    False, a wavenumber grid (ndarray), or a resolution (float).
    """
    from .wavelength import mean_regrid
    pressure_bands = list(pressure_bands)
    returns = {}
    if pressure_bands:
        cls = model(max_logl, return_ptchem=True)
        if isinstance(cls, dict):
            cls = cls[list(cls.keys())[0]]
        df = cls.inputs['atmosphere']['profile']
        returns['max_logl_ptchem'] = df

    rng = np.random.default_rng(rng_seed)
    draws = rng.integers(0, np.asarray(samples_equal).shape[0],
                         size=n_draws)
    spectra, chems = [], {i: [] for i in pressure_bands}
    binning = False
    um_xgrid = None
    for idraw in draws:
        theta = samples_equal[idraw, :]
        cls = None
        if pressure_bands:
            out = model(theta, return_ptchem=True)
            # a model may return ((wno, y, offsets, err), cls) to avoid
            # the second forward run; a bare cls still works below
            if (isinstance(out, tuple) and len(out) == 2
                    and isinstance(out[0], tuple)):
                (x, y, _, _), cls = out
            else:
                cls = out
                x, y, _, _ = model(theta)
        else:
            x, y, _, _ = model(theta)
        if isinstance(regrid, np.ndarray):
            _, y = mean_regrid(x, y, newx=regrid)
            binning, um_xgrid = True, 1e4 / regrid
        elif isinstance(regrid, (int, float)) and not isinstance(
                regrid, bool):
            wno_x, y = mean_regrid(x, y, R=regrid)
            binning, um_xgrid = True, 1e4 / wno_x
        else:
            um_xgrid = 1e4 / x
        spectra.append(np.asarray(y))
        if pressure_bands:
            if isinstance(cls, dict):
                cls = cls[list(cls.keys())[0]]
            chem = cls.inputs['atmosphere']['profile']
            for i in pressure_bands:
                chems[i].append(np.asarray(chem[i]))

    spectra = np.stack(spectra)
    returns['bands_spectra'] = {}
    if pressure_bands:
        returns['bands_ptchem'] = {i: {} for i in pressure_bands}
    for frac, key in zip([68.27, 95.45, 99.73], ['1sig', '2sig', '3sig']):
        q = frac / 100.0 / 2.0
        for suff, quant in (('_lo', 0.5 - q), ('_hi', 0.5 + q)):
            returns['bands_spectra'][key + suff] = np.quantile(
                spectra, quant, axis=0)
            for i in pressure_bands:
                returns['bands_ptchem'][i][key + suff] = np.quantile(
                    np.stack(chems[i]), quant, axis=0)
    returns['bands_spectra']['median'] = np.quantile(spectra, 0.5, axis=0)
    for i in pressure_bands:
        returns['bands_ptchem'][i]['median'] = np.quantile(
            np.stack(chems[i]), 0.5, axis=0)

    maxx, maxy, offsets, err = model(max_logl)
    if binning:
        _, maxy = mean_regrid(maxx, maxy, newx=1e4 / um_xgrid)
    returns['max_logl_spectra'] = maxy
    returns['max_logl_error_inflation'] = err
    returns['max_logl_offsets'] = offsets
    if pressure_bands:
        returns['pressure'] = np.asarray(df['pressure'])
    returns['wavelength'] = um_xgrid
    return returns


def get_chisq_max(at_evaluations, data_dict):
    """Chi-squared of the max-logL spectrum vs each dataset
    (retrieval.py:313-368), including per-dataset offsets."""
    from .wavelength import mean_regrid
    from .analyze import chi_squared
    offsets = at_evaluations['max_logl_offsets'] or {}
    resultx = 1e4 / np.asarray(at_evaluations['wavelength'])
    resulty = np.asarray(at_evaluations['max_logl_spectra'])
    xs, ymod, ydat, edat = [], [], [], []
    for idata in data_dict.keys():
        off = offsets.get(idata, 0) if isinstance(offsets, dict) else 0
        x_chunk, y_chunk = mean_regrid(resultx, resulty,
                                       newx=data_dict[idata][0])
        xs.append(x_chunk)
        ymod.append(y_chunk)
        ydat.append(np.asarray(data_dict[idata][1]) + off)
        edat.append(np.asarray(data_dict[idata][2]))
    order = np.argsort(np.concatenate(xs))
    x = np.concatenate(xs)[order]
    m = np.concatenate(ymod)[order]
    d = np.concatenate(ydat)[order]
    e = np.concatenate(edat)[order]
    chisq = chi_squared(d, e, m) / len(d)
    return {'wavenumber': x, 'model': m, 'datay': d, 'datae': e,
            'chisq_per_datapt': chisq}


def plot_spectra_bands(evaluations_dat, colors=('C0', 'C0'), ax=None,
                       subplots_kwargs=None, R=None):
    """Posterior spectral bands + median + max-logL spectrum
    (retrieval.py:370-406) from a :func:`get_evaluations` dict.

    Returns (fig, ax); pass R to re-bin for display.
    """
    import matplotlib.pyplot as plt

    from .wavelength import mean_regrid

    fig = None
    if ax is None:
        fig, ax = plt.subplots(**(subplots_kwargs or {}))
    um = np.asarray(evaluations_dat['wavelength'])
    bands = evaluations_dat['bands_spectra']

    def rebin(y):
        if isinstance(R, (int, float)):
            wno, yy = mean_regrid(1e4 / um, y, R=float(R))
            return 1e4 / wno, yy
        return um, y

    for i in (2, 1):
        x, lo = rebin(bands[f'{i}sig_lo'])
        _, hi = rebin(bands[f'{i}sig_hi'])
        ax.fill_between(x, lo, hi, color=colors[i - 1], alpha=0.2,
                        label=f'{i} sigma')
    x, med = rebin(bands['median'])
    ax.plot(x, med, color='k', lw=1, label='median')
    x, mx = rebin(np.asarray(evaluations_dat['max_logl_spectra']))
    ax.plot(x, mx, color='r', lw=0.8, label='max logL')
    ax.set_xlabel('wavelength [um]')
    ax.legend(fontsize=8)
    return fig, ax


def plot_pressure_bands(evaluations_dat, key, colors=('C0', 'C0'),
                        ax=None, subplots_kwargs=None, log_x=None):
    """Posterior pressure-profile bands for one quantity
    (retrieval.py:407-455): ``key`` is 'temperature' or a molecule from
    get_evaluations' ``pressure_bands``.  Returns (fig, ax).
    """
    import matplotlib.pyplot as plt

    fig = None
    if ax is None:
        fig, ax = plt.subplots(**(subplots_kwargs or {}))
    pressure = np.asarray(evaluations_dat['pressure'])
    bands = evaluations_dat['bands_ptchem'][key]
    for i in (2, 1):
        ax.fill_betweenx(pressure, bands[f'{i}sig_lo'],
                         bands[f'{i}sig_hi'], color=colors[i - 1],
                         alpha=0.2, label=f'{i} sigma')
    ax.plot(bands['median'], pressure, color='k', lw=1, label='median')
    ax.plot(np.asarray(evaluations_dat['max_logl_ptchem'][key]), pressure,
            color='r', lw=0.8, label='max logL')
    ax.set_yscale('log')
    if log_x or (log_x is None and key != 'temperature'):
        ax.set_xscale('log')
    ax.invert_yaxis()
    ax.set_ylabel('pressure [bar]')
    ax.set_xlabel(key)
    ax.legend(fontsize=8)
    return fig, ax
