"""Model-grid fitting and analysis (the reference ``analyze.py`` layer).

Copy of ``picaso_tpu/analyze.py`` for the PyTorch port, which must not
import the JAX package.  ``GridFitter`` chi-square fits grids of
precomputed models (in-memory arrays, or a directory of .h5 files and
xarray NetCDF files read with h5py and the port's ``ncio``) to data with
an optional additive offset per dataset, converts chi-square to posterior
weights and interpolates between grid members ("gridtrieval");
``detection_test`` compares the evidences of nested-sampling fits.  Host
numpy and scipy, the arithmetic of the JAX module; the grid parameters are
a dict of numpy columns (a DataFrame there; any mapping of column name to
values is taken).  The plots (``plot_best_fit``, ``plot_chi_posteriors``,
``plot_atmosphere``) import matplotlib inside each function.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def _param_table(grid_parameters):
    """Grid parameters as {name: numpy column}; None as no columns."""
    if grid_parameters is None:
        return {}
    return {str(k): np.asarray(grid_parameters[k])
            for k in grid_parameters.keys()}


def _table_from_rows(rows):
    """A list of {name: value} rows as {name: column}, the names in the
    order they first appear and a missing value NaN (``pd.DataFrame(rows)``
    of numbers)."""
    names = []
    for row in rows:
        names += [k for k in row if k not in names]
    return {k: np.asarray([row.get(k, np.nan) for row in rows])
            for k in names}


def _row(table, i):
    """Row ``i`` of a table of columns as {name: value}."""
    return {k: v[i] for k, v in table.items()}


def _matrix(table, names):
    """The columns ``names`` as a float [nrows, len(names)] array."""
    return np.column_stack([np.asarray(table[n], dtype=float)
                            for n in names])


__all__ = ['GridFitter', 'chi_squared', 'detection_test', 'sigma']


def chi_squared(data_y, data_e, model_y):
    """Reduced-chi-square free chi2 (analyze.py:1315)."""
    return np.sum((data_y - model_y) ** 2 / data_e ** 2, axis=-1)


class GridFitter:
    """Fit grids of models to spectra (analyze.py:30-922)."""

    def __init__(self, grid_name, location=None, models=None,
                 grid_parameters=None, verbose=True):
        """Either point at a directory of .h5/.nc models or pass arrays
        directly via ``models`` (dict with 'wavenumber' [nwno], 'spectra'
        [nmodels, nwno]) + ``grid_parameters`` (a mapping of parameter name
        to [nmodels] values, kept as a dict of numpy columns).
        """
        self.grid_name = grid_name
        self.grids = [grid_name]
        self.fit_results = {}
        self.verbose = verbose
        self._store = {}    # grid_name -> flat-attribute snapshot
        self.data = {}      # data_name -> dataset dict (add_data)
        if models is not None:
            self.wavenumber = np.asarray(models['wavenumber'])
            self.spectra = np.asarray(models['spectra'])
            self.grid_params = _param_table(grid_parameters)
            self.list_of_files = list(range(len(self.spectra)))
        elif location is not None:
            self.load_grid(location)
        else:
            raise ValueError('give location= or models=')
        self._store[grid_name] = self._flat()

    def _flat(self):
        return {'wavenumber': self.wavenumber, 'spectra': self.spectra,
                'grid_params': self.grid_params,
                'files': self.list_of_files}

    def _use(self, grid_name):
        """Point the flat attributes at a named grid (no-op for names
        that predate add_grid)."""
        g = self._store.get(grid_name)
        if g is not None:
            self.wavenumber = g['wavenumber']
            self.spectra = g['spectra']
            self.grid_params = g['grid_params']
            self.list_of_files = g['files']

    # -- reference multi-grid accumulation API (analyze.py:92-183) ----------
    def find_grid(self, grid_name, model_dir):
        """Validate a model directory and record its file list
        (analyze.py:98-112)."""
        if not os.path.isdir(model_dir):
            raise ValueError(f'model directory does not exist: '
                             f'{model_dir}')
        files = sorted(glob.glob(os.path.join(model_dir, '*.h5'))
                       + glob.glob(os.path.join(model_dir, '*.nc')))
        if not files:
            raise ValueError(f'no .h5/.nc models found in {model_dir}')
        if self.verbose:
            print(f'Total number of models in grid is {len(files)}')
        return files

    def add_grid(self, grid_name, model_dir, to_fit='fpfs_thermal',
                 **_ignored):
        """Accumulate another named model grid (analyze.py:112-118);
        ``to_fit`` is the stored spectra key (e.g. 'transit_depth')."""
        self.find_grid(grid_name, model_dir)
        self.load_grid(model_dir, spectra_key=to_fit)
        if grid_name not in self.grids:
            self.grids.append(grid_name)
        self._store[grid_name] = self._flat()

    def add_data(self, data_name, wlgrid_center, wlgrid_width, y_data,
                 e_data):
        """Register a named dataset so fits can refer to it by name
        (analyze.py:119-143)."""
        self.data[data_name] = {
            'wlgrid_center': np.asarray(wlgrid_center),
            'wlgrid_width': np.asarray(wlgrid_width),
            'y_data': np.asarray(y_data),
            'e_data': np.asarray(e_data)}

    def fit_all(self, offset=False):
        """Fit every added grid against every added dataset
        (analyze.py:144-150)."""
        for g in self.grids:
            if g not in self._store:
                continue
            for d in self.data:
                self.fit_grid(g, d, offset=offset)
        return self.fit_results

    def check_square(self, grid_name=None):
        """True when the parameter table is a full factorial grid
        (analyze.py:151-183)."""
        self._use(grid_name or self.grid_name)
        if not self.grid_params:
            return True
        n = 1
        for c in self.grid_params:
            n *= len(np.unique(self.grid_params[c]))
        return n == len(next(iter(self.grid_params.values())))

    def as_dict(self):
        """Serializable snapshot of grids + fit results
        (analyze.py as_dict)."""
        return {'grids': list(self.grids),
                'data': {k: {kk: np.asarray(vv).tolist()
                             for kk, vv in v.items()}
                         for k, v in self.data.items()},
                'fit_results': self.fit_results}

    def load_grid(self, location, spectra_key='fpfs_thermal'):
        """Load every stored model in a directory (analyze.py:184).

        Accepts both this package's .h5 layout and community xarray
        NetCDF model grids (.nc, the reference's GridFitter format); h5py
        is imported for the .h5 files only."""
        files = sorted(glob.glob(os.path.join(location, '*.h5'))
                       + glob.glob(os.path.join(location, '*.nc')))
        if not files:
            raise ValueError(f'no .h5/.nc models found in {location}')
        # stored-name aliases used by reference-written NetCDF grids
        nc_aliases = {'fpfs_thermal': 'fpfs_emission',
                      'thermal': 'flux_emission'}
        spectra, rows = [], []
        wavenumber = None
        n_regridded = 0

        def _onto_common(wno, spec):
            # all members must share ONE wavenumber axis; a member on a
            # different grid (mixed .h5/.nc dirs, mixed resolutions) is
            # interpolated onto the first file's axis instead of being
            # silently stacked against the wrong coordinates
            nonlocal wavenumber, n_regridded
            if wavenumber is None:
                wavenumber = wno
                return spec
            if len(wno) == len(wavenumber) and np.allclose(
                    wno, wavenumber):
                return spec
            n_regridded += 1
            return np.interp(wavenumber, wno, spec)

        for fn in files:
            if fn.endswith('.nc'):
                from .ncio import read_netcdf
                import json as _json
                ds = read_netcdf(fn)
                wno_f = np.sort(1e4 / ds.coords['wavelength'].values)
                key = spectra_key if spectra_key in ds.data_vars else \
                    nc_aliases.get(spectra_key, spectra_key)
                if key not in ds.data_vars:
                    key = [k for k, v in ds.data_vars.items()
                           if v.dims == ('wavelength',)][0]
                order = np.argsort(1e4 / ds.coords['wavelength'].values)
                spectra.append(_onto_common(wno_f, ds[key].values[order]))
                row = {}
                for k, v in ds.attrs.items():
                    if isinstance(v, str) and v.lstrip().startswith('{'):
                        try:
                            row.update({f'{k}.{kk}': vv for kk, vv in
                                        _json.loads(v).items()})
                            continue
                        except ValueError:
                            pass
                    row[k] = v
                rows.append(row)
            else:
                import h5py
                with h5py.File(fn, 'r') as f:
                    wno_f = np.asarray(f['spectra']['wavenumber'])
                    keys = list(f['spectra'])
                    key = spectra_key if spectra_key in keys else [
                        k for k in keys if k != 'wavenumber'][0]
                    spectra.append(_onto_common(
                        wno_f, np.asarray(f['spectra'][key])))
                    rows.append(dict(f.attrs))
        self.wavenumber = wavenumber
        self.spectra = np.asarray(spectra)
        self.grid_params = _table_from_rows(rows)
        self.list_of_files = files
        if self.verbose:
            note = (f' ({n_regridded} interpolated onto the first '
                    'file\'s wavenumber axis)' if n_regridded else '')
            print(f'loaded {len(files)} models from {location}{note}')

    def load_grid_params(self, location, spectra_key='fpfs_thermal'):
        """Reference-name alias of :meth:`load_grid` (analyze.py:184)."""
        return self.load_grid(location, spectra_key=spectra_key)

    def fit_grid(self, grid_name, data_name, wlgrid_center=None,
                 y_data=None, e_data=None, offset=False):
        """Chi-square fit of every grid member to a dataset
        (analyze.py:305-388).

        wlgrid_center in micron; models are binned onto the data grid.
        With ``offset`` a per-model additive shift minimizing chi2 is fit
        analytically.  Omit the data arrays to fit a dataset previously
        registered with :meth:`add_data` under ``data_name``.
        """
        self._use(grid_name)
        if wlgrid_center is None:
            ds = self.data[data_name]
            wlgrid_center = ds['wlgrid_center']
            y_data, e_data = ds['y_data'], ds['e_data']
        wl = np.asarray(wlgrid_center)
        y = np.asarray(y_data)
        e = np.asarray(e_data)
        data_wno = np.sort(1e4 / wl)

        # map each data wavelength to its bin in the ascending-wno grid
        pos = np.searchsorted(data_wno, 1e4 / wl)
        pos = np.clip(pos, 0, len(data_wno) - 1)
        # ONE binned_statistic over the whole [nmodels, nwno] matrix
        # (same edge construction as wavelength.mean_regrid) instead of
        # re-binning the shared wavenumber axis once per model
        from scipy.stats import binned_statistic
        d = np.diff(data_wno)
        edges = np.concatenate([[data_wno[0] - d[0] / 2.0],
                                data_wno[:-1] + d / 2.0,
                                [data_wno[-1] + d[-1] / 2.0]])
        stat, _, _ = binned_statistic(self.wavenumber, self.spectra,
                                      bins=edges)
        stat = np.atleast_2d(stat)
        row_mean = np.nanmean(stat, axis=1, keepdims=True)
        stat = np.where(np.isnan(stat), row_mean, stat)
        binned = stat[:, pos]

        if offset:
            # analytic offset: shift = weighted mean residual
            wgt = 1.0 / e ** 2
            shift = ((y[None, :] - binned) * wgt).sum(1) / wgt.sum()
            binned = binned + shift[:, None]
            offsets = shift
        else:
            offsets = np.zeros(len(binned))

        chi2 = chi_squared(y[None, :], e[None, :], binned)
        rank = np.argsort(chi2)
        res = self.fit_results.setdefault(grid_name, {})
        res[data_name] = {
            'chi_sq': chi2, 'rank_order': rank, 'offsets': offsets,
            'best_fit_index': int(rank[0]),
            'chi_sq_best': float(chi2[rank[0]]),
            'binned_models': binned, 'wlgrid_center': wl,
            'y_data': y, 'e_data': e,
            'posterior_weights': self.chi2_posteriors(chi2),
        }
        if self.verbose:
            print(f'best chi2 = {chi2[rank[0]]:.2f} at grid index '
                  f'{rank[0]}')
        return res[data_name]

    @staticmethod
    def chi2_posteriors(chi2):
        """Relative posterior probability exp(-chi2/2) (analyze.py:515)."""
        w = np.exp(-0.5 * (np.asarray(chi2) - np.min(chi2)))
        return w / w.sum()

    def best_fit(self, grid_name, data_name):
        self._use(grid_name)
        res = self.fit_results[grid_name][data_name]
        i = res['best_fit_index']
        out = {'index': i, 'chi_sq': res['chi_sq'][i],
               'offset': res['offsets'][i],
               'spectrum': res['binned_models'][i]}
        if len(self.spectra):
            out['parameters'] = _row(self.grid_params, i)
        return out

    def parameter_posteriors(self, grid_name, data_name, parameter):
        """Marginalized posterior over one grid parameter."""
        self._use(grid_name)
        res = self.fit_results[grid_name][data_name]
        w = res['posterior_weights']
        vals = np.asarray(self.grid_params[parameter], dtype=float)
        uniq = np.unique(vals)
        probs = np.array([w[vals == v].sum() for v in uniq])
        return uniq, probs / probs.sum()

    # reference naming (analyze.py:515-546)
    get_chi_posteriors = parameter_posteriors

    def print_best_fit(self, grid_name, data_name, verbose=True):
        """Best-fit parameter table (analyze.py:389-406).

        Returns {parameter: best value} at the lowest-chi2 grid member.
        """
        self._use(grid_name)
        res = self.fit_results[grid_name][data_name]
        i = res['best_fit_index']
        best_fits = {}
        for key in self.grid_params.keys():
            val = self.grid_params[key][i]
            if verbose:
                print(f'{key}={val}')
            best_fits[key] = val
        return best_fits

    def plot_best_fit(self, grid_names, data_names, plot_kwargs=None):
        """Best-fit spectra over the data + a residual panel
        (analyze.py:408-511, matplotlib instead of the reference's
        style-sheet block).  Returns (fig, {'A': spectrum axis,
        'B': residual axis})."""
        import matplotlib.pyplot as plt

        plot_kwargs = plot_kwargs or {}
        if isinstance(grid_names, str):
            grid_names = [grid_names]
        if isinstance(data_names, str):
            data_names = [data_names]
        fig, (ax_a, ax_b) = plt.subplots(
            2, 1, figsize=plot_kwargs.get('figsize', (10, 7)),
            sharex=True, gridspec_kw={'height_ratios': [4, 1]})
        for igrid in grid_names:
            for idata in data_names:
                res = self.fit_results[igrid][idata]
                i = res['best_fit_index']
                wl = res['wlgrid_center']
                best = res['binned_models'][i]
                chi1 = res['chi_sq'][i]
                line, = ax_a.plot(
                    wl, best, lw=2,
                    label=(f'best fit {igrid}+{idata}, '
                           f'$\\chi^2$={chi1:.2f}'))
                if 'y_data' in res:
                    resid = (res['y_data'] - best) / res['e_data']
                    ax_b.plot(wl, resid, 'o', ms=4,
                              color=line.get_color())
        for idata in data_names:
            for igrid in grid_names:
                res = self.fit_results[igrid][idata]
                if 'y_data' in res:
                    ax_a.errorbar(res['wlgrid_center'], res['y_data'],
                                  yerr=res['e_data'], fmt='o', ms=4,
                                  color='k', label=idata)
                    break
        ax_b.axhline(0.0, color='k', lw=1)
        ax_b.set_xlabel(plot_kwargs.get('xlabel',
                                        r'wavelength [$\mu$m]'))
        ax_a.set_ylabel(plot_kwargs.get('ylabel', 'spectrum'))
        ax_b.set_ylabel(r'$\delta/N$')
        ax_a.legend(fontsize=9)
        return fig, {'A': ax_a, 'B': ax_b}

    def plot_chi_posteriors(self, grid_names, data_name, max_row=None,
                            max_col=3, input_parameters='all'):
        """Marginal chi2 posteriors for each grid parameter
        (analyze.py:548-612).  Returns (fig, {parameter: (values,
        probabilities)})."""
        import matplotlib.pyplot as plt

        if isinstance(grid_names, str):
            grid_names = [grid_names]
        if input_parameters == 'all':
            # enumerate parameters from the REQUESTED grids, not from
            # wherever the flat attributes happen to point
            params = []
            for igrid in grid_names:
                self._use(igrid)
                for k in self.grid_params.keys():
                    if k not in params and np.issubdtype(np.asarray(
                            self.grid_params[k]).dtype, np.number):
                        params.append(k)
        else:
            params = list(input_parameters)
        n = len(params)
        ncol = min(max_col, max(n, 1))
        nrow = max_row or int(np.ceil(n / ncol))
        fig, axes = plt.subplots(nrow, ncol,
                                 figsize=(3.2 * ncol, 2.6 * nrow),
                                 squeeze=False)
        out = {}
        for k, par in enumerate(params):
            ax = axes[k // ncol][k % ncol]
            for igrid in grid_names:
                self._use(igrid)
                if par not in self.grid_params.keys():
                    continue                    # parameter not in this grid
                vals, prob = self.parameter_posteriors(igrid, data_name,
                                                       par)
                ax.plot(vals, prob, 'o-', label=igrid)
                # keyed per grid when several are overlaid
                out_key = par if len(grid_names) == 1 else (igrid, par)
                out[out_key] = (vals, prob)
            ax.set_xlabel(par)
            ax.set_ylabel('probability')
        for k in range(n, nrow * ncol):
            axes[k // ncol][k % ncol].axis('off')
        if len(grid_names) > 1:
            axes[0][0].legend(fontsize=8)
        fig.tight_layout()
        return fig, out

    def prep_gridtrieval(self, parameters):
        """Index a full-factorial model grid for multilinear interpolation.

        Port of the reference gridtrieval prep (analyze.py:709-1063):
        builds sorted unique axis values per parameter and the row-index
        lattice; raises if the grid is not a complete cartesian product
        (use interp_models for scattered grids).
        """
        P = _matrix(self.grid_params, parameters)
        axes = [np.unique(P[:, j]) for j in range(P.shape[1])]
        shape = tuple(len(a) for a in axes)
        if int(np.prod(shape)) != P.shape[0]:
            raise ValueError(
                f'grid is not full-factorial: {shape} vs {P.shape[0]} '
                'members; use interp_models')
        lattice = np.full(shape, -1, dtype=int)
        for row in range(P.shape[0]):
            idx = tuple(int(np.searchsorted(axes[j], P[row, j]))
                        for j in range(P.shape[1]))
            lattice[idx] = row
        if (lattice < 0).any():
            raise ValueError('duplicate or missing grid members')
        self._gridtrieval = dict(parameters=list(parameters), axes=axes,
                                 lattice=lattice)
        return axes

    def custom_interp(self, point):
        """Multilinear interpolation of grid spectra at ``point``.

        Requires prep_gridtrieval first; clamps outside the hull.  This
        is the continuous forward model for retrievals over grid
        parameters ("gridtrieval", analyze.py:709-1063).
        """
        g = self._gridtrieval
        axes, lattice = g['axes'], g['lattice']
        nd = len(axes)
        los, ws = [], []
        for j, a in enumerate(axes):
            x = float(np.clip(point[j], a[0], a[-1]))
            hi = int(np.clip(np.searchsorted(a, x), 1, len(a) - 1))
            lo = hi - 1
            w = 0.0 if a[hi] == a[lo] else (x - a[lo]) / (a[hi] - a[lo])
            los.append(lo)
            ws.append(w)
        out = 0.0
        for corner in range(1 << nd):
            idx, weight = [], 1.0
            for j in range(nd):
                bit = (corner >> j) & 1
                idx.append(min(los[j] + bit, len(axes[j]) - 1))
                weight *= ws[j] if bit else (1.0 - ws[j])
            if weight:
                out = out + weight * self.spectra[lattice[tuple(idx)]]
        return out

    def interp_models(self, parameters, point):
        """Inverse-distance interpolation between grid members in
        normalized parameter space ('gridtrieval', analyze.py:709-1063)."""
        P = _matrix(self.grid_params, parameters)
        lo, hi = P.min(0), P.max(0)
        span = np.where(hi > lo, hi - lo, 1.0)
        Pn = (P - lo) / span
        q = (np.asarray(point, dtype=float) - lo) / span
        d = np.sqrt(((Pn - q[None, :]) ** 2).sum(1))
        if d.min() < 1e-12:
            return self.spectra[int(np.argmin(d))]
        w = 1.0 / d ** 2
        w /= w.sum()
        return (w[:, None] * self.spectra).sum(0)


def plot_atmosphere(location, bf_filename, gas_names=None, fig=None,
                    ax=None, linestyle=None, color=None, label=None):
    """PT profile + gas mixing ratios from a saved model file
    (analyze.py:1339-1460).

    Reads a NetCDF model written by justdoit.output_xarray /
    io_utils.save_model_nc (profile columns on the 'pressure' coord).
    Returns (fig, ax); pass fig/ax to overlay several best fits.
    """
    import matplotlib.pyplot as plt

    from .ncio import read_netcdf

    ds = read_netcdf(os.path.join(location, bf_filename))
    pressure = np.asarray(ds.coords['pressure'].values)
    temp = np.asarray(ds['temperature'].values)
    if gas_names is None:
        gas_names = [k for k, v in ds.data_vars.items()
                     if v.dims == ('pressure',) and k != 'temperature']
    if ax is None:
        fig, ax = plt.subplots(1, 2, figsize=(9, 4), sharey=True)
    axT, axX = ax
    axT.semilogy(temp, pressure, linestyle or '-',
                 color=color or 'k', label=label)
    if not axT.yaxis_inverted():
        axT.invert_yaxis()
    axT.set_xlabel('temperature [K]')
    axT.set_ylabel('pressure [bar]')
    for gas in gas_names:
        if gas not in ds.data_vars:
            continue
        vmr = np.asarray(ds[gas].values)
        axX.loglog(np.clip(vmr, 1e-30, None), pressure,
                   linestyle or '-', label=f'{label} {gas}'.strip()
                   if label else gas)
    axX.set_xlabel('volume mixing ratio')
    axX.set_xlim(1e-12, 1.5)
    axX.legend(fontsize=7)
    if label:
        axT.legend(fontsize=8)
    if fig is None:                   # overlay call: caller passed ax only
        fig = axT.get_figure()
    fig.tight_layout()
    return fig, ax


def sigma(lnz1, lnz2):
    """Bayes factor -> detection significance (Trotta 2008, Table 2).

    Port of analyze.py:1487-1523: solves B = -1/(e p ln p) for the
    p-value and converts to Gaussian sigma via the complementary error
    function.  Returns (sigma, lnB).
    """
    from scipy import special

    lnB = lnz1 - lnz2
    # B(p) = -1/(e p ln p) is only invertible on p <= 1/e; the branch
    # above 1/e makes the interpolation grid non-monotonic, which in the
    # reference (analyze.py:1513-1522) silently clamps every weak
    # detection (B < ~2) to a constant ~0.26 sigma.  Restricting the
    # grid to the invertible branch gives the intended Trotta relation;
    # strong detections agree with the reference to float precision.
    logp = np.arange(-300.0, np.log10(1.0 / np.e), 0.1)[::-1]
    P = 10.0 ** logp
    Barr = -1.0 / (np.e * P * np.log(P))
    sig_grid = np.arange(0.1, 100.1, 0.01)
    p_p = special.erfc(sig_grid / np.sqrt(2.0))
    B = np.exp(lnB)
    pvalue = 10.0 ** np.interp(np.log10(B), np.log10(Barr), np.log10(P))
    sig = np.interp(pvalue, p_p[::-1], sig_grid[::-1])
    return sig, lnB


def detection_test(wlgrid_center, y_data, e_data, model_full,
                   model_exclude, min_wavelength, max_wavelength,
                   molecule_baseline=None, baseline_wavelength=(),
                   nlive=200, max_iter=4000, seed=0, verbose=False):
    """Gaussian-feature detection significance on molecular residuals.

    Port of analyze.py:1065-1285's evidence comparison: fits a Gaussian
    (and optionally a double Gaussian when a baseline molecule window is
    given) and a flat line to ``y_data - model_exclude`` with nested
    sampling, and converts the evidence ratios into detection sigmas.
    Unlike the reference (which reruns the forward model internally with
    ``exclude_mol`` via dynesty), the with/without-molecule spectra are
    passed in regridded to the data wavelength grid — compute them with
    ``inputs.atmosphere(..., exclude_mol=molecule)`` + ``spectrum`` —
    and the sampler is the framework's vectorized nested sampler.

    Returns a dict with logZ_{single,double,line}, samp_* equal-weight
    posteriors, sigma_single_v_line / lnB_single_v_line (and
    sigma_double_v_single when applicable).
    """
    from .sampler import nested_sample

    wl = np.asarray(wlgrid_center, float)
    residual_data = np.asarray(y_data, float) - np.asarray(model_exclude,
                                                           float)
    e = np.asarray(e_data, float)
    double_gauss = molecule_baseline is not None
    if double_gauss and len(baseline_wavelength) == 2:
        min_wl_add, max_wl_add = sorted(baseline_wavelength)
    else:
        min_wl_add, max_wl_add = min_wavelength, max_wavelength

    def model_gauss(th):
        logAmp, lam0, logsig, cst = (th[..., 0], th[..., 1], th[..., 2],
                                     th[..., 3])
        return (10.0 ** logAmp[..., None]
                * np.exp(-(wl - lam0[..., None]) ** 2
                         / (10.0 ** logsig[..., None]) ** 2)
                + cst[..., None]) / 1e6

    def loglike_gauss(th):
        th = np.atleast_2d(th)
        mod = model_gauss(th)
        return -0.5 * np.sum((residual_data - mod) ** 2 / e ** 2, axis=-1)

    def prior_gauss(u):
        u = np.atleast_2d(u).copy()
        u[..., 0] = -1 + 5.5 * u[..., 0]
        u[..., 1] = min_wavelength + (max_wavelength
                                      - min_wavelength) * u[..., 1]
        u[..., 2] = -2 + 3.0 * u[..., 2]
        u[..., 3] = -200 + 400 * u[..., 3]
        return u

    def loglike_double(th):
        th = np.atleast_2d(th)
        mod = model_gauss(th[..., :4]) + model_gauss(th[..., 4:])
        return -0.5 * np.sum((residual_data - mod) ** 2 / e ** 2, axis=-1)

    def prior_double(u):
        u = np.atleast_2d(u).copy()
        out1 = prior_gauss(u[..., :4])
        out2 = prior_gauss(u[..., 4:])
        out2[..., 1] = min_wl_add + (max_wl_add - min_wl_add) \
            * (out2[..., 1] - min_wavelength) / max(
                max_wavelength - min_wavelength, 1e-30)
        return np.concatenate([out1, out2], axis=-1)

    def loglike_line(th):
        th = np.atleast_2d(th)
        mod = th[..., 0:1] / 1e6
        return -0.5 * np.sum((residual_data - mod) ** 2 / e ** 2, axis=-1)

    def prior_line(u):
        u = np.atleast_2d(u).copy()
        u[..., 0] = -200 + 2000 * u[..., 0]
        return u

    results = {'residual_data': residual_data,
               'residual_model': np.asarray(model_full, float)
               - np.asarray(model_exclude, float)}
    runs = [('single', loglike_gauss, prior_gauss, 4),
            ('line', loglike_line, prior_line, 1)]
    if double_gauss:
        runs.insert(0, ('double', loglike_double, prior_double, 8))
    for name, ll, pt, ndim in runs:
        res = nested_sample(ll, pt, ndim, nlive=nlive, max_iter=max_iter,
                            seed=seed, verbose=verbose)
        results[f'logZ_{name}'] = float(res.logz)
        results[f'samp_{name}'] = np.asarray(res.samples_equal)
    results['sigma_single_v_line'], results['lnB_single_v_line'] = sigma(
        results['logZ_single'], results['logZ_line'])
    if double_gauss:
        (results['sigma_double_v_single'],
         results['lnB_double_v_single']) = sigma(results['logZ_double'],
                                                 results['logZ_single'])
    return results
