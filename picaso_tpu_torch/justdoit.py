"""User-facing API: opacity connection, scene construction, spectra.

Port of the spectrum half of ``picaso_tpu/justdoit.py`` (the reference's
``justdoit``): ``opannection()`` + ``inputs().phase_angle / gravity / star /
atmosphere / clouds / approx / spectrum()``, 3D spectra (``three_d``) and
phase curves (``atmosphere_4d``, ``clouds_4d``, ``phase_curve``).  The
scene is built on the host with numpy, as in the JAX package; the optics
and the solves run on the opacity connection's device (``opannection``'s
``device=``, the card unless the caller asks for the CPU).

Where the JAX package runs an XLA function whose counterpart in the port is
a hand-written kernel, this module calls the kernel's wrapper (the kernel
on CUDA tensors, its plain twin on CPU tensors):

* the molecular opacity of ``_gas_optics``: K1 ``cuda_interp.interp_tau``,
  or K8 ``interp_tau_q`` on a connection made with ``blocked='int16'``;
  the ``exclude_mol`` multipliers fold into its column weights.
  ``query_method='nearest'`` stays plain torch, as in the JAX package;
* the Toon reflected solve: K5 ``cuda_toon.reflected_toon_props`` on the
  RTProps of :func:`compute_rtprops` (the arguments of the JAX package's
  ``toon.reflected_1d``);
* the Toon thermal solve: K6 ``cuda_toon.thermal_toon_props``, its level
  Planck function computed as the JAX ``toon.thermal_1d`` computes it.

Each correlated-k gauss point and each patchy-cloud (``do_holes``) prop set
is one K5 and one K6 launch.  No kernel exists for these, which run plain
torch as the JAX package runs them in XLA: the level fluxes of
``approx(get_lvl_flux=True)`` (``toon.reflected_1d(get_lvl_flux=True)``,
``toon.thermal_levels``), the SH solves from RTProps (``rt.sh``; the SH
kernels take fused optics only), Rayleigh, continuum, Raman, transit and
the disk integration.  The batched phase curve builds one scene per phase
(``pipeline.scene_from_case``) and runs ``pipeline.forward_batch``, whose
kernels are ``pipeline.forward``'s (K1 with K2, K3 or K4, or the SH
kernels).

No pandas: a profile is a dict of numpy columns sorted by pressure.
``atmosphere`` and ``clouds`` take any mapping of column name to array (a
DataFrame is one) or a whitespace-separated file with a header line, read
with numpy.  GCM input (``atmosphere_3d``, ``atmosphere_4d``,
``clouds_4d``) takes a dict, a NetCDF path or an ``ncio.NCDataset``.

The equilibrium-chemistry handlers (``premix_atmosphere``,
``chemeq_visscher_1060``/``_2121``, ``channon_grid_low``, ``chemeq_3d``,
``premix_3d``, ``atmosphere(chem_method=...)``) interpolate the Visscher
grids or a CK table's ``full_abunds`` with ``chemistry.chem_interp`` on a
device: the connection's for the premixed table, else ``device=`` (the
card unless the caller asks for the CPU).  The grid files are read with
numpy.

The climate glue (``inputs(climate=True)``, ``inputs_climate``,
``energy_injection``, ``interpret_run``, ``climate`` over
``climate.api.run_climate``, the star's climate binning), the clouds from
microphysics (``virga``, ``virga_3d`` over ``virga.py``, host numpy) and
the disequilibrium adjustments of a profile (``find_kzz``,
``adjust_quench_chemistry``, ``volatile_rainout``, ``cold_trap`` over
``chemistry.py``) are ported; a CK connection may carry per-gas tables
(resort-rebin), and ``opannection(ck_db=...)`` reads one from files
(``opacities.ck.load_ck_db``).

The tools around a spectrum: the profile helpers (``guillot_pt``,
``TP_line_earth``, ``pressure_grid``), ``get_contribution`` (on the
connection's device, plain torch) and ``find_press``,
``convert_flux_units`` and ``check_units``, the evolution tracks
(``evolution_track``, ``young_planets``, numpy over
``refdata/evolution``), and model save and load (``output_xarray``,
``input_xarray`` over ``io_utils``, ``merge_xarrays``).  Photochemistry
(``atmosphere(photochem_init_args=...)``, ``photochem_init``,
``premix_atmosphere_photochem``, ``photochem.py``) and device meshes
(``phase_curve(mesh=...)``, ``climate(mesh=...)``, ``parallel.py``) are
ported.  Not ported (ROADMAP Queue 1, blocked): the Sonora profiles and
the planet catalogue (``get_targets``/``load_planet``, which need the
network).
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from . import checked_device, chemistry, default_dtype
from . import disco as disco_mod
from . import raman as raman_mod
from . import rayleigh as rayleigh_mod
from . import units as u
from .atmosphere import Atmosphere, build_atmosphere
from .constants import G_GRAV, PCONV, PLANCK_C1, PLANCK_C2, SB_SIGMA
from .opacities import assemble
from .opacities.cuda_interp import interp_tau, interp_tau_q
from .opacities.db import (OpacityGrid, _find_indices,
                           interp_molecular_nearest, load_opacity_db,
                           nearest_continuum)
from .optics import RTProps, combine_optics
from .refdata import external_refdata, load_default_config, refdata_path
from .rt import cuda_toon, toon
from .rt.cuda_toon import REFLECTED_FIELDS
from .rt.transit import transit_depth
from .wavelength import get_cld_input_grid, mean_regrid

__all__ = ['Opacity', 'opannection', 'inputs', 'picaso', 'compute_rtprops',
           'jupiter_pt', 'jupiter_cld', 'HJ_pt', 'HJ_cld', 'brown_dwarf_pt',
           'brown_dwarf_cld', 'single_phase_options', 'multi_phase_options',
           'raman_options', 'toon_phase_coefficients',
           'rt_methodology_options', 'stream_options', 'mean_regrid', 'u',
           'w17_data', 'get_contribution', 'find_press', 'evolution_track',
           'young_planets', 'convert_flux_units', 'check_units',
           'output_xarray', 'input_xarray', 'merge_xarrays']

_trapz = getattr(np, 'trapezoid', None) or np.trapz


# ---------------------------------------------------------------------------
# option enumerators (index = integer enum used by the kernels)
# ---------------------------------------------------------------------------

def single_phase_options(printout=True):
    return ['cahoy', 'OTHG', 'TTHG', 'TTHG_ray']


def multi_phase_options(printout=True):
    return ['N=2', 'N=1', 'isotropic']


def raman_options():
    return ['oklopcic', 'pollack', 'none']


def toon_phase_coefficients(printout=True):
    return ['quadrature', 'eddington']


def rt_methodology_options(printout=True):
    return ['toon', 'SH']


def stream_options(printout=True):
    return [2, 4]


def SH_scattering_options(printout=True):
    return ['TTHG', 'OTHG', 'isotropic']


def SH_rayleigh_options(printout=True):
    return ['off', 'on']


def SH_psingle_form_options(printout=True):
    return ['explicit', 'legendre']


def SH_calculate_fluxes_options(printout=True):
    return ['off', 'on']


def _not_ported(what, item):
    return NotImplementedError(f'{what} is not ported to picaso_tpu_torch '
                               f'yet: ROADMAP Queue 1 {item}')


# ---------------------------------------------------------------------------
# opacity connection
# ---------------------------------------------------------------------------

class Opacity:
    """Connected opacity source: wavenumber grid + device-resident tables.

    ``grid`` (an ``OpacityGrid``) or ``ck`` (a premixed ``CKTable``) fixes
    the device; an analytic connection (neither) takes ``device``, which
    defaults to the card and raises where there is none.  The spectra run
    on that device in its dtype (float64 on the CPU, float32 on CUDA).
    """

    def __init__(self, wno, grid: OpacityGrid | None = None, raman_db=None,
                 ngauss=1, gauss_wts=None, ck=None, query_method='linear',
                 device='cuda'):
        if query_method not in ('linear', 'nearest'):
            raise ValueError("query_method must be 'linear' (4-point "
                             "bilinear, optics.py:2241) or 'nearest' "
                             "(optics.py:2310, the reference default)")
        if grid is not None:
            device = grid.wno.device
        elif ck is not None:
            device = ck.arrays.wno.device
        self.device = checked_device(device)
        self.dtype = default_dtype(self.device)
        self.query_method = query_method
        if isinstance(wno, torch.Tensor):
            wno = wno.detach().cpu().numpy()
        self.wno = np.asarray(wno, dtype=np.float64)
        self.wave = 1e4 / self.wno
        self.nwno = len(self.wno)
        self.ngauss = ngauss
        self.gauss_wts = (np.asarray(gauss_wts) if gauss_wts is not None
                          else np.array([1.0]))
        self.grid = grid
        self.ck = ck
        self.raman_db = (raman_db if raman_db is not None
                         else raman_mod.load_raman_db())
        self.molecules = (tuple(grid.molecules) if grid is not None
                          else (tuple(ck.molecules) if ck is not None else ()))
        self.avail_continuum = (
            list(grid.continuum_molecules) if grid is not None
            else (list(ck.continuum_molecules) if ck is not None else []))
        # rayleigh cross sections, once per grid (optics.py:2041-2046)
        self.rayleigh_molecules = rayleigh_mod.RAYLEIGH_MOLECULES
        self.rayleigh_opa = rayleigh_mod.rayleigh_sigma_table(self.wno)
        # their device stacks and the Pollack Raman row, made on first use
        self._rayleigh_sigma = {}
        self._pollack_row = None
        # stellar info bound by inputs.star()
        self.unshifted_stellar_spec = None
        self.relative_flux = None
        self.raman_stellar_shifts = None
        if ck is not None:
            self.delta_wno = np.asarray(ck.delta_wno)
        # the CK table the climate solve reads (opannection keeps the one
        # it was given: its spectra's copy may be float32)
        self.climate_ck = ck

    def tensor(self, x, dtype=None):
        """``x`` (numpy or a scalar) as a tensor on the connection's
        device, in its dtype unless ``dtype`` is given.  The array crosses
        to the device as it is and is converted there: a host-side
        float64 -> float32 pass over a [nlayer, nwno] array costs more
        than the copy."""
        return torch.as_tensor(np.asarray(x)).to(self.device).to(
            dtype or self.dtype)

    def rayleigh_sigma(self, species):
        """The Rayleigh cross sections of ``species`` [nspecies, nwno] on
        the device, stacked once per species list."""
        key = tuple(species)
        if key not in self._rayleigh_sigma:
            self._rayleigh_sigma[key] = self.tensor(np.stack(
                [self.rayleigh_opa[m] for m in key]))
        return self._rayleigh_sigma[key]

    def pollack_row(self):
        """The Pollack Raman factor [nwno] on the device (the rows of
        ``raman_factor_pollack`` are layer-independent), read once per
        connection."""
        if self._pollack_row is None:
            self._pollack_row = self.tensor(raman_mod.raman_factor_pollack(
                1, 1e4 / self.wno, refdata_dir=os.path.dirname(
                    os.path.dirname(refdata_path('opacities',
                                                 'raman.txt'))))[0])
        return self._pollack_row

    def preload_opacities(self, molecules=None):
        """API parity with optics.py:2126: the tables are already on the
        device, so this validates the request only."""
        if molecules and self.grid is not None:
            missing = [m for m in np.atleast_1d(molecules)
                       if m not in self.grid.molecules]
            if missing:
                raise ValueError(f'molecules not in database: {missing}')
        return self

    def compute_stellar_shifts(self, wno_star, flux_star):
        shifts, unshifted = raman_mod.compute_stellar_shifts(
            self.wno, self.raman_db, wno_star, flux_star)
        self.raman_stellar_shifts = shifts
        self.unshifted_stellar_spec = unshifted


def opannection(wave_range=None, filename_db=None, raman_db=None,
                resample=1, method='resampled', ck_db=None, wno_grid=None,
                molecules=None, verbose=True, ck_table=None,
                query_method='linear', blocked=False, device='cuda',
                **kwargs):
    """Connect to an opacity source (justdoit.py:163-226 of the JAX
    package) on ``device`` (default the card; raises where there is none).

    filename_db : a reference-schema sqlite database, loaded by the port's
        ``load_opacity_db`` (method 'resampled'); defaults to
        ``$picaso_refdata/opacities/opacities.db`` where present.
    wno_grid : an analytic connection on this wavenumber grid, no
        molecular table (test modes, user cross sections).
    ck_table : a ``CKTable`` ('preweighted'; with per-gas tables,
        'resortrebin'), copied to ``device`` in the device's dtype
        (float32 on the card) unless it lies there in it, for the spectra;
        the climate solve
        (:meth:`inputs.climate`) takes the table as given
        (``Opacity.climate_ck``), in float64 by default.
    ck_db : a CK file or directory, read by ``opacities.ck.load_ck_db``
        onto ``device`` (method 'preweighted', which a ``ck_db`` with the
        default method also means: a premixed hdf5 or a legacy
        ``ascii_data`` directory; 'resortrebin': per-gas hdf5 tables,
        ``preload_gases=[...]`` among ``kwargs``, which go to the loader:
        ``continuum_db``, ``dtype``, default float64).  The table read is
        the climate's, its copy in the device's dtype the spectra's, as
        for ``ck_table``.
    blocked : 'int16' attaches the int16 table, which the spectra then
        gather from (K8); True or 'f32' keep the float table (K1's layout).
    """
    device = checked_device(device)
    if raman_db is None:
        raman_db = refdata_path('opacities', 'raman.txt')
    raman_table = raman_mod.load_raman_db(raman_db)

    if wno_grid is not None:
        wno = np.sort(np.asarray(wno_grid, dtype=np.float64))
        if wave_range is not None:
            wave = 1e4 / wno
            sel = (wave > min(wave_range)) & (wave < max(wave_range))
            wno = wno[sel]
        return Opacity(wno, grid=None, raman_db=raman_table, device=device)

    if (ck_table is not None or ck_db is not None
            or method in ('preweighted', 'resortrebin')):
        if ck_table is None:
            from .opacities.ck import load_ck_db
            ck_table = load_ck_db(ck_db, method=method, device=device,
                                  **kwargs)
        if method == 'resortrebin' and ck_table.per_gas is None:
            raise ValueError("method='resortrebin' needs a CK table with "
                             'per-gas tables')
        source = ck_table
        if (ck_table.arrays.wno.device != device
                or ck_table.arrays.ln_kappa.dtype != default_dtype(device)):
            ck_table = ck_table.to(device, default_dtype(device))
        opa = Opacity(ck_table.wno, grid=None, raman_db=raman_table,
                      ngauss=ck_table.ngauss,
                      gauss_wts=np.asarray(ck_table.gauss_wts),
                      ck=ck_table, device=device)
        opa.climate_ck = source
        return opa

    if filename_db is None:
        try:
            filename_db = refdata_path('opacities', 'opacities.db')
        except FileNotFoundError:
            raise ValueError(
                'No opacity database found. Pass filename_db=, set '
                'picaso_refdata, or use wno_grid= for an analytic '
                'connection.') from None
    grid = load_opacity_db(filename_db, wave_range=wave_range,
                           resample=resample, molecules=molecules,
                           device=device)
    if blocked:
        grid = grid.with_blocked_table(quantize=(blocked == 'int16'))
    return Opacity(grid.wno, grid=grid, raman_db=raman_table,
                   query_method=query_method)


# ---------------------------------------------------------------------------
# tables without pandas
# ---------------------------------------------------------------------------

_WHITESPACE = (r'\s+', ' ', '\t')


def _read_table(filename, pd_kwargs):
    """A whitespace-separated table with a header line, as
    ``pd.read_csv(filename, sep=r'\\s+')`` reads it: {column: array}."""
    kw = dict(pd_kwargs)
    sep = kw.pop('sep', kw.pop('delimiter', None))
    whitespace = kw.pop('delim_whitespace', False)
    if kw or not (whitespace or sep in _WHITESPACE):
        raise ValueError(
            "picaso_tpu_torch reads profile files with numpy: pass "
            "sep=r'\\s+' (a header line, whitespace-separated columns); "
            f"other pandas options are not taken ({pd_kwargs})")
    with open(filename) as f:
        names = f.readline().split()
    data = np.loadtxt(filename, skiprows=1, ndmin=2)
    return {name: data[:, i] for i, name in enumerate(names)}


def _columns(df):
    """A mapping of column name to array (a DataFrame is one) as a dict of
    1-D numpy arrays."""
    return {str(k): np.asarray(df[k]) for k in df.keys()}


def _rows(table, order):
    return {k: v[order] for k, v in table.items()}


# ---------------------------------------------------------------------------
# the inputs bundle
# ---------------------------------------------------------------------------

class inputs:
    """The scene bundle, with the reference method surface
    (justdoit.py:1421)."""

    def __init__(self, calculation='planet', climate=False):
        self.inputs = load_default_config()
        self.inputs['phase_angle'] = None
        if 'brown' in calculation:
            self.setup_nostar()
        if climate:
            self.setup_climate()

    # -- geometry ----------------------------------------------------------
    def phase_angle(self, phase=0, num_gangle=10, num_tangle=1,
                    symmetry=False, phase_grid=None, calculation=None):
        if phase_grid is not None:
            if calculation is None:
                raise ValueError("phase curves require calculation="
                                 "'reflected' or 'thermal'")
            self.phase_curve_geometry(calculation, phase_grid,
                                      num_gangle=num_gangle,
                                      num_tangle=num_tangle)
            return
        geom = disco_mod.make_geometry(phase, num_gangle, num_tangle)
        self.inputs['phase_angle'] = phase
        self.inputs['disco'] = geom

    def phase_curve_geometry(self, calculation, phase_grid, num_gangle=10,
                             num_tangle=10):
        phase_grid = np.asarray(phase_grid)
        if phase_grid.min() < 0 or phase_grid.max() > 2 * np.pi:
            raise ValueError('phase_grid must be within [0, 2pi] radians')
        self.inputs['phase_angle'] = phase_grid
        geoms = {}
        for iphase in phase_grid:
            # thermal flux emits at all angles -> same geometry at each phase
            p = 0.0 if calculation == 'thermal' else float(iphase)
            geoms[float(iphase)] = disco_mod.make_geometry(
                p, num_gangle, num_tangle)
        self.inputs['disco'] = geoms
        self.inputs['disco_calculation'] = calculation

    # -- planet ------------------------------------------------------------
    def gravity(self, gravity=None, gravity_unit=None, radius=None,
                radius_unit=None, mass=None, mass_unit=None):
        if (mass is not None) and (radius is not None):
            m = u.to_cgs(mass, mass_unit)
            r = u.to_cgs(radius, radius_unit)
            self.inputs['planet'].update(
                radius=r, radius_unit='cm', mass=m, mass_unit='g',
                gravity=G_GRAV * m / r ** 2, gravity_unit='cm/(s**2)')
        elif gravity is not None:
            g = u.to_cgs(gravity, gravity_unit)
            self.inputs['planet'].update(
                gravity=g, gravity_unit='cm/(s**2)', radius=np.nan,
                radius_unit='Radius not specified', mass=np.nan,
                mass_unit='Mass not specified')
        else:
            raise ValueError('Need gravity+unit or radius+mass+units')

    def setup_nostar(self):
        self.inputs['approx']['rt_params']['common']['raman'] = 2
        self.inputs['star'] = {'database': 'nostar', 'temp': 'nostar',
                               'logg': 'nostar', 'metal': 'nostar',
                               'radius': 'nostar', 'radius_unit': 'nostar',
                               'semi_major': np.nan,
                               'semi_major_unit': 'nostar'}

    def star(self, opannection, temp=None, metal=None, logg=None,
             radius=None, radius_unit=None, semi_major=None,
             semi_major_unit=None, database='blackbody', filename=None,
             w_unit=None, f_unit=None, wno=None, flux=None):
        """Bind a stellar spectrum to the opacity connection
        (justdoit.py:301-396 of the JAX package): a two-column file,
        explicit (wno, flux) arrays, a CDBS grid ('phoenix', 'ck04models',
        read by ``stellar.py``) or a blackbody at ``temp``.  Flux values
        are per wavelength [erg/cm^2/s/cm].  A climate case bin-integrates
        the flux by trapezoids (justdoit.py:360-377 of the JAX package)."""
        r = u.to_cgs(radius, radius_unit) if radius is not None else np.nan
        sa = (u.to_cgs(semi_major, semi_major_unit)
              if semi_major is not None else np.nan)
        if np.isnan(sa) and 'climate' in str(self.inputs.get('calculation')):
            raise ValueError('climate runs need star semi_major + unit')

        if filename is not None:
            star = np.genfromtxt(filename, dtype=(float, float), names='w, f')
            wave_in = star['w'] * u.Unit(w_unit).cgs_factor  # -> cm
            wno_star = np.sort(1.0 / wave_in)
            order = np.argsort(1.0 / wave_in)
            flux_star = (star['f'] * u.Unit(f_unit).cgs_factor)[order]
        elif wno is not None and flux is not None:
            wno_star = np.asarray(wno, dtype=float)
            flux_star = np.asarray(flux, dtype=float)
        elif database in ('phoenix', 'ck04models'):
            from .stellar import get_stellar_spectrum
            wno_star, flux_star = get_stellar_spectrum(
                database, temp, metal, logg)
        elif temp is not None:
            # blackbody fallback: pi * B_lambda (erg/cm^2/s/cm)
            wno_star = np.linspace(
                max(np.min(opannection.wno) - 2500, 10.0),
                np.max(opannection.wno) + 7000, opannection.nwno * 5 + 1000)
            lam = 1.0 / wno_star
            flux_star = (np.pi * PLANCK_C1 / lam ** 5
                         / (np.exp(PLANCK_C2 / (lam * temp)) - 1.0))
        else:
            raise ValueError('give filename, (wno, flux) arrays, or temp')

        wno_planet = opannection.wno
        if self.inputs['approx']['rt_params']['common']['raman'] == 0:
            max_shift = np.max(wno_planet) + 6000
            min_shift = np.min(wno_planet) - 2000
            fine_wno = np.linspace(min_shift, max_shift, len(wno_planet) * 5)
            fine_flux = np.interp(fine_wno, wno_star, flux_star)
            opannection.compute_stellar_shifts(fine_wno, fine_flux)
            bin_flux = opannection.unshifted_stellar_spec
        elif 'climate' in str(self.inputs.get('calculation')):
            bin_flux = _climate_bin_flux(wno_planet, wno_star, flux_star)
            opannection.unshifted_stellar_spec = bin_flux
        else:
            interp_flux = np.interp(wno_planet, wno_star, flux_star)
            _, bin_flux = mean_regrid(wno_star, flux_star, newx=wno_planet)
            bad = np.isnan(bin_flux)
            bin_flux[bad] = interp_flux[bad]
            opannection.unshifted_stellar_spec = bin_flux

        if (not np.isnan(sa)) and (not np.isnan(r)):
            opannection.relative_flux = bin_flux * (r / sa) ** 2
        else:
            opannection.relative_flux = bin_flux * 0 + 1.0

        self.inputs['star'].update(
            database=database, temp=temp, logg=logg, metal=metal, radius=r,
            radius_unit='cm' if not np.isnan(r) else 'Radius not supplied',
            semi_major=sa, flux=bin_flux, wno=wno_planet, filename=filename,
            w_unit=w_unit, f_unit=f_unit)

    # -- atmosphere --------------------------------------------------------
    def atmosphere(self, df=None, filename=None, exclude_mol=None,
                   verbose=True, photochem_init_args=None,
                   photochem_TOA_pressure=1e-7 * 1e6, mh=None,
                   cto_relative=None, cto_absolute=None, chem_method=None,
                   device='cuda', **pd_kwargs):
        """The 1D profile: ``df`` a mapping of column name to array (a
        DataFrame is one, as is a dict) or ``filename`` a whitespace table
        with a header line (``sep=r'\\s+'``); stored as a dict of numpy
        columns sorted by pressure.  ``mh`` is linear metallicity (1.0 =
        solar); a ``chem_method`` ('visscher', '1060' or '2121') replaces
        the abundances with the grid's at the profile's (T, P) through
        :meth:`chemistry_handler`, interpolated on ``device``.
        ``photochem_init_args`` (with ``photochem_TOA_pressure``, dyn/cm^2)
        are kept for :meth:`photochem_init`."""
        for key, val in (('mh', mh), ('cto_relative', cto_relative),
                         ('cto_absolute', cto_absolute)):
            if val is not None:
                self.inputs['atmosphere'][key] = float(val)
        if photochem_init_args is not None:
            # stored for photochem_init (justdoit.py:411-416 of the JAX
            # package)
            photochem_init_args = dict(photochem_init_args)
            photochem_init_args['TOA_pressure'] = photochem_TOA_pressure
            self.inputs['atmosphere']['photochem_init_args'] = \
                photochem_init_args
        if filename is not None:
            df = _read_table(filename, pd_kwargs)
        if df is None:
            raise ValueError('give df= or filename=')
        table = _columns(df)
        if 'pressure' not in table or 'temperature' not in table:
            raise ValueError('profile needs pressure and temperature columns')
        table = _rows(table, np.argsort(table['pressure'], kind='stable'))
        self.inputs['atmosphere']['profile'] = table
        self.nlevel = len(table['pressure'])
        if exclude_mol is None:
            self.inputs['atmosphere']['exclude_mol'] = 1
        else:
            # dict of multipliers, missing molecules default to 1
            full = {m: 1 for m in table
                    if m not in ('pressure', 'temperature')}
            full.update({m: 0 for m in np.atleast_1d(exclude_mol)}
                        if not isinstance(exclude_mol, dict) else exclude_mol)
            self.inputs['atmosphere']['exclude_mol'] = full
        if chem_method is not None:
            self.chemistry_handler(chem_method, device=device)

    def atmosphere_3d(self, data, verbose=True):
        """3D GCM input: a NetCDF path or decoded ``ncio.NCDataset`` (the
        reference's xarray GCM format, converted by ``ncio.gcm_dict``) or a
        dict with 'lat'/'lon' (deg), 'pressure' [nlevel] (bar) and
        [nlevel, nlon, nlat] fields; the facets take the nearest columns
        (``three_d.regrid_to_disco``)."""
        data = _gcm_input(data)
        if 'pressure' not in data or 'temperature' not in data:
            raise ValueError('need pressure and temperature fields')
        self.inputs['atmosphere']['profile'] = data
        self.nlevel = len(np.asarray(data['pressure']))

    def clouds_3d(self, opd=None, g0=None, w0=None, wavenumber=None):
        """Facet-dependent clouds: [nlayer, nwno_cld, ng, nt] arrays."""
        self.inputs['clouds']['profile'] = {'opd': opd, 'g0': g0, 'w0': w0}
        self.inputs['clouds']['wavenumber'] = wavenumber

    @staticmethod
    def _rotate_lon(data, total_shift_deg, lon_axis):
        """Roll gridded fields so longitude zero moves by ``total_shift``
        (justdoit.py:460-483 of the JAX package; the reference's
        split-and-concatenate rotation, justdoit.py:3829-3838)."""
        lon = np.asarray(data['lon'], float)
        new_zero = (lon + total_shift_deg + 180.0) % 360.0 - 180.0
        split = int(np.argmin(np.abs(new_zero + 180.0)))
        out = {}
        for key, val in data.items():
            val = np.asarray(val)
            if key in ('lat', 'lon', 'pressure', 'wavenumber') \
                    or val.ndim <= 1:
                out[key] = val
            else:
                out[key] = np.concatenate(
                    [np.take(val, range(split, val.shape[lon_axis]),
                             axis=lon_axis),
                     np.take(val, range(split), axis=lon_axis)],
                    axis=lon_axis)
        return out

    def atmosphere_4d(self, ds=None, shift=None, plot=False, iz_plot=0,
                      verbose=True, zero_point='night_transit'):
        """Phase-dependent GCM rotation (justdoit.py:485-538 of the JAX
        package): for every phase of ``phase_curve_geometry`` the map is
        rotated by ``phase + shift_i`` degrees ('night_transit' adds 180
        for thermal curves) and stored as a per-phase profile list for
        :meth:`phase_curve`.  ``ds`` as :meth:`atmosphere_3d` takes it;
        ``plot`` draws each phase's map at level ``iz_plot``
        (``justplotit.map_4d``)."""
        ds = _gcm_input(ds)
        if ds is None:
            ds = self.inputs['atmosphere']['profile']
        if not isinstance(ds, dict) or 'lat' not in ds:
            raise ValueError("atmosphere_4d needs a 3D GCM dict with "
                             "'lat'/'lon'/'pressure' + [nlevel,nlon,nlat] "
                             "fields (see atmosphere_3d)")
        phases = np.atleast_1d(self.inputs['phase_angle'])
        if shift is None:
            shift = np.zeros(len(phases))
        shift = np.asarray(shift, float)
        if len(shift) != len(phases):
            raise ValueError('shift must have one entry per phase')
        calculation = self.inputs.get('disco_calculation', 'thermal')
        if zero_point == 'night_transit':
            if 'reflected' in calculation:
                if verbose:
                    print('Switching to zero point secondary_eclipse '
                          'which is required for reflected light')
            else:
                shift = shift + 180.0
        elif zero_point != 'secondary_eclipse':
            raise ValueError('zero_point must be night_transit or '
                             'secondary_eclipse')
        self.inputs['shift'] = shift
        profiles = []
        for i, iphase in enumerate(phases):
            total = (np.degrees(float(iphase)) + shift[i]) % 360.0
            profiles.append(self._rotate_lon(ds, total, lon_axis=1))
        self.inputs['atmosphere']['profile'] = profiles
        self.nlevel = len(np.asarray(ds['pressure']))
        if plot:
            from . import justplotit
            justplotit.map_4d(profiles, phases, iz_plot=iz_plot)
        return profiles

    def clouds_4d(self, ds=None, plot=False, iz_plot=0, iw_plot=0,
                  verbose=True, calculation='reflected'):
        """Phase-dependent cloud rotation + facet regrid (justdoit.py:
        540-573 of the JAX package): ``ds`` a NetCDF path, an
        ``ncio.NCDataset`` or a dict with 'lat'/'lon',
        'wavenumber' [nwno_cld] and [nlayer, nwno_cld, nlon, nlat]
        'opd'/'g0'/'w0'; stores a per-phase list of facet cloud dicts
        ([nlayer, nwno_cld, ng, nt]).  ``plot`` draws each phase's rotated
        opd map at layer ``iz_plot`` and cloud wavenumber ``iw_plot``
        (``justplotit.map_4d``; the JAX package's ``clouds_4d`` takes the
        argument and draws nothing)."""
        from .three_d import regrid_to_disco
        ds = _gcm_input(ds)
        if ds is None:
            ds = self.inputs['clouds'].get('profile')
        if not isinstance(ds, dict) or 'lat' not in ds:
            raise ValueError("clouds_4d needs a dict with 'lat'/'lon' and "
                             "[nlayer,nwno,nlon,nlat] opd/g0/w0 fields")
        phases = np.atleast_1d(self.inputs['phase_angle'])
        shift = np.asarray(self.inputs.get('shift',
                                           np.zeros(len(phases))), float)
        geoms = self.inputs['disco']
        per_phase, maps = [], []
        for i, iphase in enumerate(phases):
            total = (np.degrees(float(iphase)) + shift[i]) % 360.0
            rot = self._rotate_lon(ds, total, lon_axis=2)
            faceted = regrid_to_disco(
                {k: rot[k] for k in ('lat', 'lon', 'opd', 'g0', 'w0')},
                geoms[float(iphase)], field_lon_axis=2)
            per_phase.append({k: faceted[k] for k in ('opd', 'g0', 'w0')})
            if plot:
                maps.append({'lat': rot['lat'], 'lon': rot['lon'],
                             'opd': np.asarray(rot['opd'])[:, iw_plot]})
        self.inputs['clouds']['profile'] = per_phase
        self.inputs['clouds']['wavenumber'] = np.asarray(ds['wavenumber'])
        if plot:
            from . import justplotit
            justplotit.map_4d(maps, phases, field='opd', iz_plot=iz_plot)
        return per_phase

    # -- equilibrium chemistry (justdoit.py:632-656, 1064-1100,
    #    2000-2131 of the JAX package) --------------------------------------
    def add_pt(self, T, P):
        """Set the profile's temperature and pressure columns (a new
        profile of those two where there is none)."""
        df = self.inputs['atmosphere']['profile']
        if df is None:
            df = {'pressure': np.asarray(P), 'temperature': np.asarray(T)}
        else:
            df = dict(df)
            df['temperature'] = np.asarray(T)
            df['pressure'] = np.asarray(P)
        self.inputs['atmosphere']['profile'] = df
        self.nlevel = len(df['pressure'])

    def TP_line_earth(self, P, Tsfc=294.0, Psfc=1.0, gam_trop=0.18,
                      Ptrop=0.199, gam_strat=-0.045, Pstrat=0.001,
                      nlevel=150):
        """Earth-like piecewise lapse-rate T(P) (justdoit.py:579-604 of the
        JAX package; the reference's justdoit.py:3351): a dry-adiabat
        troposphere from (Tsfc, Psfc), a power-law stratosphere above
        Ptrop, isothermal below the surface and above Pstrat, clipped to
        [10, 1000] K; stored as the atmosphere profile and returned."""
        P = np.asarray(P, float)
        Ptrop = max(Ptrop, P.min())
        Pstrat = max(Pstrat, P.min())
        T_trop = Tsfc * (P / Psfc) ** gam_trop
        T_pause = T_trop[P <= Ptrop][-1]
        P_pause = P[P <= Ptrop][-1]
        T_strat = T_pause * (P / P_pause) ** gam_strat
        T = np.where(P >= Ptrop, T_trop, T_strat)
        if (P >= Psfc).any():
            T[P >= Psfc] = T[P >= Psfc][0]
        T[P <= Pstrat] = T[P <= Pstrat][-1]
        T = np.clip(T, 10.0, 1000.0)
        self.inputs['atmosphere']['profile'] = {'temperature': T,
                                                'pressure': P}
        self.nlevel = len(P)
        return self.inputs['atmosphere']['profile']

    def guillot_pt(self, Teq, T_int=100, logg1=-1, logKir=-1.5, alpha=0.5,
                   nlevel=61, p_bottom=1.5, p_top=-6):
        """The parameterised Guillot (2010) profile (justdoit.py:606-630 of
        the JAX package; the reference's justdoit.py:3283) at ``nlevel``
        pressures log-spaced from 10^p_top to 10^p_bottom bar, at the
        planet's gravity: {'pressure', 'temperature'} (not stored; the
        parameters go to ``inputs['atmosphere']['pt_params']``)."""
        from scipy.special import expn

        pressure = np.logspace(p_top, p_bottom, nlevel)
        g = self.inputs['planet']['gravity'] / 100.0  # SI
        kv1 = kv2 = 10 ** (logKir + logg1)
        kth = 10 ** logKir
        alpha = float(alpha)
        tint, tirr = T_int, np.sqrt(2.0) * Teq
        gamma1 = kv1 / kth
        gamma2 = kv2 / kth
        tau = pressure * 1e5 / g / kth
        xi1 = (2.0 / 3 + 2.0 / (3 * gamma1)
               * (1 + (gamma1 * tau / 2 - 1) * np.exp(-gamma1 * tau))
               + 2.0 * gamma1 / 3 * (1 - tau ** 2 / 2) * expn(2, gamma1 * tau))
        xi2 = (2.0 / 3 + 2.0 / (3 * gamma2)
               * (1 + (gamma2 * tau / 2 - 1) * np.exp(-gamma2 * tau))
               + 2.0 * gamma2 / 3 * (1 - tau ** 2 / 2) * expn(2, gamma2 * tau))
        temp = (3.0 * tint ** 4 / 4 * (2.0 / 3 + tau)
                + 3.0 * tirr ** 4 / 4 * (1 - alpha) * xi1
                + 3.0 * tirr ** 4 / 4 * alpha * xi2) ** 0.25
        self.inputs['atmosphere']['pt_params'] = dict(
            Teq=Teq, T_int=T_int, logg1=logg1, logKir=logKir, alpha=alpha)
        return {'pressure': pressure, 'temperature': temp}

    def pressure_grid(self, P_config):
        """A pressure grid [bar] from a config dict (justdoit.py:1050-1062
        of the JAX package; the reference's justdoit.py:3249):
        {'min': {'value', 'unit'}, 'max': {...}, 'nlevel', 'spacing'}."""
        def bar(entry):
            val = entry['value']
            unit = entry.get('unit', 'bar')
            return u.to_cgs(val, unit) / 1e6 if unit != 'bar' else val
        minp = bar(P_config['min'])
        maxp = bar(P_config['max'])
        nlevel = P_config.get('nlevel', 91)
        if P_config.get('spacing', 'log') == 'log':
            return np.logspace(np.log10(minp), np.log10(maxp), nlevel)
        return np.linspace(minp, maxp, nlevel)

    def premix_atmosphere(self, opa=None, df=None, quench_levels=None,
                          verbose=True):
        """Equilibrium chemistry from the opacity connection's premixed
        ``full_abunds`` table (justdoit.py:2237-2282 semantics),
        interpolated on the connection's device."""
        table = None
        if opa is not None and getattr(opa, 'ck', None) is not None:
            table = opa.ck.full_abunds
        if table is None:
            raise ValueError('premix_atmosphere needs a CK connection with '
                             'a full_abunds chemistry table')
        prof = df if df is not None else self.inputs['atmosphere']['profile']
        self.inputs['atmosphere']['profile'] = prof
        return self._apply_chem_grid(table, opa.device)

    def premix_atmosphere_photochem(self, opa=None, quench_levels=None,
                                    verbose=False, **kwargs):
        """Run the photochemical kinetics and load their steady-state gas
        concentrations into the profile (justdoit.py:666-705 of the JAX
        package): refresh the equilibrium chemistry when ``opa`` is given
        (:meth:`premix_atmosphere`), quench-adjust it as the kinetics'
        initial guess, then ``pc.run_for_picaso`` warm-started from the
        previous steady state (``inputs['photochemistry']
        ['initial_guess']``, else the newest record of ``pc``'s save file,
        ``pc.initial_guess``).  Needs :meth:`photochem_init`, or any object
        with the same ``run_for_picaso`` in ``inputs['climate']['pc']``."""
        if opa is not None:
            self.premix_atmosphere(opa=opa, **kwargs)
        if quench_levels is not None:
            self.adjust_quench_chemistry(quench_levels)
        pc = self.inputs['climate'].get('pc')
        if pc is None:
            raise ValueError('initialize kinetics with photochem_init() '
                             'before premix_atmosphere_photochem()')
        kz = self.find_kzz()
        if kz is None:
            raise ValueError('photochem kinetics needs a kzz profile')
        store = self.inputs.setdefault('photochemistry',
                                       {'initial_guess': None})
        mh = float(self.inputs['atmosphere'].get('mh') or 1.0)
        cto = float(self.inputs['atmosphere'].get('cto_relative') or 1.0)
        guess = store.get('initial_guess')
        if guess is None:
            guess = getattr(pc, 'initial_guess', None)
        df = pc.run_for_picaso(self.inputs['atmosphere']['profile'],
                               np.log10(mh), cto, kz, df_comp_guess=guess)
        store['initial_guess'] = {k: np.array(v) for k, v in df.items()}
        self.inputs['atmosphere']['profile'] = df
        return df

    def photochem_init(self):
        """The kinetics wrapper (``photochem.EvoAtmosphereGasGiantPicaso``)
        from the arguments that ``atmosphere(photochem_init_args=...)``
        stored (justdoit.py:707-728 of the JAX package); needs the optional
        ``photochem`` package and the planet's mass and radius."""
        args = self.inputs['atmosphere'].get('photochem_init_args')
        if args is None:
            raise ValueError('pass photochem_init_args to atmosphere() '
                             'before photochem_init()')
        mass = self.inputs['planet']['mass']
        radius = self.inputs['planet']['radius']
        if np.isnan(mass) or np.isnan(radius):
            raise ValueError('photochem needs mass and radius via '
                             'gravity(mass=..., radius=...)')
        args = dict(args)
        toa_pressure = args.pop('TOA_pressure')
        args['planet_mass'] = mass
        args['planet_radius'] = radius
        from .photochem import EvoAtmosphereGasGiantPicaso
        pc = EvoAtmosphereGasGiantPicaso(**args)
        pc.gdat.TOA_pressure_avg = toa_pressure
        self.inputs['climate']['pc'] = pc
        return pc

    def sonora(self, sonora_path, teff, chem='low'):
        raise _not_ported('the Sonora Bobcat profiles (sonora)', 'item 7.2')

    def sonora_profile(self, sonora_path, teff, chem='low'):
        raise _not_ported('the Sonora Bobcat profiles (sonora_profile)',
                          'item 7.2')

    def find_kzz(self):
        """The active Kzz profile: the self-consistent one, the constant
        one, else the profile's 'kz' column, else None
        (``chemistry.find_kzz``)."""
        return chemistry.find_kzz(self.inputs['atmosphere'])

    # -- disequilibrium chemistry adjustments (justdoit.py:904-991 of the
    #    JAX package; chemistry.py holds them) ------------------------------
    def adjust_quench_chemistry(self, quench_levels, chemistry_table=None,
                                kinetic_CO2=True):
        """Freeze quenched species above their quench level, conserving
        the total through H2, with the kinetic CO2."""
        self.inputs['atmosphere']['profile'] = \
            chemistry.adjust_quench_chemistry(
                self.inputs['atmosphere']['profile'], quench_levels,
                kinetic_CO2=kinetic_CO2)

    def volatile_rainout(self, quench_levels,
                         species_to_consider=('H2O', 'CH4', 'NH3')):
        """Cap quenched volatiles at their saturation vapour pressure."""
        self.inputs['atmosphere']['profile'] = chemistry.volatile_rainout(
            self.inputs['atmosphere']['profile'], quench_levels,
            species_to_consider)

    def cold_trap(self, species_to_consider=('H2O', 'CH4', 'NH3')):
        """Non-increasing condensible abundances above the condensation
        level."""
        self.inputs['atmosphere']['profile'] = chemistry.cold_trap(
            self.inputs['atmosphere']['profile'], species_to_consider)

    def chemistry_handler(self, chemistry_table=None, device='cuda'):
        """Dispatch equilibrium chemistry from
        approx['chem_params']['chem_method'] (justdoit.py:2082): runs the
        matching Visscher grid, on ``device``, when the profile already has
        (P, T); otherwise records the method."""
        chem = self.inputs['approx'].setdefault('chem_params', {})
        method = str(chemistry_table or chem.get('chem_method', ''))
        prof = self.inputs['atmosphere'].get('profile')
        has_pt = (isinstance(prof, dict) and 'temperature' in prof
                  and 'lat' not in prof)
        if not has_pt:
            chem['chem_method'] = method
            return
        # the config tree carries these keys with None defaults; 'mh' is
        # linear metallicity wherever it is stored (log10 at the lookup);
        # the 1060 grid takes C/O relative to solar, 2121 absolute
        mh = chem.get('mh')
        if mh is None:
            mh = self.inputs['atmosphere'].get('mh')
        log_mh = 0.0 if mh is None else float(np.log10(mh))
        if '2121' in method:
            cto = chem.get('cto_absolute')
            if cto is None:
                cto = self.inputs['atmosphere'].get('cto_absolute')
            cto = 0.458 if cto is None else float(cto)
            self.chemeq_visscher_2121(cto, log_mh, device=device)
        elif 'visscher' in method or '1060' in method:
            cto = chem.get('cto_relative')
            if cto is None:
                cto = self.inputs['atmosphere'].get('cto_relative')
            cto = 1.0 if cto is None else float(cto)
            self.chemeq_visscher_1060(cto, log_mh, device=device)
        elif method and method != 'None':
            raise ValueError(f'unknown chem_method {method!r}')

    def channon_grid_low(self, filename=None, device='cuda'):
        """Low-T Visscher equilibrium chemistry on the 1060-point grid (the
        sonora chem='low' table), interpolated on ``device``."""
        filename = filename or refdata_path('chemistry',
                                            'visscher_abunds_m+0.0_co1.0')
        return self._apply_chem_grid(_read_csv(filename, index_col=0),
                                     device)

    def chemeq_visscher_1060(self, cto_relative=1.0, log_mh=0.0,
                             device='cuda'):
        """Visscher 1060-grid equilibrium chemistry (justdoit.py:3028).

        ``cto_relative`` is the C/O ratio as a factor of solar (0.458,
        Lodders 2010), the convention of the 1060 grid filenames.  The
        grid is the nearest file of $picaso_refdata/chemistry/
        visscher_grid_1060 where that set is installed, else the bundled
        solar-composition file; interpolated on ``device``."""
        return self._apply_chem_grid(
            _parse_visscher_grid(_visscher_1060_file(log_mh, cto_relative)),
            device)

    def chemeq_visscher_2121(self, cto_absolute=0.458, log_mh=0.0,
                             device='cuda'):
        """Visscher 2121-grid equilibrium chemistry (justdoit.py:2837); the
        grids are not bundled: FileNotFoundError without
        $picaso_refdata/chemistry/visscher_grid_2121."""
        ext = external_refdata()
        directory = (os.path.join(ext, 'chemistry', 'visscher_grid_2121')
                     if ext else None)
        if not (directory and os.path.isdir(directory)):
            raise FileNotFoundError(
                'the 2121-point Visscher grids are not bundled; set '
                'picaso_refdata to a directory containing '
                'chemistry/visscher_grid_2121')
        fn = _nearest_grid_file(directory, 'sonora_2121grid', log_mh,
                                cto_absolute)
        return self._apply_chem_grid(_parse_visscher_grid(fn), device)

    def _chem_3d_apply(self, table, device):
        """The chemistry of ``table`` on every column of a 3D GCM dict, in
        one interpolation call (every column flattened into the batch
        axis; the reference fans the columns out over joblib,
        justdoit.py:3560-3633)."""
        data = self.inputs['atmosphere']['profile']
        if not (isinstance(data, dict) and 'lat' in data):
            raise ValueError('premix_3d/chemeq_3d need a 3D GCM dict '
                             '(run atmosphere_3d first)')
        t = np.asarray(data['temperature'], float)   # [nlevel, nlon, nlat]
        nlevel = t.shape[0]
        p = np.broadcast_to(np.asarray(data['pressure'], float)[:, None, None],
                            t.shape)
        out = dict(data)
        for sp, col in _chem_abundances(table, t.ravel(), p.ravel(),
                                        device).items():
            out[sp] = col.reshape(t.shape)
        self.inputs['atmosphere']['profile'] = out
        self.nlevel = nlevel
        return out

    def premix_3d(self, opa, n_cpu=1):
        """Premixed CK chemistry on every 3D column (justdoit.py:3517), on
        the connection's device; ``n_cpu`` is accepted and unused (the
        columns are one batch)."""
        table = (opa.ck.full_abunds
                 if getattr(opa, 'ck', None) is not None else None)
        if table is None:
            raise ValueError('premix_3d needs a CK connection with a '
                             'full_abunds chemistry table')
        return self._chem_3d_apply(table, opa.device)

    def chemeq_3d(self, c_o=None, log_mh=0.0, cto_absolute=0.55, n_cpu=1,
                  device='cuda'):
        """Visscher equilibrium chemistry on every 3D column
        (justdoit.py:3590), the grid file chosen as
        :meth:`chemeq_visscher_1060` chooses it.  The 1060 filenames
        encode C/O relative to solar, so ``cto_absolute`` converts through
        the reference's solar 0.55 (justdoit.py:3608); ``c_o`` is already
        the relative factor."""
        if isinstance(c_o, (int, float)):
            cto_relative = float(c_o)
        else:
            cto_relative = float(cto_absolute) / 0.55
        return self._chem_3d_apply(
            _parse_visscher_grid(_visscher_1060_file(log_mh, cto_relative)),
            device)

    def _apply_chem_grid(self, table, device):
        """Replace the 1D profile's abundances by those of ``table`` (a
        chemistry table of columns) at its (T, P): a new profile of
        pressure, temperature and the table's species, in its order."""
        prof = self.inputs['atmosphere']['profile']
        pressure = np.asarray(prof['pressure'])
        temperature = np.asarray(prof['temperature'])
        out = {'pressure': pressure, 'temperature': temperature}
        out.update(_chem_abundances(table, temperature, pressure, device))
        self.inputs['atmosphere']['profile'] = out
        self.nlevel = len(pressure)
        return out

    # -- clouds ------------------------------------------------------------
    def clouds_reset(self):
        self.inputs['clouds'] = {'profile': None, 'wavenumber': None,
                                 'scattering': {'g0': None, 'w0': None,
                                                'opd': None},
                                 'do_holes': False}

    def clouds(self, filename=None, g0=None, w0=None, opd=None, p=None,
               dp=None, df=None, do_holes=False, fhole=None, fthin_cld=None,
               **pd_kwargs):
        """Cloud profile: an eddysed-layout table (a mapping, or a
        whitespace file read as :meth:`atmosphere` reads one) or the
        g0/w0/opd/p/dp box model (justdoit.py:737-791 of the JAX
        package)."""
        if not hasattr(self, 'nlevel'):
            raise ValueError('run atmosphere() before clouds()')
        nlayer = self.nlevel - 1
        if filename is not None:
            df = _read_table(filename, pd_kwargs)
        if df is not None:
            table = _columns(df)
            for c in ('g0', 'w0', 'opd'):
                if c not in table:
                    raise ValueError(f'{c} must be a column in cld input')
            if 'pressure' in table and 'wavenumber' in table:
                table = _rows(table, np.lexsort((table['wavenumber'],
                                                 table['pressure'])))
                _, first = np.unique(table['wavenumber'], return_index=True)
                self.inputs['clouds']['wavenumber'] = \
                    table['wavenumber'][np.sort(first)]
            else:
                nrow = len(table['opd'])
                if nrow == nlayer * 196:
                    self.inputs['clouds']['wavenumber'] = get_cld_input_grid()
                elif nrow == nlayer * 661:
                    self.inputs['clouds']['wavenumber'] = get_cld_input_grid(
                        grid661=True)
                else:
                    raise ValueError(
                        f'{nrow} rows != {nlayer} layers x 196 or 661 '
                        'eddysed wave points')
            self.inputs['clouds']['profile'] = table
        elif None in [g0, w0, opd, p, dp]:
            raise ValueError('give df/filename OR all of g0,w0,opd,p,dp')
        else:
            pressure_level = np.asarray(
                self.inputs['atmosphere']['profile']['pressure'])
            pressure = np.sqrt(pressure_level[1:] * pressure_level[:-1])
            w = get_cld_input_grid()
            self.inputs['clouds']['wavenumber'] = w
            nw = len(w)
            g0a = np.zeros((nlayer, nw))
            w0a = np.zeros((nlayer, nw))
            opda = np.zeros((nlayer, nw))
            for ig, iw, io, ip, idp in zip(*map(np.atleast_1d,
                                                (g0, w0, opd, p, dp))):
                maxp, minp = 10.0 ** ip, 10.0 ** (ip - idp)
                sel = (pressure >= minp) & (pressure <= maxp)
                g0a[sel], w0a[sel], opda[sel] = ig, iw, io
            self.inputs['clouds']['profile'] = {
                'g0': g0a.ravel(), 'w0': w0a.ravel(), 'opd': opda.ravel()}
        self.inputs['clouds']['do_holes'] = do_holes
        if do_holes:
            if fhole is None:
                raise ValueError('fhole must be set when do_holes=True')
            self.inputs['clouds']['fhole'] = fhole
            self.inputs['clouds']['fthin_cld'] = fthin_cld

    # -- approximations ----------------------------------------------------
    def approx(self, single_phase='TTHG_ray', multi_phase='N=2',
               delta_eddington=True, raman='pollack', tthg_frac=[1, -1, 2],
               tthg_back=-0.5, tthg_forward=1, p_reference=1,
               rt_method='toon', stream=2, toon_coefficients='quadrature',
               single_form='explicit', calculate_fluxes='off',
               w_single_form='TTHG', w_multi_form='TTHG',
               psingle_form='TTHG', w_single_rayleigh='on',
               w_multi_rayleigh='on', psingle_rayleigh='on',
               get_lvl_flux=False):
        ap = self.inputs['approx']
        ap['get_lvl_flux'] = get_lvl_flux
        ap['rt_method'] = rt_method
        common = ap['rt_params']['common']
        common['stream'] = 2 if rt_method == 'toon' else stream
        common['delta_eddington'] = delta_eddington
        common['raman'] = raman_options().index(raman)
        if len(tthg_frac) != 3:
            raise ValueError('tthg_frac must have length 3')
        common['TTHG_params']['fraction'] = tthg_frac
        common['TTHG_params']['constant_back'] = tthg_back
        common['TTHG_params']['constant_forward'] = tthg_forward
        tp = ap['rt_params']['toon']
        tp['toon_coefficients'] = toon_phase_coefficients(False).index(
            toon_coefficients)
        tp['multi_phase'] = multi_phase_options(False).index(multi_phase)
        tp['single_phase'] = single_phase_options(False).index(single_phase)
        sh = ap['rt_params']['SH']
        sh['single_form'] = SH_psingle_form_options(False).index(single_form)
        sh['w_single_form'] = SH_scattering_options(False).index(w_single_form)
        sh['w_multi_form'] = SH_scattering_options(False).index(w_multi_form)
        sh['psingle_form'] = SH_scattering_options(False).index(psingle_form)
        sh['w_single_rayleigh'] = SH_rayleigh_options(False).index(
            w_single_rayleigh)
        sh['w_multi_rayleigh'] = SH_rayleigh_options(False).index(
            w_multi_rayleigh)
        sh['psingle_rayleigh'] = SH_rayleigh_options(False).index(
            psingle_rayleigh)
        sh['calculate_fluxes'] = SH_calculate_fluxes_options(False).index(
            calculate_fluxes)
        ap['p_reference'] = p_reference

    def surface_reflect(self, albedo, wavenumber, old_wavenumber=None):
        if isinstance(albedo, (int, float)):
            albedo = np.zeros(len(wavenumber)) + albedo
        if old_wavenumber is not None:
            albedo = np.interp(wavenumber, old_wavenumber, albedo)
        self.inputs['surface_reflect'] = np.asarray(albedo)

    # -- clouds from microphysics (justdoit.py:793-888 of the JAX package) --
    def virga(self, condensates, directory=None, fsed=1.0, b=1.0, eps=1e-2,
              param='const', mh=1.0, mmw=2.2, sig=2.0, kz_min=1e5,
              supsat=0, gas_mmr=None, Teff=None, alpha_pressure=None,
              do_virtual=False, full_output=False, solver='eddysed',
              **kwargs):
        """Run the cloud microphysics (``virga.py``, the AM01
        eddy-sedimentation solver; ``directory`` holds virga .mieff files
        for Mie optics, else geometric optics) on the 1D profile and attach
        the cloud (:meth:`clouds`).  ``param``/``b``/``eps`` select the
        variable-fsed profile, ``do_virtual`` the below-grid virtual cloud,
        ``solver='analytic'`` the closed-form balance.  Returns the cloud
        table (a dict of columns), or virga's output with
        ``full_output``."""
        from . import virga as vj
        atmo = vj.Atmosphere(condensates, fsed=fsed, b=b, eps=eps,
                             param=param, mh=mh, mmw=mmw, sig=sig,
                             supsat=supsat, gas_mmr=gas_mmr, **kwargs)
        atmo.gravity = self.inputs['planet']['gravity']
        atmo.ptk(df=self.inputs['atmosphere']['profile'], kz_min=kz_min,
                 Teff=Teff, alpha_pressure=alpha_pressure)
        out = vj.compute(atmo, directory=directory, do_virtual=do_virtual,
                         solver=solver)
        # pressure + wavenumber columns make clouds() keep the solver's
        # own wave grid
        df_cld = vj.picaso_format(out['opd_per_layer'],
                                  out['single_scattering'],
                                  out['asymmetry'],
                                  pressure=out['pressure'],
                                  wavenumber=1e4 / out['wave'])
        self.clouds(df=df_cld)
        return out if full_output else df_cld

    def virga_3d(self, condensates, directory=None, fsed=1.0, mh=1.0,
                 mmw=2.2, sig=2.0, kz_min=1e5, n_cpu=1, verbose=False,
                 full_output=False, solver='eddysed', **kwargs):
        """Cloud microphysics for every (lon, lat) column of the 3D GCM
        input (:meth:`atmosphere_3d` with a 'kz' [cm^2/s] field), the cloud
        arrays [nlayer, nwno, nlon, nlat] stored on the GCM grid; the
        facets take the nearest columns at spectrum time
        (``three_d.regrid_to_disco``).  The columns run one after another
        on the host; ``n_cpu`` is accepted and unused."""
        from . import virga as vj
        prof = self.inputs['atmosphere']['profile']
        if not (isinstance(prof, dict) and 'lat' in prof):
            raise ValueError('virga_3d needs atmosphere_3d input '
                             '(dict with lat/lon grids)')
        if 'kz' not in prof:
            raise ValueError("virga_3d needs a 'kz' [cm^2/s] field in "
                             'the 3D profile')
        lat = np.asarray(prof['lat'], float)
        lon = np.asarray(prof['lon'], float)
        pressure = np.asarray(prof['pressure'], float)
        nlon, nlat = len(lon), len(lat)
        nlayer = len(pressure) - 1
        temperature = np.asarray(prof['temperature'])
        kz = np.asarray(prof['kz'])

        def one_column(ilon, ilat):
            atmo = vj.Atmosphere(condensates, fsed=fsed, mh=mh, mmw=mmw,
                                 sig=sig, **kwargs)
            atmo.gravity = self.inputs['planet']['gravity']
            atmo.ptk(df={'pressure': pressure,
                         'temperature': temperature[:, ilon, ilat],
                         'kz': kz[:, ilon, ilat]}, kz_min=kz_min)
            return vj.compute(atmo, directory=directory, solver=solver)

        results = [one_column(g, t) for g in range(nlon)
                   for t in range(nlat)]
        wno_grid = np.sort(1e4 / results[0]['wave'])
        opd = np.zeros((nlayer, len(wno_grid), nlon, nlat))
        w0 = np.zeros_like(opd)
        g0 = np.zeros_like(opd)
        all_out = {}
        i = 0
        for g in range(nlon):
            for t in range(nlat):
                out = results[i]
                i += 1
                opd[:, :, g, t] = out['opd_per_layer']
                w0[:, :, g, t] = out['single_scattering']
                g0[:, :, g, t] = out['asymmetry']
                if full_output:
                    all_out[f'lon{g}_lat{t}'] = out
        self.inputs['clouds']['profile'] = {
            'opd': opd, 'w0': w0, 'g0': g0, 'lat': lat, 'lon': lon,
            'pressure': pressure}
        self.inputs['clouds']['wavenumber'] = wno_grid
        if full_output:
            return all_out

    # -- the climate glue (justdoit.py:1041-1135 of the JAX package) -------
    def setup_climate(self):
        self.inputs['calculation'] = 'climate'
        self.inputs['approx']['rt_params']['common']['raman'] = 2
        self.phase_angle(0, num_gangle=10, num_tangle=1)

    def effective_temp(self, teff=None):
        return self.T_eff(teff)

    def T_eff(self, Teff=None):
        self.inputs['planet']['T_eff'] = Teff if Teff is not None else 0

    def inputs_climate(self, temp_guess=None, pressure=None, rfaci=1,
                       rcb_guess=None, rfacv=None, moistgrad=False):
        """The climate run's guess, pressure grid [bar], convective-zone
        guess and flux weights (api.py:682-698 of the JAX package, the
        reference justdoit.py:4883-4931)."""
        if self.inputs['planet'].get('T_eff', 0) in (0, None):
            raise ValueError('set T_eff via case.effective_temp() first')
        if not self.inputs['planet'].get('gravity'):
            raise ValueError('set gravity first')
        cl = self.inputs['climate']
        cl['guess_temp'] = np.asarray(temp_guess, float)
        cl['pressure'] = np.asarray(pressure, float)
        cl['nstr'] = [0, int(rcb_guess), len(pressure) - 2, 0, 0, 0]
        cl['nofczns'] = 1
        cl['rfacv'] = rfacv
        cl['rfaci'] = rfaci
        cl['moistgrad'] = moistgrad
        self.add_pt(cl['guess_temp'], cl['pressure'])

    def interpret_run(self):
        """Print a summary of the configured climate run
        (justdoit.py:4868)."""
        print('SUMMARY')
        print('-------')
        clim = self.inputs.get('climate', {})
        print('Clouds:', clim.get('cloudy', False))
        for k, v in self.inputs['approx'].get('chem_params', {}).items():
            print(k, v)
        print('Moist Adiabat:', clim.get('moistgrad', False))

    def energy_injection(self, inject_energy=False,
                         total_energy_injection=0, press_max_energy=1,
                         injection_scalehight=1, inject_beam=False,
                         beam_profile=0):
        """Energy deposition for climate runs (justdoit.py:4953-4980): a
        Chapman deposition of ``total_energy_injection`` [erg/cm^2/s]
        peaking at ``press_max_energy`` [bar], or a ``beam_profile`` per
        level when ``inject_beam``."""
        cl = self.inputs['climate']
        cl['inject_energy'] = inject_energy
        cl['total_energy_injection'] = total_energy_injection
        cl['press_max_energy'] = press_max_energy
        cl['injection_scaleheight'] = injection_scalehight
        cl['inject_beam'] = inject_beam
        cl['beam_profile'] = beam_profile

    def climate(self, opacityclass, save_all_profiles=False,
                with_spec=False, diseq_chem=False, verbose=True, mesh=None,
                self_consistent_kzz=True, counts=None, jac_batch=None,
                dtype=torch.float64):
        """The radiative-convective equilibrium solve of this case
        (``climate.api.run_climate``) on the connection's device, in
        ``dtype`` (float64 unless asked), on the connection's CK table as
        it was given (``opacityclass.climate_ck``).  Every mode:
        ``diseq_chem``, clouds (``inputs['climate']['cloudy']`` /
        ``['virga_kwargs']``), the moist adiabat (``inputs_climate
        (moistgrad=True)``), :meth:`energy_injection`, ``with_spec`` (the
        thermal spectrum of the result on ``opacityclass``, float32 on the
        card).  Afterwards the case holds the solve's chemistry as its
        profile and, where one was computed, its Kzz
        (``inputs['atmosphere']['kzz']['sc_kzz']``), as in the JAX
        package.  With ``diseq_chem``, a ``pc`` in ``inputs['climate']``
        (:meth:`photochem_init`) runs photochemical kinetics each host
        iteration (:meth:`premix_atmosphere_photochem`).  ``mesh`` (a
        ``parallel.make_mesh`` mesh starting at the connection's device)
        runs the solve over a device mesh."""
        from .climate import api
        cl = self.inputs['climate']
        ck = opacityclass.climate_ck
        if ck is None:
            raise ValueError('climate runs need a CK connection '
                             '(opannection(ck_table=...))')
        nostar = 'nostar' in str(self.inputs['star'].get('database'))
        if nostar:
            opacityclass.relative_flux = np.zeros(ck.nwno) + 1.0
        approx = self.inputs['approx']
        common = approx['rt_params']['common']
        injection = None
        if cl.get('inject_energy'):
            injection = dict(
                total_energy=cl.get('total_energy_injection', 0.0),
                press_max=cl.get('press_max_energy', 1.0),
                hratio=cl.get('injection_scaleheight', 1.0),
                inject_beam=cl.get('inject_beam', False),
                beam_profile=cl.get('beam_profile', 0.0))
        inputs = api.ClimateInputs(
            t_eff=self.inputs['planet']['T_eff'],
            gravity=self.inputs['planet']['gravity'],
            pressure=cl['pressure'], guess=cl['guess_temp'],
            nstr=tuple(cl['nstr']), nofczns=cl['nofczns'],
            rfaci=cl['rfaci'], rfacv=0.0 if nostar else cl['rfacv'],
            F0PI=None if nostar else opacityclass.relative_flux,
            controls=scattering_controls(self),
            delta_eddington=common['delta_eddington'],
            stream=common['stream'],
            chem_params=dict(approx.get('chem_params') or {}),
            # the JAX state looks the Kzz up after replacing the profile
            # with the premixed one: the 'kzz' store alone counts
            kzz=chemistry.find_kzz(
                {'kzz': self.inputs['atmosphere'].get('kzz', {})}),
            cloudy=bool(cl.get('cloudy', False)),
            virga_kwargs=dict(cl.get('virga_kwargs') or {}) or None,
            moistgrad=bool(cl.get('moistgrad', False)),
            injection=injection, p_reference=approx['p_reference'])
        out = api.run_climate(
            inputs, ck, save_all_profiles=save_all_profiles,
            with_spec=with_spec, diseq_chem=diseq_chem, verbose=verbose,
            counts=counts, jac_batch=jac_batch, mesh=mesh,
            device=opacityclass.device, dtype=dtype,
            self_consistent_kzz=self_consistent_kzz, bundle=self,
            opacity=opacityclass)
        if not with_spec:
            self.inputs['atmosphere']['profile'] = out['ptchem_df']
            self.nlevel = len(out['pressure'])
        if 'kzz' in out:
            store = self.inputs['atmosphere'].get('kzz')
            if not isinstance(store, dict):
                store = self.inputs['atmosphere']['kzz'] = {}
            store['sc_kzz'] = out['kzz']
        return out

    # -- run ---------------------------------------------------------------
    def spectrum(self, opacityclass, calculation='reflected',
                 dimension='1d', full_output=False, plot_opacity=False,
                 as_dict=True):
        if self.inputs['star'].get('radius') == 'nostar':
            calculation = 'thermal'
        if self.inputs.get('phase_angle') is None:
            if 'reflected' in calculation:
                raise ValueError('run phase_angle() before a reflected '
                                 'calculation')
            self.phase_angle(0)
        if 'surface_reflect' not in self.inputs:
            self.inputs['surface_reflect'] = 0.0
            self.inputs['hard_surface'] = 0
        return picaso(self, opacityclass, dimension=dimension,
                      calculation=calculation, full_output=full_output,
                      as_dict=as_dict)

    def phase_curve(self, opacityclass, full_output=False, n_cpu=1,
                    verbose=True, batched=None, mesh=None):
        """Phase curve (justdoit.py:1159-1213 of the JAX package).

        With 1D profiles and no patchy clouds (``batched=None``), every
        phase becomes one scene of a batch through ``pipeline.forward_batch``
        (:meth:`_phase_curve_batched`); 3D (GCM) profiles take the
        per-phase path, each phase a ``three_d.picaso_3d`` run.  ``n_cpu``
        is accepted for API parity and unused.  ``mesh`` (a
        ``parallel.make_mesh`` mesh) shards the batched curve, the phases
        over 'batch' and the wavenumbers over 'wave'
        (``parallel.sharded_forward_batch``); the per-phase path ignores
        it, as in the JAX package.
        """
        phases = np.atleast_1d(self.inputs['phase_angle'])
        calculation = self.inputs['disco_calculation']
        all_geom = self.inputs['disco']
        all_profiles = self.inputs['atmosphere']['profile']
        all_clds = self.inputs['clouds'].get('profile')

        def _is_1d(p):
            return not (isinstance(p, dict) and 'lat' in p)

        profiles_1d = (_is_1d(all_profiles)
                       if not isinstance(all_profiles, (list, tuple))
                       else all(_is_1d(p) for p in all_profiles))
        if batched is None:
            batched = (profiles_1d
                       and not self.inputs['clouds'].get('do_holes'))
        if batched:
            if not profiles_1d:
                raise ValueError('batched phase curves need 1D profiles')
            return self._phase_curve_batched(
                opacityclass, phases, calculation, all_geom, all_profiles,
                all_clds, mesh=mesh, verbose=verbose)
        out = {}
        for i, iphase in enumerate(phases):
            case = copy.copy(self)
            case.inputs = copy.deepcopy(
                {k: v for k, v in self.inputs.items() if k != 'disco'})
            case.inputs['phase_angle'] = float(iphase)
            case.inputs['disco'] = all_geom[float(iphase)]
            if isinstance(all_profiles, (list, tuple)):
                case.inputs['atmosphere']['profile'] = all_profiles[i]
            if isinstance(all_clds, (list, tuple)):
                case.inputs['clouds']['profile'] = all_clds[i]
            if verbose:
                print('Currently computing Phase', iphase)
            prof = case.inputs['atmosphere']['profile']
            dim = '3d' if not _is_1d(prof) else '1d'
            out[float(iphase)] = case.spectrum(
                opacityclass, calculation=calculation, dimension=dim,
                full_output=full_output)
        return out

    def _phase_curve_batched(self, opacityclass, phases, calculation,
                             all_geom, all_profiles, all_clds, mesh=None,
                             verbose=True):
        """All phases as one batch of scenes (justdoit.py:1215-1281 of the
        JAX package): ``pipeline.scene_from_case`` per phase, then
        ``pipeline.forward_batch``, which runs the scenes one after
        another through ``forward``'s kernels; with ``mesh``, the batch and
        the grid sharded (``parallel.shard_scene``, ``shard_grid``) and
        ``parallel.sharded_forward_batch``."""
        import dataclasses as _dc
        from . import pipeline as _pl

        scenes = []
        config = None
        for i, iphase in enumerate(phases):
            case = copy.copy(self)
            case.inputs = copy.copy(self.inputs)
            case.inputs['atmosphere'] = dict(self.inputs['atmosphere'])
            case.inputs['clouds'] = dict(self.inputs['clouds'])
            case.inputs['phase_angle'] = float(iphase)
            case.inputs['disco'] = all_geom[float(iphase)]
            if isinstance(all_profiles, (list, tuple)):
                case.inputs['atmosphere']['profile'] = all_profiles[i]
            if isinstance(all_clds, (list, tuple)):
                case.inputs['clouds']['profile'] = all_clds[i]
            scene, config = _pl.scene_from_case(case, opacityclass)
            scenes.append(scene)
        config = _dc.replace(
            config,
            reflected='reflected' in calculation,
            thermal='thermal' in calculation,
            transmission='transmission' in calculation)
        if verbose:
            print(f'Batched phase curve: {len(phases)} phases in one batch')
        batch = _pl.stack_scenes(scenes)
        if mesh is not None:
            from . import parallel as _par
            res = _par.sharded_forward_batch(
                _par.shard_scene(batch, mesh, batched=True),
                _par.shard_grid(opacityclass.grid, mesh), config, mesh)
        else:
            res = _pl.forward_batch(batch, opacityclass.grid, config)

        wno = np.asarray(opacityclass.wno)
        sa = self.inputs['star'].get('semi_major', np.nan)
        rp = self.inputs['planet'].get('radius', np.nan)
        out = {}
        for i, iphase in enumerate(phases):
            d = {'wavenumber': wno}
            if 'albedo' in res:
                alb = _np(res['albedo'][i])
                d['albedo'] = alb
                if np.isfinite(sa) and np.isfinite(rp):
                    d['fpfs_reflected'] = alb * (rp / sa) ** 2
            if 'thermal' in res:
                th = _np(res['thermal'][i])
                d['thermal'] = th
                flux_star = opacityclass.unshifted_stellar_spec
                rstar = self.inputs['star'].get('radius')
                if (flux_star is not None
                        and isinstance(rstar, (int, float))
                        and np.isfinite(rstar) and np.isfinite(rp)):
                    d['fpfs_thermal'] = (th / np.asarray(flux_star)
                                         * (rp / rstar) ** 2)
            if 'transit_depth' in res:
                d['transit_depth'] = _np(res['transit_depth'][i])
            out[float(iphase)] = d
        return out


# ---------------------------------------------------------------------------
# orchestration
# ---------------------------------------------------------------------------

def _climate_bin_flux(wno_planet, wno_star, flux_star):
    """The stellar flux of a climate case: the per-wavelength flux
    interpolated in log-log onto the planet grid, integrated over each bin
    by trapezoids in wavelength (justdoit.py:360-377 of the JAX package;
    ``np.trapezoid``'s sum written out), the last bin extrapolated
    linearly.  Per-bin energy [erg/cm^2/s]: the climate's visible fluxes
    sum it without dwni."""
    mask = flux_star > 1e-30
    lw, lf = np.log10(wno_star[mask]), np.log10(flux_star[mask])
    fine = 10 ** np.interp(np.log10(wno_planet), lw, lf)
    binned = np.zeros(len(wno_planet))
    for i in range(len(wno_planet) - 1):
        sel = (wno_planet >= wno_planet[i]) & (
            wno_planet <= wno_planet[i + 1])
        y, x = fine[sel], -1 / wno_planet[sel]
        binned[i] = (np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum()
    if len(wno_planet) > 2:
        slope = ((binned[-2] - binned[-3])
                 / (wno_planet[-2] - wno_planet[-3]))
        binned[-1] = binned[-2] + slope * (wno_planet[-1] - wno_planet[-2])
    return binned


def _np(x):
    """A tensor (on any device) as a numpy array."""
    return x.detach().cpu().numpy()


def _build_atmosphere_from_inputs(bundle, wno):
    """The bundle's Atmosphere; without a cloud profile it carries no cloud
    arrays (None, where the JAX package stores zeros), and the optics take
    device zeros for them."""
    inp = bundle.inputs
    profile = inp['atmosphere']['profile']
    cld = inp['clouds'].get('profile')
    cld_wno = inp['clouds'].get('wavenumber')
    cld_dict = None
    if cld is not None:
        cld_dict = {k: np.asarray(cld[k]) for k in ('opd', 'g0', 'w0')}
    return build_atmosphere(
        profile,
        gravity=inp['planet']['gravity'] or np.nan,
        radius=inp['planet']['radius'] if inp['planet']['radius'] else np.nan,
        mass=inp['planet']['mass'] if inp['planet']['mass'] else np.nan,
        p_reference=inp['approx']['p_reference'],
        wno=wno if cld_dict is not None else None, cld_profile=cld_dict,
        cld_wno=cld_wno)


def _molecular_taugas(atm: Atmosphere, opa: Opacity, exclude_mol):
    """Molecular optical depth [nlayer, nwno].  'linear': the gather
    kernel (K8 on an int16 grid, else K1) with the column weights mix *
    colden / mmw (times the ``exclude_mol`` multiplier) of every table
    molecule, zero for the ones the atmosphere lacks; 'nearest': the
    nearest (T, P) cross sections, plain torch."""
    grid, t = opa.grid, opa.tensor
    used = [m for m in atm.molecules if m in grid.molecules]
    if not used:
        return None
    mix = np.stack([atm.mixing_ratio_layer(m) for m in used])
    w = mix * atm.colden[None, :] / atm.mmw_layer[None, :]
    if isinstance(exclude_mol, dict):
        w = w * np.asarray([exclude_mol.get(m, 1) for m in used],
                           float)[:, None]
    rows = [grid.molecules.index(m) for m in used]
    player_bar = t(atm.p_layer / PCONV)
    if opa.query_method == 'nearest':
        kappa = interp_molecular_nearest(grid, t(atm.t_layer), player_bar)
        return torch.einsum('mlw,ml->lw', kappa[rows], t(w))
    t_w, p_w, idx = _find_indices(grid.pt, t(atm.t_layer), player_bar)
    mixcol = np.zeros((len(grid.molecules), atm.nlayer))
    mixcol[rows] = w
    if (grid.log_kappa_blocked is not None
            and grid.log_kappa_blocked.dtype == torch.int16):
        return interp_tau_q(grid.log_kappa_blocked, idx, t_w, p_w,
                            t(mixcol), grid.blocked_qparams)
    return interp_tau(grid.log_kappa, idx, t_w, p_w, t(mixcol))


def _gas_optics(atm: Atmosphere, opa: Opacity, raman_approx, exclude_mol=1):
    """taugas/tauray/raman per gauss point: [ngauss, nlayer, nwno] tensors
    on the connection's device (justdoit.py:1306-1401 of the JAX
    package)."""
    nlayer, nwno = atm.nlayer, opa.nwno
    t, dtype, dev = opa.tensor, opa.dtype, opa.device

    taugas = torch.zeros((opa.ngauss, nlayer, nwno), dtype=dtype, device=dev)
    if opa.grid is not None:
        tau_mol = _molecular_taugas(atm, opa, exclude_mol)
        if tau_mol is not None:
            taugas = taugas + tau_mol.to(dtype)[None]
        specs = assemble.classify_continuum(
            atm.continuum_pairs(opa.avail_continuum))
        if specs:
            cont = nearest_continuum(opa.grid, t(atm.t_layer))
            cont_kappa = {s.name: cont[list(opa.grid.continuum_molecules)
                                       .index(s.name)] for s in specs}
            coef1 = assemble.amagat_coef1(
                t(atm.temperature), t(atm.pressure / PCONV), t(atm.t_layer),
                t(atm.p_layer / PCONV), atm.gravity, t(atm.mmw_layer))
            mix = {m: t(atm.mixing_ratio_layer(m)) for m in atm.molecules}
            for s in specs:
                for m in (s.mol1, s.mol2):
                    if m and m not in mix:
                        mix[m] = torch.zeros(nlayer, dtype=dtype, device=dev)
            elec = (t(atm.electrons_layer) if atm.electrons_layer is not None
                    else torch.zeros(nlayer, dtype=dtype, device=dev))
            tau_cont = assemble.continuum_tau(
                specs, cont_kappa, mix, elec, coef1, t(atm.p_layer),
                t(atm.t_layer), t(atm.colden), t(atm.mmw_layer))
            taugas = taugas + tau_cont.to(dtype)[None]
    elif opa.ck is not None:
        from .opacities.ck import ck_taugas
        taugas = taugas + ck_taugas(opa.ck, atm).to(dtype)

    # --- rayleigh ---
    ray_species = atm.rayleigh_species(opa.rayleigh_molecules)
    if ray_species:
        sigma = opa.rayleigh_sigma(ray_species)
        mix_ray = t(np.stack([atm.mixing_ratio_layer(m)
                              for m in ray_species]))
        tauray = assemble.rayleigh_tau(sigma, mix_ray, t(atm.colden),
                                       t(atm.mmw_layer))
    else:
        tauray = torch.zeros((nlayer, nwno), dtype=dtype, device=dev)
    tauray = tauray[None].expand(opa.ngauss, nlayer, nwno)

    # --- raman factor ---
    if raman_approx == 0:
        if opa.raman_stellar_shifts is None:
            raise ValueError("raman='oklopcic' needs star() run first")
        db = opa.raman_db
        rf = raman_mod.raman_factor_oklopcic(
            t(opa.wno), t(opa.raman_stellar_shifts), t(atm.t_layer),
            t(db['c']), t(db['ji'], torch.int32), t(db['deltanu']))
        rf = torch.clamp(rf, max=0.99999)
    elif raman_approx == 1:
        rf = torch.clamp(opa.pollack_row(), max=0.99999)[None].expand(
            nlayer, nwno)
    else:
        rf = torch.full((nlayer, nwno), 0.99999, dtype=dtype, device=dev)
    rf = rf[None].expand(opa.ngauss, nlayer, nwno)
    return taugas, tauray, rf


def _cloud_arrays(atm, opa):
    """Cloud opd/g0/w0 [ngauss, nlayer, nwno] (broadcast views); zeros,
    made on the device, for a cloud-free atmosphere."""
    shape = (opa.ngauss, atm.nlayer, opa.nwno)
    zero = torch.zeros(shape[1:], dtype=opa.dtype, device=opa.device)
    return tuple((opa.tensor(x) if x is not None else zero)[None].expand(
        shape) for x in (atm.cld_opd, atm.cld_g0, atm.cld_w0))


def compute_rtprops(bundle, opacityclass, atm, fthin_cld=None,
                    do_holes=False) -> RTProps:
    """Atmosphere + opacity -> RTProps, every field [ngauss, ...]
    (optics.py:26-431; justdoit.py:1416-1437 of the JAX package)."""
    inp = bundle.inputs
    common = inp['approx']['rt_params']['common']
    taugas, tauray, rf = _gas_optics(atm, opacityclass, common['raman'],
                                     inp['atmosphere'].get('exclude_mol', 1))
    taucld, g0_cld, w0_cld = _cloud_arrays(atm, opacityclass)
    if do_holes:
        taucld = (fthin_cld if fthin_cld is not None else 0.0) * taucld
    return combine_optics(taugas, tauray, taucld, w0_cld, g0_cld, rf,
                          test_mode=inp.get('test_mode'),
                          delta_eddington=common['delta_eddington'],
                          stream=common['stream'])


def scattering_controls(bundle):
    """The Toon phase-function controls of the bundle's approx tree."""
    common = bundle.inputs['approx']['rt_params']['common']
    tp = bundle.inputs['approx']['rt_params']['toon']
    frac = common['TTHG_params']['fraction']
    return toon.ScatteringControls(
        single_phase=tp['single_phase'], multi_phase=tp['multi_phase'],
        toon_coefficients=tp['toon_coefficients'],
        frac_a=float(frac[0]), frac_b=float(frac[1]), frac_c=float(frac[2]),
        constant_back=float(common['TTHG_params']['constant_back']),
        constant_forward=float(common['TTHG_params']['constant_forward']))


def toon_reflected(p: RTProps, surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                   controls, get_lvl_flux=False):
    """(xint [ng, nt, nwno], FluxSet or None) of one gauss point: K5 on
    the RTProps fields the JAX ``toon.reflected_1d`` reads; the level
    fluxes, where asked for, by the plain ``toon.reflected_1d``."""
    fields = tuple(getattr(p, f).contiguous() for f in REFLECTED_FIELDS)
    geom = (surf_reflect, ubar0, ubar1, cos_theta, F0PI)
    xint = cuda_toon.reflected_toon_props(*fields, *geom, controls=controls)
    lvl = (toon.reflected_1d(*fields, *geom, controls=controls,
                             get_lvl_flux=True) if get_lvl_flux else None)
    return xint, lvl


def toon_thermal(all_b, p: RTProps, plevel, surf_reflect, ubar1,
                 hard_surface, get_lvl_flux=False):
    """(thermal flux [ng, nt, nwno], FluxSet or None) of one gauss point:
    K6 on the OG optics with the no-Raman albedo and the above-model
    tau_top of ``toon.thermal_1d``; the level fluxes, where asked for, by
    the plain ``toon.thermal_levels``."""
    args = (all_b.contiguous(), p.dtau_og.contiguous(),
            p.w0_no_raman.contiguous(), p.cosb_og.contiguous(),
            (p.dtau_og[0] * plevel[0] / (plevel[1] - plevel[0])).contiguous(),
            surf_reflect, ubar1)
    flux = cuda_toon.thermal_toon_props(*args, hard_surface=hard_surface)
    lvl = (toon.thermal_levels(*args, hard_surface=hard_surface)
           if get_lvl_flux else None)
    return flux, lvl


def _mix(a, b, fhole):
    """(1 - fhole) a + fhole b, for tensors and FluxSets alike."""
    if isinstance(a, toon.FluxSet):
        return toon.FluxSet(*((1 - fhole) * x + fhole * y
                              for x, y in zip(a, b)))
    return (1 - fhole) * a + fhole * b


def picaso(bundle, opacityclass, dimension='1d', calculation='reflected',
           full_output=False, plot_opacity=False, as_dict=True):
    """Top-level forward model (justdoit.py:1440-1688 of the JAX package):
    a dict of numpy arrays (albedo, thermal, transit_depth, fpfs_*, ...).
    The 3D path is ``three_d.picaso_3d``."""
    inp = bundle.inputs
    opa = opacityclass
    t = opa.tensor
    wno = np.asarray(opa.wno)
    nwno, ngauss = opa.nwno, opa.ngauss
    gauss_wts = np.asarray(opa.gauss_wts)

    if dimension != '1d':
        from .three_d import picaso_3d
        return picaso_3d(bundle, opa, calculation=calculation,
                         full_output=full_output, as_dict=as_dict)

    common = inp['approx']['rt_params']['common']
    controls = scattering_controls(bundle)
    rt_method = inp['approx']['rt_method']
    get_lvl_flux = bool(inp['approx'].get('get_lvl_flux', False))

    geom: disco_mod.Geometry = inp['disco']
    ubar0, ubar1 = t(geom.ubar0), t(geom.ubar1)
    gweight, tweight = t(geom.gweight), t(geom.tweight)
    cos_theta = geom.cos_theta

    radius_star = inp['star'].get('radius')
    if inp['star'].get('database') == 'nostar' or radius_star == 'nostar':
        F0PI = t(np.ones(nwno))
    else:
        F0PI = t(opa.relative_flux)
    sa = inp['star'].get('semi_major', np.nan)

    surf_reflect = inp.get('surface_reflect', 0.0)
    if isinstance(surf_reflect, (int, float)):
        surf_reflect = np.zeros(nwno) + surf_reflect
    surf_reflect = t(surf_reflect)
    hard_surface = bool(inp.get('hard_surface', 0))

    do_holes = inp['clouds'].get('do_holes', False)
    fhole = inp['clouds'].get('fhole', 0.0) if do_holes else 0.0
    fthin_cld = inp['clouds'].get('fthin_cld') if do_holes else None

    atm = _build_atmosphere_from_inputs(bundle, wno)
    props = compute_rtprops(bundle, opa, atm)
    props_clear = (compute_rtprops(bundle, opa, atm, fthin_cld=fthin_cld,
                                   do_holes=True) if do_holes else None)
    tlevel, plevel = t(atm.temperature), t(atm.pressure)

    returns = {'wavenumber': wno}
    full = {}

    if 'reflected' in calculation:
        xint_at_top = 0
        lvl_acc = None
        for ig in range(ngauss):
            p = props.slice_gauss(ig)
            if rt_method == 'SH':
                from .rt.sh import reflected_sh
                sh = inp['approx']['rt_params']['SH']
                xint = reflected_sh(
                    p, surf_reflect, ubar0, ubar1, cos_theta, F0PI,
                    stream=common['stream'], controls=controls,
                    w_single_form=sh['w_single_form'],
                    w_multi_form=sh['w_multi_form'],
                    psingle_form=sh['psingle_form'],
                    w_single_rayleigh=sh['w_single_rayleigh'],
                    w_multi_rayleigh=sh['w_multi_rayleigh'],
                    psingle_rayleigh=sh['psingle_rayleigh'],
                    single_form=sh['single_form'])
                lvl = None
            else:
                xint, lvl = toon_reflected(p, surf_reflect, ubar0, ubar1,
                                           cos_theta, F0PI, controls,
                                           get_lvl_flux)
            if do_holes:
                # the clear columns take the Toon solve whatever rt_method
                # says, as in the JAX package
                xint_c, lvl_c = toon_reflected(
                    props_clear.slice_gauss(ig), surf_reflect, ubar0, ubar1,
                    cos_theta, F0PI, controls, get_lvl_flux)
                xint = _mix(xint, xint_c, fhole)
                if lvl is not None:
                    lvl = _mix(lvl, lvl_c, fhole)
            xint_at_top = xint_at_top + xint * float(gauss_wts[ig])
            if lvl is not None:
                scaled = toon.FluxSet(*(x * float(gauss_wts[ig])
                                        for x in lvl))
                lvl_acc = scaled if lvl_acc is None else toon.FluxSet(
                    *(a + s for a, s in zip(lvl_acc, scaled)))
        albedo = _np(disco_mod.compress_disco(xint_at_top, gweight, tweight,
                                              cos_theta, F0PI))
        returns['albedo'] = albedo
        if opa.unshifted_stellar_spec is not None:
            spec = np.asarray(opa.unshifted_stellar_spec)
            returns['bond_albedo'] = float(
                _trapz(x=1 / wno, y=albedo * spec)
                / _trapz(x=1 / wno, y=spec))
        r_planet = atm.radius
        if (not np.isnan(sa)) and (not np.isnan(r_planet)):
            returns['fpfs_reflected'] = albedo * (r_planet / sa) ** 2
        else:
            returns['fpfs_reflected'] = []
        if get_lvl_flux and lvl_acc is not None:
            full['lvl_output_reflected'] = _integrate_lvl_fluxes(
                lvl_acc, gweight, tweight, cos_theta, t(np.ones(nwno)))
        if full_output:
            full['xint_at_top'] = _np(xint_at_top)

    if 'thermal' in calculation:
        dwno = getattr(opa, 'delta_wno', np.zeros(nwno))
        if get_lvl_flux:   # calc_type=1: the bin-integrated Planck function
            all_b = toon.blackbody_integrated(tlevel, t(wno), t(dwno))
        else:
            all_b = toon.blackbody(tlevel, 1.0 / t(wno))
        all_b = all_b.to(opa.dtype)
        flux_at_top = 0
        lvl_acc = None
        for ig in range(ngauss):
            p = props.slice_gauss(ig)
            if rt_method == 'SH':
                from .rt.sh import thermal_sh
                flux = thermal_sh(tlevel, p, plevel, ubar1, surf_reflect,
                                  t(wno), stream=common['stream'],
                                  hard_surface=hard_surface)
                lvl = None
            else:
                flux, lvl = toon_thermal(all_b, p, plevel, surf_reflect,
                                         ubar1, hard_surface, get_lvl_flux)
            if do_holes:
                flux_c, lvl_c = toon_thermal(
                    all_b, props_clear.slice_gauss(ig), plevel, surf_reflect,
                    ubar1, hard_surface, get_lvl_flux)
                flux = _mix(flux, flux_c, fhole)
                if lvl is not None:
                    lvl = _mix(lvl, lvl_c, fhole)
            flux_at_top = flux_at_top + flux * float(gauss_wts[ig])
            if get_lvl_flux and lvl is not None:
                scaled = toon.FluxSet(*(x * float(gauss_wts[ig])
                                        for x in lvl))
                lvl_acc = scaled if lvl_acc is None else toon.FluxSet(
                    *(a + s for a, s in zip(lvl_acc, scaled)))
        thermal = _np(disco_mod.compress_thermal(flux_at_top, gweight,
                                                 tweight))
        returns['thermal'] = thermal
        returns['thermal_unit'] = 'erg/s/(cm^2)/(cm)'
        returns['effective_temperature'] = float(
            (_trapz(x=1 / wno[::-1], y=thermal[::-1]) / SB_SIGMA) ** 0.25)
        if get_lvl_flux and lvl_acc is not None:
            delta_wno = getattr(opa, 'delta_wno',
                                np.concatenate((np.diff(wno),
                                                [np.diff(wno)[-1]])))
            full['lvl_output_thermal'] = {
                k: _np(disco_mod.compress_thermal(v, gweight, tweight))
                * delta_wno for k, v in lvl_acc._asdict().items()}
        if radius_star == 'nostar':
            returns['fpfs_thermal'] = ['No star mode for Brown Dwarfs '
                                       'was used']
        elif ((not np.isnan(atm.radius))
              and isinstance(radius_star, float)
              and not np.isnan(radius_star)):
            returns['fpfs_thermal'] = (
                thermal / np.asarray(opa.unshifted_stellar_spec)
                * (atm.radius / radius_star) ** 2)
        else:
            returns['fpfs_thermal'] = []
        if full_output:
            full['flux_at_top'] = _np(flux_at_top)

    if 'transmission' in calculation:
        z, dz = t(atm.z), t(atm.dz)
        colden, mmw = t(atm.colden), t(atm.mmw_layer)
        rprs2 = 0
        for ig in range(ngauss):
            r = transit_depth(z, dz, radius_star, mmw, plevel, tlevel,
                              colden, props.dtau_og[ig])
            if do_holes:
                rc = transit_depth(z, dz, radius_star, mmw, plevel, tlevel,
                                   colden, props_clear.dtau_og[ig])
                r = _mix(r, rc, fhole)
            rprs2 = rprs2 + r * float(gauss_wts[ig])
        returns['transit_depth'] = _np(rprs2)

    if (isinstance(returns.get('fpfs_reflected'), np.ndarray)
            and isinstance(returns.get('fpfs_thermal'), np.ndarray)):
        returns['fpfs_total'] = (returns['fpfs_thermal']
                                 + returns['fpfs_reflected'])

    if full_output:
        zero = np.zeros((atm.nlayer, nwno))
        full['layer'] = {
            'pressure': atm.p_layer / PCONV, 'temperature': atm.t_layer,
            'colden': atm.colden, 'mmw': atm.mmw_layer,
            'column_density': atm.colden,
            'cloud': {k: x if x is not None else zero for k, x in (
                ('opd', atm.cld_opd), ('g0', atm.cld_g0),
                ('w0', atm.cld_w0))}}
        full['level'] = {'pressure': atm.pressure / PCONV,
                         'temperature': atm.temperature,
                         'z': atm.z, 'dz': atm.dz}
        # per-source optical depths in the reference's full-output layout
        # [nlayer, nwno, ngauss] (justdoit.py:518-621 via compute_opacity)
        taugas_d, tauray_d, _ = _gas_optics(
            atm, opa, common['raman'],
            inp['atmosphere'].get('exclude_mol', 1))
        full['taugas'] = np.transpose(_np(taugas_d), (1, 2, 0))
        full['tauray'] = np.transpose(_np(tauray_d), (1, 2, 0))
        full['taucld'] = np.repeat(full['layer']['cloud']['opd'][:, :, None],
                                   ngauss, axis=2)
        full['wavenumber'] = wno
        full['warnings'] = list(atm.warnings)
        if inp['star'].get('database') != 'nostar' and \
                opa.unshifted_stellar_spec is not None:
            full['star'] = {'flux': np.asarray(opa.unshifted_stellar_spec)}
        returns['full_output'] = full if as_dict else atm
    return returns


def _integrate_lvl_fluxes(lvl, gweight, tweight, cos_theta, ones):
    """Each level flux [ng, nt, nlevel, nwno] integrated over the disk,
    level by level (justdoit.py:536-548): {name: [nlevel, nwno]}."""
    out = {}
    for name, data in lvl._asdict().items():
        out[name] = _np(torch.stack([
            disco_mod.compress_disco(data[:, :, i, :], gweight, tweight,
                                     cos_theta, ones)
            for i in range(data.shape[2])]))
    return out


# ---------------------------------------------------------------------------
# input files: GCM NetCDF, Visscher grids
# ---------------------------------------------------------------------------

def _gcm_input(data):
    """A GCM input as the dict ``atmosphere_3d`` stores: a NetCDF path or
    ``ncio.NCDataset`` converted by ``ncio.gcm_dict``, anything else as it
    is."""
    from .ncio import NCDataset, gcm_dict
    if isinstance(data, (str, bytes, NCDataset)):
        return gcm_dict(data)
    return data


def _read_csv(filename, index_col=None):
    """A numeric comma-separated table with a header line, as
    ``pd.read_csv(filename, index_col=index_col)`` reads it:
    {column name: float64 array}, the index column (0) dropped."""
    with open(filename) as f:
        names = [n.strip() for n in f.readline().rstrip('\n').split(',')]
    data = np.loadtxt(filename, delimiter=',', skiprows=1, ndmin=2)
    return {name: data[:, i] for i, name in enumerate(names)
            if i != index_col}


def _chem_abundances(table, temperature, pressure, device):
    """{species: float64 abundances} of a chemistry table of columns at
    the (T [K], P [bar]) points, interpolated by ``chemistry.chem_interp``
    on ``device``."""
    from .chemistry import chem_grid_from_table, chem_interp
    grid = chem_grid_from_table(table, device=device)
    dt = grid.log_abunds.dtype
    abunds = _np(chem_interp(
        grid, torch.tensor(np.asarray(temperature), dtype=dt, device=device),
        torch.tensor(np.asarray(pressure), dtype=dt, device=device)))
    return {sp: abunds[:, i].astype(np.float64)
            for i, sp in enumerate(grid.species)}


def _parse_visscher_grid(filename):
    """A Visscher grid text file ('2015_06_1060grid_feh_*' /
    'sonora_2121grid_*': a header 'T (K)  P (bar)  <species...>', then rows
    of temperature [K], log10 pressure [bar] and abundances) as a table of
    columns: the species in the header's order, then temperature and
    pressure [bar]."""
    with open(filename) as f:
        header = f.readline()
    # the 1060 headers write 'T (K)  P (bar)', the 2121 ones 'T(K)  P(bar)'
    for unit in ('T (K)', 'P (bar)', 'T(K)', 'P(bar)'):
        header = header.replace(unit, '')
    species = header.split()
    data = np.loadtxt(filename, skiprows=1)
    out = {sp: data[:, 2 + i] for i, sp in enumerate(species)}
    out['temperature'] = data[:, 0]
    out['pressure'] = 10.0 ** data[:, 1]
    return out


def _decode_grid_float(s):
    """Invert the reference's filename encoding of feh/co values: 2121
    grids use plain floats ('feh-0.3_co0.14'), 1060 grids
    str(v).replace('.','').replace('-','m') (justdoit.py:3079-3083):
    '00' -> 0.0, '025' -> 0.25, 'm03' -> -0.3, '15' -> 1.5."""
    sign = 1.0
    if s.startswith('m'):
        sign, s = -1.0, s[1:]
    if '.' in s:
        return sign * float(s)
    return sign * float(s[0] + '.' + s[1:])


def _nearest_grid_file(directory, pattern_prefix, log_mh, cto):
    """The grid file of ``directory`` nearest in (feh, co) by its name."""
    import re
    files = [f for f in os.listdir(directory)
             if f.startswith(pattern_prefix)]
    best, best_d = None, np.inf
    for f in files:
        m = re.search(r'feh_?(m?[+-]?[\d.]+)_co_?([\d.]+)', f)
        if not m:
            continue
        try:
            # rstrip the dot the pattern takes from the '.txt' suffix
            feh = _decode_grid_float(m.group(1).lstrip('+').rstrip('.'))
            co = _decode_grid_float(m.group(2).rstrip('.'))
        except ValueError:
            continue
        d = (feh - log_mh) ** 2 + (co - cto) ** 2
        if d < best_d:
            best, best_d = f, d
    if best is None:
        raise FileNotFoundError(
            f'no {pattern_prefix}* chemistry grids in {directory}')
    return os.path.join(directory, best)


def _visscher_1060_file(log_mh, cto_relative):
    """The nearest file of the external 1060 grid set, else the bundled
    solar-composition grid."""
    ext = external_refdata()
    directory = (os.path.join(ext, 'chemistry', 'visscher_grid_1060')
                 if ext else None)
    if directory and os.path.isdir(directory):
        return _nearest_grid_file(directory, '2015_06_1060grid', log_mh,
                                  cto_relative)
    return refdata_path('chemistry', '2015_06_1060grid_feh_00_co_10.txt')


# ---------------------------------------------------------------------------
# bundled base cases
# ---------------------------------------------------------------------------

def jupiter_pt():
    return refdata_path('base_cases', 'jupiter.pt')


def jupiter_cld():
    return refdata_path('base_cases', 'jupiterf3.cld')


def HJ_pt():
    return refdata_path('base_cases', 'HJ.pt')


def HJ_cld():
    return refdata_path('base_cases', 'HJ.cld')


def brown_dwarf_pt():
    return refdata_path('base_cases', 't1270g200f1_m0.0_co1.0.cmp')


def brown_dwarf_cld():
    return refdata_path('base_cases', 't1270g200f1_m0.0_co1.0.cld')


def w17_data():
    """WASP-17b MIRI transmission spectrum (Grant et al. 2023), bundled
    (justdoit.py:5505): a classic NetCDF file, read by
    ``ncio.read_netcdf``."""
    return refdata_path(
        'base_cases',
        'Grant_etal_transmission_spectrum_vfinal_bin0.25_'
        'utc20230606_125313.nc')


# ---------------------------------------------------------------------------
# contribution functions
# ---------------------------------------------------------------------------

def get_contribution(bundle, opacityclass, at_tau=1, dimension='1d'):
    """Per-species optical-depth contributions (justdoit.py:1792-1880 of
    the JAX package; the reference's justdoit.py:1090-1295), computed on
    the connection's device in its dtype and returned as numpy:

      taus_per_layer : {species: [nlayer, nwno]} per-layer optical depth
      cumsum_taus    : {species: [nlevel, nwno]} cumulative from the top
      tau_p_surface  : {species: [nwno]} pressure (bar) where the
                       cumulative tau reaches ``at_tau``, log-interpolated
                       between levels; the bottom pressure where it never
                       does

    The molecules from ``db.interp_molecular`` (the bilinear table lookup,
    plain torch: no kernel), the continua at the nearest CIA temperature
    (``nearest_continuum``), Rayleigh and the cloud opacity.  The JAX
    package's per-wavenumber loop for ``tau_p_surface`` is one vectorised
    search here.
    """
    if dimension != '1d':
        raise NotImplementedError('contribution functions are 1d')
    from .constants import AMU, K_B
    from .opacities.db import interp_molecular

    wno = np.asarray(opacityclass.wno)
    t = opacityclass.tensor
    atm = _build_atmosphere_from_inputs(bundle, wno)
    taus = {}

    grid = opacityclass.grid
    if grid is not None:
        used = [m for m in atm.molecules if m in grid.molecules]
        if used:
            kappa = interp_molecular(grid, t(atm.t_layer),
                                     t(atm.p_layer / PCONV))
            for m in used:
                im = grid.molecules.index(m)
                taus[m] = kappa[im] * t(atm.mixing_ratio_layer(m)
                                        * atm.colden
                                        / atm.mmw_layer)[:, None]
        specs = assemble.classify_continuum(
            atm.continuum_pairs(opacityclass.avail_continuum))
        if specs:
            cont = nearest_continuum(grid, t(atm.t_layer))
            coef1 = assemble.amagat_coef1(
                t(atm.temperature), t(atm.pressure / PCONV),
                t(atm.t_layer), t(atm.p_layer / PCONV), atm.gravity,
                t(atm.mmw_layer))

            def mix(m):
                return t(atm.mixing_ratio_layer(m) if m in atm.molecules
                         else np.zeros(atm.nlayer))

            for s in specs:
                k = cont[list(grid.continuum_molecules).index(s.name)]
                if s.kind == 'cia':
                    taus[s.name] = k * (coef1 * mix(s.mol1)
                                        * mix(s.mol2))[:, None]
                elif s.kind == 'H-bf':
                    taus[s.name] = k * t(atm.mixing_ratio_layer('H-')
                                         * atm.colden
                                         / (atm.mmw_layer * AMU))[:, None]
                elif s.kind == 'H-ff' and atm.electrons_layer is not None:
                    taus[s.name] = k * t(
                        atm.p_layer * atm.mixing_ratio_layer('H')
                        * atm.electrons_layer * atm.colden
                        / (atm.t_layer * atm.mmw_layer * AMU
                           * K_B))[:, None]
                elif s.kind == 'H2-' and atm.electrons_layer is not None:
                    taus[s.name] = k * t(
                        atm.p_layer * atm.mixing_ratio_layer('H2')
                        * atm.electrons_layer * atm.colden
                        / (atm.mmw_layer * AMU))[:, None]

    ray_species = atm.rayleigh_species(opacityclass.rayleigh_molecules)
    if ray_species:
        mix_ray = np.stack([atm.mixing_ratio_layer(m) for m in ray_species])
        taus['rayleigh'] = torch.einsum(
            'mw,ml->lw', opacityclass.rayleigh_sigma(ray_species),
            t(mix_ray * atm.colden / atm.mmw_layer))

    if atm.cld_opd is not None and np.any(atm.cld_opd):
        taus['cloud'] = t(atm.cld_opd)

    cumsum_taus, tau_p_surface = {}, {}
    p_level = t(atm.pressure / PCONV)
    nlevel = atm.nlevel
    for name, tau in taus.items():
        c = torch.zeros((nlevel, len(wno)), dtype=tau.dtype,
                        device=tau.device)
        c[1:] = torch.cumsum(tau, dim=0)
        cumsum_taus[name] = c
        # np.searchsorted(c[:, w], at_tau) for every column w at once
        idx = torch.searchsorted(
            c.T.contiguous(), torch.full((len(wno), 1), float(at_tau),
                                         dtype=c.dtype, device=c.device)
        )[:, 0]
        i1 = idx.clamp(1, nlevel - 1)
        lo = c.gather(0, (i1 - 1)[None])[0]
        hi = c.gather(0, i1[None])[0]
        f = torch.where(hi == lo, torch.zeros_like(lo),
                        (at_tau - lo) / torch.where(hi == lo,
                                                    torch.ones_like(hi),
                                                    hi - lo))
        p_lo, p_hi = p_level[i1 - 1], p_level[i1]
        inside = torch.exp(torch.log(p_lo) + f * torch.log(p_hi / p_lo))
        tau_p_surface[name] = torch.where(
            idx >= nlevel, p_level[-1],
            torch.where(idx > 0, inside, torch.full_like(inside, np.nan)))
    return {'taus_per_layer': {k: _np(v) for k, v in taus.items()},
            'cumsum_taus': {k: _np(v) for k, v in cumsum_taus.items()},
            'tau_p_surface': {k: _np(v) for k, v in tau_p_surface.items()}}


def find_press(at_tau, a, b, c):
    """The pressure where each wavenumber's cumulative tau column crosses
    ``at_tau`` (justdoit.py:2313-2320 of the JAX package; the reference's
    justdoit.py:1290): per column, interpolation of the [nlayer, nwno] tau
    matrix ``a`` onto pressures ``c``; ``b`` is nwno."""
    a = np.asarray(a)
    c = np.asarray(c)
    return [float(np.interp(at_tau, a[:, iw], c)) for iw in range(b)]


# ---------------------------------------------------------------------------
# evolution tracks and the young-planet benchmarks (justdoit.py:1885-1935
# of the JAX package; the reference's justdoit.py:5536-5658)
# ---------------------------------------------------------------------------

_EVOL_COLS = ['age_years', 'logL', 'R_cm', 'Ts', 'Teff', 'log rc', 'log Pc',
              'log Tc', 'grav_cgs', 'Uth', 'Ugrav', 'log Lnuc']


def _evolution_table(start, imass):
    """One ``refdata/evolution/<start>/model_seq.*`` file as columns (the
    row-number column dropped, as pandas takes it for the index)."""
    tag = f'00{imass}0'
    if len(tag) == 5:
        tag = tag[1:]
    data = np.loadtxt(refdata_path('evolution', start, f'model_seq.{tag}'),
                      skiprows=12, ndmin=2)
    return {name: data[:, i + 1] for i, name in enumerate(_EVOL_COLS)}


def evolution_track(mass=1, age='all'):
    """Hot- and cold-start evolution tracks of 1-10 Jupiter-mass planets:
    {'hot': ..., 'cold': ...}, each the columns age_years, Teff,
    grav_cgs, logL, R_cm of the nearest tabulated mass (numpy arrays), or
    with a numeric ``age`` the row nearest that age (floats).
    ``mass='all'``: the same per mass, keyed '1Mj' ... '10Mj'."""
    valid = np.array([1, 2, 4, 6, 8, 10])
    cols_return = ['age_years', 'Teff', 'grav_cgs', 'logL', 'R_cm']

    def load(start, imass):
        table = _evolution_table(start, imass)
        return {c: table[c] for c in cols_return}

    def at_age(table):
        if isinstance(age, str):
            return table
        # pandas' argsort of |age_years - age| (quicksort, first of ties)
        i = int(np.argsort(np.abs(table['age_years'] - age),
                           kind='quicksort')[0])
        return {c: float(v[i]) for c, v in table.items()}

    if mass == 'all':
        out = {'hot': {}, 'cold': {}}
        for start in ('hot', 'cold'):
            for imass in valid:
                out[start][f'{imass}Mj'] = at_age(load(f'{start}_start',
                                                       imass))
        return out
    imass = int(valid[np.argmin(np.abs(valid - mass))])
    return {'hot': at_age(load('hot_start', imass)),
            'cold': at_age(load('cold_start', imass))}


def young_planets():
    """The benchmark young planets (the reference's justdoit.py:5640):
    {column: array} of ``refdata/evolution/benchmarks_age_lbol.csv`` (the
    names as strings, the rest float64)."""
    import csv
    with open(refdata_path('evolution', 'benchmarks_age_lbol.csv')) as f:
        rows = [r for r in csv.reader(f.readlines()[12:]) if r]
    header, rows = rows[0], rows[1:]
    out = {}
    for i, name in enumerate(header):
        col = [r[i] for r in rows]
        out[name] = (np.array(col, dtype=object) if name == 'name'
                     else np.array(col, dtype=np.float64))
    return out


# ---------------------------------------------------------------------------
# units and stored models
# ---------------------------------------------------------------------------

_WNO_UNITS = ('cm^(-1)', '1/cm', 'cm-1', '1 / cm')
_FLUX_ALIASES = {
    'erg*cm^(-3)*s^(-1)': 'per_cm', 'erg/(cm3s)': 'per_cm',
    'erg/(cm2scm)': 'per_cm',
    'flam': 'flam', 'erg/(cm2sangstrom)': 'flam', 'erg/(cm2saa)': 'flam',
    'fnu': 'fnu', 'erg/(cm2shz)': 'fnu',
    'jy': 'jy', 'mjy': 'mjy',
    'w/(m2um)': 'w_m2_um', 'w/(m2micron)': 'w_m2_um',
}
_FNU_SCALE = {'fnu': 1.0, 'jy': 1e-23, 'mjy': 1e-26}


def _flux_kind(name):
    key = str(name).replace(' ', '').lower()
    if key not in _FLUX_ALIASES:
        raise ValueError(f'unsupported flux unit {name!r}; supported: '
                         f'{sorted(set(_FLUX_ALIASES))}')
    return _FLUX_ALIASES[key]


def convert_flux_units(xgrid, flux, to_f_unit, xgrid_unit='cm^(-1)',
                       f_unit='erg*cm^(-3)*s^(-1)'):
    """Convert a spectral flux density between units (justdoit.py:2223-
    2289 of the JAX package; the reference's justdoit.py:5660-5688 goes
    through synphot, here the F_lambda / F_nu algebra is direct).  The
    defaults are PICASO's per-cm flux on a wavenumber grid; the output is
    ordered by increasing wavelength (reversed when the input was an
    increasing wavenumber grid).  Flux units: 'erg*cm^(-3)*s^(-1)' (per
    cm), 'FLAM' (erg/cm^2/s/angstrom), 'FNU' (erg/cm^2/s/Hz), 'Jy',
    'mJy', 'W/(m2 um)'."""
    from .constants import C_LIGHT
    xgrid = np.asarray(xgrid, float)
    flux = np.asarray(flux, float)
    if xgrid_unit in _WNO_UNITS:
        lam_cm = 1.0 / xgrid
    else:
        lam_cm = xgrid * u.Unit(xgrid_unit).cgs_factor

    # to F_lambda in erg/cm^2/s/cm
    kind = _flux_kind(f_unit)
    if kind == 'per_cm':
        f_lam = flux
    elif kind == 'flam':
        f_lam = flux * 1e8
    elif kind in _FNU_SCALE:
        f_nu = flux * _FNU_SCALE[kind]
        f_lam = f_nu * C_LIGHT / lam_cm ** 2
    else:  # w_m2_um
        f_lam = flux / 1e-7

    kind = _flux_kind(to_f_unit)
    if kind == 'per_cm':
        out = f_lam
    elif kind == 'flam':
        out = f_lam * 1e-8
    elif kind in _FNU_SCALE:
        f_nu = f_lam * lam_cm ** 2 / C_LIGHT
        out = f_nu / _FNU_SCALE[kind]
    else:  # w_m2_um
        out = f_lam * 1e-7

    if xgrid_unit in _WNO_UNITS and xgrid[1] > xgrid[0]:
        out = out[::-1]
    return out


def check_units(unit):
    """``u.Unit(unit)`` if it parses, else None (justdoit.py:2305-2310 of
    the JAX package)."""
    try:
        return u.Unit(unit)
    except ValueError:
        return None


def output_xarray(df, case, add_output=None, savefile=None, **kwargs):
    """Save a computed model (the reference's justdoit.py:705; the JAX
    package's justdoit.py:2291-2303): xarray is not a dependency, so the
    model goes through ``io_utils.save_model`` (a ``.nc`` path: the
    reference's NetCDF layout; else the hdf5 layout).  Returns the path."""
    from .io_utils import save_model
    if savefile is None:
        raise ValueError('give savefile= path for the stored model')
    return save_model(savefile, case, df, meta=add_output or {})


def merge_xarrays(ds1, ds2):
    """Merge two spectrum outputs that differ only in wavelength coverage
    (justdoit.py:2323-2348 of the JAX package; the reference's
    justdoit.py:664): arrays on the 'wavenumber' axis are concatenated and
    sorted by wavenumber, ds1 winning on overlap; every other key comes
    from ds1."""
    if 'wavenumber' not in ds1 or 'wavenumber' not in ds2:
        raise ValueError("both outputs need a 'wavenumber' axis")
    w1 = np.asarray(ds1['wavenumber'], np.float64)
    w2 = np.asarray(ds2['wavenumber'], np.float64)
    keep2 = ~np.isin(w2, w1)
    wno = np.concatenate([w1, w2[keep2]])
    order = np.argsort(wno)
    merged = dict(ds1)
    merged['wavenumber'] = wno[order]
    for key, v1 in ds1.items():
        if key == 'wavenumber' or not isinstance(v1, np.ndarray):
            continue
        v2 = ds2.get(key)
        if v1.shape[-1:] == w1.shape and isinstance(v2, np.ndarray) \
                and v2.shape[-1:] == w2.shape:
            cat = np.concatenate([v1, v2[..., keep2]], axis=-1)
            merged[key] = cat[..., order]
    return merged


def input_xarray(filename, opannection=None, **kwargs):
    """Rebuild an inputs bundle from a stored model (the reference's
    justdoit.py:979): ``io_utils.load_model``'s (case, spectra, attrs)."""
    from .io_utils import load_model
    return load_model(filename, opannection=opannection)
