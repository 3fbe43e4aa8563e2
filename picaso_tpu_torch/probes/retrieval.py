"""The retrieval cases at full width, and where a likelihood's time goes.

The cases that ``chip_smoke.py``'s phases 30-33 run on the production
table (nwno 50 000, 16 molecules on the ragged 1060-point grid), each built
as the JAX package's examples build it:

* :class:`FreeRetrieval`: ``examples/retrieval_nested.py``'s free retrieval
  (isothermal T, log H2O; CH4 fixed, H2/He background) at 91 levels, one
  ``scene_from_arrays`` per parameter point and one ``forward_batch`` per
  sampler batch: transmission-only (K1 per scene) or thermal-only (K1 +
  K4 per scene);
* :class:`W17Retrieval`: ``examples/wasp17_transmission.py``'s fit of the
  bundled WASP-17b MIRI spectrum (``justdoit.w17_data``, classic NetCDF):
  the transmission forward convolved onto the data's per-point resolving
  power (``wavelength.conv_non_uniform_R``);
* :func:`driver_config`: ``driver_example.toml`` at 91 levels, whose
  likelihood (``driver.log_likelihood``) is one front-door spectrum.

Run as a script on a CUDA machine, this module times one 12-scene batch of
each free retrieval and one driver likelihood of each observation type,
splits each into the host's time by function (``cProfile``) and the
card's busy time and launches (``torch.profiler``), prints one JSON line
and appends it to ``--out``:

    python -m picaso_tpu_torch.probes.retrieval [--out FILE]
"""

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import time

import numpy as np

NWNO = 50_000
NLEVEL = 91
RJ, MJ, RSUN = 7.1492e9, 1.898e30, 6.957e10


class FreeRetrieval:
    """``examples/retrieval_nested.py`` on ``grid`` at ``nlevel`` levels:
    theta = (T_iso [K], log10 H2O), the data the model at ``truth`` plus
    seeded noise of 2 % of its mean (or ``data=(y, err)`` given).  ``kind``
    'transmission' fits transit depths, 'thermal' the thermal flux.
    ``scenes`` counts the parameter points evaluated, ``batch_ms`` the wall
    ms of each ``forward`` call (to the end of the card's work)."""

    def __init__(self, grid, kind='transmission', nlevel=NLEVEL,
                 truth=(1150.0, -3.2), seed=0, data=None):
        self.grid = grid
        self.kind = kind
        self.scenes = 0
        self.batch_ms = []
        self.key = 'transit_depth' if kind == 'transmission' else 'thermal'
        self.pressure = np.logspace(-6, 2, nlevel)
        _, config = self.scene(1000.0, -3.0)
        self.config = dataclasses.replace(
            config, reflected=False, thermal=kind == 'thermal',
            transmission=kind == 'transmission')
        self.truth = np.asarray(truth)
        if data is None:
            y_true = self.forward([truth])[0]
            self.err = 0.02 * y_true.mean()
            self.y = y_true + np.random.default_rng(seed).normal(
                0, self.err, y_true.shape)
        else:
            self.y, self.err = data
        self.scenes = 0
        self.batch_ms = []

    def scene(self, tiso, log_h2o):
        from .. import pipeline
        n = len(self.pressure)
        mix = {'H2': np.full(n, 0.86), 'He': np.full(n, 0.14),
               'H2O': np.full(n, 10.0 ** log_h2o),
               'CH4': np.full(n, 1e-4)}
        return pipeline.scene_from_arrays(
            self.pressure, np.full(n, tiso), mix, self.grid,
            gravity=np.nan, radius=1.2 * RJ, mass=0.8 * MJ,
            rstar=0.9 * RSUN)

    def forward(self, theta):
        """[n, 2] parameter points -> [n, nwno] float64 spectra: one
        ``forward_batch``, one copy off the device."""
        from .. import pipeline
        theta = np.atleast_2d(theta)
        t0 = time.perf_counter()
        batch = pipeline.stack_scenes([self.scene(t, lw)[0]
                                       for t, lw in theta])
        out = pipeline.forward_batch(batch, self.grid, self.config)
        spectra = out[self.key].cpu().numpy().astype(np.float64)
        self.batch_ms.append((time.perf_counter() - t0) * 1e3)
        self.scenes += len(theta)
        return spectra

    def loglike(self, theta):
        model = self.forward(theta)
        return -0.5 * np.sum((model - self.y) ** 2 / self.err ** 2, axis=1)

    @staticmethod
    def prior(u):
        u = np.atleast_2d(u).copy()
        u[:, 0] = 800.0 + 800.0 * u[:, 0]      # T_iso
        u[:, 1] = -5.0 + 3.0 * u[:, 1]         # log H2O
        return u


class W17Retrieval:
    """``examples/wasp17_transmission.py`` on ``grid`` at ``nlevel``
    levels: the bundled WASP-17b spectrum (28 points, 5-12 um) fitted with
    theta = (T_iso [K], log10 H2O, radius scale); the transit depths
    convolved onto the data's wavelengths at each point's resolving power
    on the grid's device.  ``scenes`` counts the parameter points
    evaluated."""

    LO = np.array([500.0, -12.0, 0.5])
    HI = np.array([3000.0, 0.0, 1.5])

    def __init__(self, grid, nlevel=NLEVEL):
        from .. import justdoit as jdi
        from ..ncio import read_netcdf
        self.grid = grid
        self.pressure = np.logspace(-6, 2, nlevel)
        ds = read_netcdf(jdi.w17_data())
        # the classic file stores big-endian values: native float64 here
        self.wl_obs = np.asarray(ds.coords['central_wavelength'].values,
                                 np.float64)
        half_width = np.asarray(ds['bin_half_width'].values
                                if 'bin_half_width' in ds.data_vars
                                else ds.coords['bin_half_width'].values,
                                np.float64)
        self.y = np.asarray(ds['transit_depth'].values, np.float64)
        self.e = np.asarray(ds['transit_depth_error'].values, np.float64)
        self.R_obs = self.wl_obs / (2.0 * half_width)
        _, config = self.scene(1700.0, -3.0, 1.0)
        self.config = dataclasses.replace(config, reflected=False,
                                          thermal=False, transmission=True)
        self.wl_model = 1e4 / grid.wno.detach().cpu().numpy()[::-1]
        self.scenes = 0

    def scene(self, tiso, log_h2o, xrp):
        from .. import pipeline
        n = len(self.pressure)
        mix = {'H2': np.full(n, 0.85), 'He': np.full(n, 0.15),
               'H2O': np.full(n, 10.0 ** log_h2o),
               'CH4': np.full(n, 1e-7)}
        return pipeline.scene_from_arrays(
            self.pressure, np.full(n, tiso), mix, self.grid,
            gravity=np.nan, radius=xrp * 1.93 * RJ, mass=0.78 * MJ,
            rstar=1.58 * RSUN)

    def forward(self, theta):
        """[n, 3] parameter points -> [n, 28] float64 model depths at the
        data's wavelengths."""
        from .. import pipeline
        from ..wavelength import conv_non_uniform_R
        theta = np.atleast_2d(theta)
        batch = pipeline.stack_scenes([self.scene(*t)[0] for t in theta])
        depth = pipeline.forward_batch(batch, self.grid,
                                       self.config)['transit_depth']
        self.scenes += len(theta)
        return np.stack([conv_non_uniform_R(
            d.flip(0), self.wl_model, self.R_obs, self.wl_obs).cpu().numpy()
            for d in depth]).astype(np.float64)

    def loglike(self, theta):
        theta = np.atleast_2d(theta)
        ok = np.all((theta > self.LO) & (theta < self.HI), axis=1)
        safe = np.clip(theta, self.LO + 1e-6, self.HI - 1e-6)
        chi2 = np.sum((self.forward(safe) - self.y) ** 2 / self.e ** 2,
                      axis=-1)
        return np.where(ok, -0.5 * chi2, -np.inf)

    def walkers(self, nwalkers, seed=0):
        """examples/wasp17_transmission.py's starting walkers."""
        rng = np.random.default_rng(seed)
        return np.stack([1500.0 + 200.0 * rng.standard_normal(nwalkers),
                         -3.0 + 0.5 * rng.standard_normal(nwalkers),
                         1.0 + 0.01 * rng.standard_normal(nwalkers)], -1)


def driver_config(observation_type='transmission', nlevel=NLEVEL,
                  opacity_files=''):
    """``refdata/input_tomls/driver_example.toml`` at ``nlevel`` levels:
    isothermal T, free H2O and CH4 on H2/He, a 5400 K blackbody star;
    priors on T and log H2O."""
    from .. import driver
    from ..refdata import refdata_path
    config = driver.load_toml(refdata_path('input_tomls',
                                           'driver_example.toml'))
    config['observation_type'] = observation_type
    config['temperature']['pressure']['nlevel'] = nlevel
    config['OpticalProperties']['opacity_files'] = opacity_files
    config['OpticalProperties']['wave_range'] = None
    return config


def driver_data(config, opa, truth=(1000.0, -3.0), npoint=40, seed=0):
    """(data_wno, y, e): the driver's model at ``truth`` binned onto
    ``npoint`` wavenumbers across 1-10 um, 1 % noise."""
    from .. import driver
    data_wno = np.sort(1e4 / np.linspace(1.0, 10.0, npoint))
    fit = driver.prior_finder(config)
    y = driver.MODEL(list(truth), config, opa, fit, data_wno)
    e = np.full(npoint, 0.01 * np.abs(y).mean())
    y = y + np.random.default_rng(seed).normal(0, e)
    return data_wno, y, e


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default='build/retrieval.jsonl')
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('retrieval: no CUDA device')
    from .. import driver, justdoit as jdi, pipeline
    from .front_door import _profiled
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    _, grid, _ = pipeline.build_problem(NWNO, nlevel=NLEVEL, device='cuda')
    opa = jdi.Opacity(grid.wno, grid=grid)
    thetas = FreeRetrieval.prior(np.random.default_rng(1).random((12, 2)))
    result = {'card': smi[0], 'nwno': NWNO}
    for kind in ('transmission', 'thermal'):
        case = FreeRetrieval(grid, kind)
        result[f'batch12_{kind}'] = _profiled(lambda: case.loglike(thetas))
    for obs in ('transmission', 'thermal', 'reflected'):
        config = driver_config(obs)
        data = driver_data(config, opa)
        fit = driver.prior_finder(config)
        result[f'driver_{obs}'] = _profiled(lambda: driver.log_likelihood(
            [1100.0, -3.5], copy.deepcopy(config), opa, fit, *data))
    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
