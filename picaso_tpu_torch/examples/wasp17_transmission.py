"""Fit the bundled WASP-17b MIRI transmission spectrum.

Port of examples/wasp17_transmission.py to picaso_tpu_torch: an
end-to-end mini-retrieval on real data (justdoit.w17_data, Grant et al.
2023, justdoit.py:5505): classic-NetCDF ingest, batched transmission
forwards on the card, the wavelength-dependent-R instrument convolution
(conv_non_uniform_R, driver.py:338), and the ensemble sampler.
Synthetic opacities stand in for the 7 GB production DB, so the
recovered abundance is illustrative; the plumbing is the production
path.

    python picaso_tpu_torch/examples/wasp17_transmission.py [cpu]
"""

import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))

import numpy as np

from picaso_tpu_torch import justdoit as jdi, pipeline
from picaso_tpu_torch.ncio import read_netcdf
from picaso_tpu_torch.opacities.factory import build_synthetic_db
from picaso_tpu_torch.sampler import ensemble_sample
from picaso_tpu_torch.wavelength import conv_non_uniform_R

device = sys.argv[1] if len(sys.argv) > 1 else 'cuda'

# ---- data: WASP-17b 5-12 um (MIRI LRS), bundled ----
ds = read_netcdf(jdi.w17_data())
wl_obs = np.asarray(ds.coords['central_wavelength'].values)   # micron
half_width = np.asarray(ds['bin_half_width'].values
                        if 'bin_half_width' in ds.data_vars
                        else ds.coords['bin_half_width'].values)
y_obs = np.asarray(ds['transit_depth'].values)
e_obs = np.asarray(ds['transit_depth_error'].values)
R_obs = wl_obs / (2.0 * half_width)          # per-point resolving power
print(f'{len(wl_obs)} data points, {wl_obs.min():.2f}-{wl_obs.max():.2f} um,'
      f' mean depth {y_obs.mean():.4%}')

# ---- forward model: isothermal H2O atmosphere, WASP-17b system ----
db = os.path.join(tempfile.mkdtemp(), 'w17_syn.db')
wno_model = np.linspace(1e4 / 13.0, 1e4 / 4.5, 400)
build_synthetic_db(db, wno=wno_model, molecules=('H2O', 'CH4'),
                   device=device)
opa = jdi.opannection(filename_db=db, device=device)

nlevel = 25
pressure = np.logspace(-6, 2, nlevel)
RJ, MJ, RSUN = 7.1492e9, 1.898e30, 6.957e10
RSTAR = 1.58 * RSUN


def make_scene(tiso, log_h2o, xrp):
    mix = {'H2': np.full(nlevel, 0.85), 'He': np.full(nlevel, 0.15),
           'H2O': np.full(nlevel, 10.0 ** log_h2o),
           'CH4': np.full(nlevel, 1e-7)}
    scene, config = pipeline.scene_from_arrays(
        pressure, np.full(nlevel, tiso), mix, opa.grid,
        gravity=np.nan, radius=xrp * 1.93 * RJ, mass=0.78 * MJ,
        rstar=RSTAR)
    return scene, config


_, config = make_scene(1700.0, -3.0, 1.0)
config = dataclasses.replace(config, reflected=False, thermal=False,
                             transmission=True)
wno = opa.wno


def forward_batched(theta):
    theta = np.atleast_2d(theta)
    scenes = [make_scene(t, lw, xr)[0] for t, lw, xr in theta]
    batch = pipeline.stack_scenes(scenes)
    depth = pipeline.forward_batch(
        batch, opa.grid, config)['transit_depth'].double().cpu().numpy()
    # instrument convolution: model (ascending wno) -> data grid at the
    # per-point resolving power of the published binning
    wl_model = 1e4 / wno[::-1]
    return np.stack([conv_non_uniform_R(d[::-1], wl_model, R_obs, wl_obs)
                     for d in depth])


LO = np.array([500.0, -12.0, 0.5])
HI = np.array([3000.0, 0.0, 1.5])


def loglike(theta):
    theta = np.atleast_2d(theta)
    ok = np.all((theta > LO) & (theta < HI), axis=1)
    # clip instead of dropping rows: out-of-bounds walkers are rejected
    # by -inf
    safe = np.clip(theta, LO + 1e-6, HI - 1e-6)
    model = forward_batched(safe)
    chi2 = np.sum((model - y_obs) ** 2 / e_obs ** 2, axis=-1)
    return np.where(ok, -0.5 * chi2, -np.inf)


# ensemble MCMC: one walker batch per step = one batched forward per step
rng = np.random.default_rng(0)
nwalkers, nsteps = 16, 120
p0 = np.stack([1500.0 + 200.0 * rng.standard_normal(nwalkers),   # T [K]
               -3.0 + 0.5 * rng.standard_normal(nwalkers),       # log H2O
               1.0 + 0.01 * rng.standard_normal(nwalkers)], -1)  # Rp scale
chain, lps = ensemble_sample(loglike, p0, nsteps, seed=1)
flat = chain[nsteps // 2:].reshape(-1, 3)
best = flat[np.argmax(lps[nsteps // 2:].ravel())]
chi2 = -2.0 * float(loglike(best[None])[0]) / len(y_obs)
print(f'best sample: T={best[0]:.0f} K, log H2O={best[1]:.2f}, '
      f'xRp={best[2]:.4f}; chi2/N={chi2:.2f}')
assert np.isfinite(chi2)
assert chi2 < 50.0, 'fit should land in the right depth ballpark'
print('WASP-17 example OK')
