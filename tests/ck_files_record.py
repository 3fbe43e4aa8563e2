"""The JAX package's float64 solves on a correlated-k table read from a
file: the records chip_smoke.py holds the port's card runs against
(phases 39-42).

The table is the legacy 1460-grid ASCII layout (24 species, 73 x 20
(T, P) points, 196 of 200 windows, 8 gauss points) holding
``picaso_tpu_torch.opacities.legacy.synthetic_legacy_table()``, written by
the JAX package's ``write_legacy_ascii`` and read back by its
``load_ck_db`` in float64, on the CPU.  Recorded:

- ``file``: the file's SHA-256 and size (the port's writer must write the
  same bytes);
- ``climate_91``: ``inputs.climate`` of a 700 K, 100 m/s^2 brown dwarf at
  91 levels on the 196-bin table (bench.py's guess, the convective zone
  guessed 20 levels above the bottom): temperatures, ``converged``,
  ``cvz_locs``, the flux balance;
- ``t_start_91``: one host Newton solve (``climate.core.t_start``) from
  that guess with one convective zone (nstr [0, 71, 89, 0, 0, 0]) at the
  guess's equilibrium chemistry: temperatures, Newton steps,
  ``converged``;
- ``driver_41``: ``driver.run`` in climate mode at 41 levels from a TOML
  config whose ``[OpticalProperties] ck_db`` is the table's directory
  (the config is stored without the path).

Only profiles, scalars and hashes are kept.  Each solve runs in a process
of its own, in parallel; the 91-level solve takes minutes.  Not a test.

    python tests/ck_files_record.py --save tests/ck_files_reference.json
    python tests/ck_files_record.py --parts file,t_start_91
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

TEFF = 700.0
GRAVITY = 100.0              # m/s^2
SIGMA_SB = 5.670374419e-5
PARTS = ('file', 'climate_91', 't_start_91', 'driver_41')
DRIVER_CONFIG = {
    'calc_type': 'climate',
    'OpticalProperties': {'opacity_method': 'preweighted',
                          'opacity_kwargs': {'dtype': 'float64'}},
    'object': {'gravity': {'value': GRAVITY, 'unit': 'm/(s**2)'}},
    'climate': {'teff': TEFF, 'nlevel': 41, 'logp_top': -4.0,
                'logp_bottom': 2.5, 'rcb_guess': 31, 'rfacv': 0.0,
                'run_kwargs': {}},
}


def guess(nlevel):
    """bench.py's climate guess and convective-zone guess."""
    pressure = np.logspace(-4, 2.5, nlevel)
    temp = np.clip(TEFF * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    return pressure, temp, nlevel - 20


def balance(flux_net, nstr):
    return float(np.abs(np.asarray(flux_net)[:max(nstr[1], 1)]).max()
                 / (SIGMA_SB * TEFF ** 4))


def write_file(directory):
    from picaso_tpu.opacities.legacy import write_legacy_ascii
    from picaso_tpu_torch.opacities.legacy import synthetic_legacy_table
    path = os.path.join(directory, 'ascii_data')
    write_legacy_ascii(path, **synthetic_legacy_table())
    with open(path, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return dict(sha256=digest, bytes=os.path.getsize(path),
                writer='picaso_tpu.opacities.legacy.write_legacy_ascii',
                data='picaso_tpu_torch.opacities.legacy.'
                     'synthetic_legacy_table()')


def run_part(part, directory):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    from picaso_tpu import driver
    from picaso_tpu import justdoit as jdi
    from picaso_tpu.opacities.ck import load_ck_db

    if part == 'driver_41':
        config = json.loads(json.dumps(DRIVER_CONFIG))
        config['OpticalProperties']['ck_db'] = directory
        _, out = driver.run(config, verbose=False)
        nstr = [int(i) for i in out['cvz_locs']]
        return dict(case=dict(config=DRIVER_CONFIG),
                    temperature=[float(t) for t in out['temperature']],
                    converged=int(out['converged']), cvz_locs=nstr,
                    flux_balance=balance(out['flux_balance']['flux_net'],
                                         nstr))

    ck = load_ck_db(directory, dtype=np.float64)
    nlevel = 91
    pressure, temp0, rcb = guess(nlevel)
    case = dict(teff=TEFF, gravity=GRAVITY, nlevel=nlevel, rcb_guess=rcb,
                guess='clip(teff * (p / 10 bar)^0.12, 250, 2800) K at '
                      'logspace(-4, 2.5, nlevel) bar')
    if part == 'climate_91':
        opa = jdi.opannection(ck_table=ck)
        bundle = jdi.inputs(calculation='brown', climate=True)
        bundle.phase_angle(0)
        bundle.gravity(gravity=GRAVITY, gravity_unit=jdi.u.Unit('m/(s**2)'))
        bundle.effective_temp(TEFF)
        bundle.setup_nostar()
        bundle.setup_climate()
        bundle.inputs_climate(temp_guess=temp0, pressure=pressure,
                              rcb_guess=rcb, rfacv=0.0)
        out = bundle.climate(opa, verbose=False)
        nstr = [int(i) for i in out['cvz_locs']]
        return dict(case=case,
                    temperature=[float(t) for t in out['temperature']],
                    converged=int(out['converged']), cvz_locs=nstr,
                    flux_balance=balance(out['flux_balance']['flux_net'],
                                         nstr))

    # t_start_91: the host Newton solve at the guess's chemistry
    import jax.numpy as jnp
    import pandas as pd
    from picaso_tpu.chemistry import chem_grid_from_table, chem_interp
    from picaso_tpu.climate import core
    from picaso_tpu.climate.adiabat import load_adiabat_grid
    from picaso_tpu.climate.api import ck_rtprops
    from picaso_tpu.rt import toon

    grid = chem_grid_from_table(ck.full_abunds)
    abunds = np.asarray(chem_interp(grid, jnp.asarray(temp0),
                                    jnp.asarray(pressure)))
    df = pd.DataFrame({'pressure': pressure, 'temperature': temp0})
    for i, sp in enumerate(grid.species):
        df[sp] = abunds[:, i]
    props, _ = ck_rtprops(df, ck, GRAVITY * 100.0)
    nstr = [0, rcb, nlevel - 2, 0, 0, 0]
    tmin, tmax = float(ck.temps.min()) * 0.7, float(ck.temps.max()) * 1.3
    res = core.t_start(
        temp0, pressure * 1e6, nstr, 1, props, core.make_climate_geometry(),
        np.asarray(ck.wno), np.asarray(ck.arrays.delta_wno),
        np.asarray(ck.arrays.gauss_wts), 0.0, np.zeros(len(ck.wno)),
        toon.ScatteringControls(), load_adiabat_grid(), 1.0, 0.0,
        np.asarray(core.tidal_flux(TEFF, nlevel)), tmin, tmax, it_max=10,
        save_profiles=True)
    case.update(nstr=nstr, nofczns=1, it_max=10, tmin=tmin, tmax=tmax,
                rfacv=0.0)
    return dict(case=case, temperature=[float(t) for t in res.temp],
                iterations=len(res.profiles), converged=int(res.converged))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--parts', default=','.join(PARTS))
    ap.add_argument('--save', help='JSON file to merge the records into')
    ap.add_argument('--one', help=argparse.SUPPRESS)
    ap.add_argument('--dir', help=argparse.SUPPRESS)
    ap.add_argument('--out', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        t0 = time.perf_counter()
        rec = run_part(args.one, args.dir)
        rec['seconds'] = time.perf_counter() - t0
        with open(args.out, 'w') as f:
            json.dump(rec, f)
        return 0

    parts = args.parts.split(',')
    records = {}
    with tempfile.TemporaryDirectory() as tmp:
        records['file'] = write_file(tmp)
        env = dict(os.environ, JAX_PLATFORMS='cpu')
        procs = {p: subprocess.Popen(
            [sys.executable, __file__, '--one', p, '--dir', tmp, '--out',
             os.path.join(tmp, p + '.json')], env=env)
            for p in parts if p != 'file'}
        try:
            for p, proc in procs.items():
                if proc.wait() != 0:
                    raise SystemExit(f'{p} failed')
        finally:
            for proc in procs.values():
                proc.kill()
        for p in procs:
            with open(os.path.join(tmp, p + '.json')) as f:
                records[p] = json.load(f)
    for p, rec in records.items():
        print(json.dumps({p: {k: v for k, v in rec.items()
                              if k != 'temperature'}}), flush=True)
    if args.save:
        saved = {}
        if os.path.exists(args.save):
            with open(args.save) as f:
                saved = json.load(f)
        saved.update({p: dict(rec, source='the JAX package, float64 on the '
                                           'CPU (tests/ck_files_record.py)')
                      for p, rec in records.items()})
        with open(args.save, 'w') as f:
            json.dump(saved, f, indent=1, sort_keys=True)
            f.write('\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
