"""The climate solve in float32 and float64 on the CPU, in the JAX package
and in the port, at one depth: does the float32 solve find the float64 one?

The problem is chip_smoke.py's (bench.py:492-513's brown dwarf: 700 K,
100 m/s^2, no star, ``pressure = logspace(-4, 2.5, nlevel)``, the guess of
bench.py:511, the convective-zone guess ``nlevel - 20``, or 31 at 41
levels as scripts/tpu_parity.py has it) on the synthetic 196- or 661-bin
CK table.  Each solve runs in a process of its own (the JAX package's
float32 needs x64 off before any array exists):

- ``jax32``: the JAX ``run_climate`` with x64 off, on its float32 table,
  as scripts/tpu_parity.py runs it on a TPU;
- ``jax64``: the same with x64 on, on the float64 table;
- ``torch32`` / ``torch64``: the port's ``run_climate`` on the CPU in
  float32 / float64, on the float64 table moved to that dtype, as
  chip_smoke.py runs it on the card.

Prints one JSON line per solve (converged, cvz_locs, the flux balance
max |flux_net| / (sigma Teff^4) over the radiative zone, max |dT| to the
JAX float64 solve, the top and bottom temperatures, seconds), then one
line with all of them.  Not a test: a float32 solve at 91 levels takes
minutes on one CPU thread.  ``--save`` merges the JAX float64 solve
(temperature, converged, cvz_locs) into a JSON file under the key
``<table>_<nlevel>``: chip_smoke.py holds the card's solve against
tests/climate_reference.json, written so.

    python tests/climate_f32_record.py --nlevel 91 --table 196
    python tests/climate_f32_record.py --nlevel 91 --table 661 \\
        --runs jax64,jax32 --save tests/climate_reference.json
"""

import argparse
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
SIGMA_SB = 5.670374419e-5


def problem(nlevel):
    pressure = np.logspace(-4, 2.5, nlevel)
    guess = np.clip(TEFF * (pressure / 10.0) ** 0.12, 250.0, 2800.0)
    rcb = 31 if nlevel == 41 else nlevel - 20
    return pressure, guess, rcb


def run_jax(nlevel, table, x64):
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', x64)
    from picaso_tpu import justdoit as jdi
    from picaso_tpu.opacities.ck import synthetic_ck_table
    ck = synthetic_ck_table(dtype=np.float64 if x64 else np.float32,
                            grid661=(table == 661))
    opa = jdi.opannection(ck_table=ck, method='preweighted')
    case = jdi.inputs(calculation='brown', climate=True)
    case.phase_angle(0)
    case.gravity(gravity=100.0, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.effective_temp(TEFF)
    case.setup_nostar()
    case.setup_climate()
    pressure, guess, rcb = problem(nlevel)
    case.inputs_climate(temp_guess=guess, pressure=pressure, rcb_guess=rcb,
                        rfacv=0.0)
    out = case.climate(opa, verbose=False)
    return (np.asarray(out['temperature'], np.float64),
            int(out['converged']), [int(i) for i in out['cvz_locs']],
            np.asarray(out['flux_balance']['flux_net'], np.float64))


def run_torch(nlevel, table, f64):
    import torch
    from picaso_tpu_torch.climate import api
    from picaso_tpu_torch.opacities.ck import synthetic_ck_table
    torch.set_num_threads(1)
    ck = synthetic_ck_table(grid661=(table == 661), device='cpu',
                            dtype=torch.float64)
    pressure, guess, rcb = problem(nlevel)
    inputs = api.ClimateInputs(t_eff=TEFF, gravity=1e4, pressure=pressure,
                               guess=guess,
                               nstr=(0, rcb, nlevel - 2, 0, 0, 0))
    out = api.run_climate(inputs, ck, verbose=False, device='cpu',
                          dtype=torch.float64 if f64 else torch.float32)
    return (out['temperature'], int(out['converged']),
            [int(i) for i in out['cvz_locs']],
            out['flux_balance']['flux_net'])


def one(kind, nlevel, table, path):
    t0 = time.perf_counter()
    if kind.startswith('jax'):
        temp, conv, cvz, flux_net = run_jax(nlevel, table, kind == 'jax64')
    else:
        temp, conv, cvz, flux_net = run_torch(nlevel, table,
                                              kind == 'torch64')
    np.savez(path, temperature=temp, converged=conv, cvz_locs=cvz,
             flux_net=flux_net, seconds=time.perf_counter() - t0)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--nlevel', type=int, default=91)
    ap.add_argument('--table', type=int, choices=(196, 661), default=196)
    ap.add_argument('--runs', default='jax64,jax32,torch64,torch32')
    ap.add_argument('--save', help='JSON file to merge the jax64 solve into')
    ap.add_argument('--one', help=argparse.SUPPRESS)
    ap.add_argument('--out', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        one(args.one, args.nlevel, args.table, args.out)
        return 0

    kinds = args.runs.split(',')
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1',
                   XLA_FLAGS='--xla_cpu_multi_thread_eigen=false '
                             'intra_op_parallelism_threads=1')
        procs = {k: subprocess.Popen(
            [sys.executable, __file__, '--one', k, '--nlevel',
             str(args.nlevel), '--table', str(args.table), '--out',
             os.path.join(tmp, k + '.npz')], env=env) for k in kinds}
        try:
            for k, p in procs.items():
                if p.wait() != 0:
                    raise SystemExit(f'{k} failed')
        finally:
            for p in procs.values():
                p.kill()
        res = {k: dict(np.load(os.path.join(tmp, k + '.npz')))
               for k in kinds}
    ref = res.get('jax64')
    rows = {}
    for k, r in res.items():
        nstr = [int(i) for i in r['cvz_locs']]
        balance = float(np.abs(r['flux_net'][:max(nstr[1], 1)]).max()
                        / (SIGMA_SB * TEFF ** 4))
        row = dict(run=k, nlevel=args.nlevel, table=args.table,
                   converged=int(r['converged']), cvz_locs=nstr,
                   flux_balance=balance,
                   t_top=float(r['temperature'][0]),
                   t_bottom=float(r['temperature'][-1]),
                   seconds=float(r['seconds']))
        if ref is not None:
            row['max_dT_to_jax64'] = float(
                np.abs(r['temperature'] - ref['temperature']).max())
        rows[k] = row
        print(json.dumps(row), flush=True)
    print(json.dumps({'climate_f32_record': rows}))
    if args.save:
        saved = {}
        if os.path.exists(args.save):
            with open(args.save) as f:
                saved = json.load(f)
        saved[f'{args.table}_{args.nlevel}'] = dict(
            source='the JAX package, float64 on the CPU '
                   '(tests/climate_f32_record.py)',
            converged=int(ref['converged']),
            cvz_locs=[int(i) for i in ref['cvz_locs']],
            temperature=[float(t) for t in ref['temperature']])
        with open(args.save, 'w') as f:
            json.dump(saved, f, indent=1, sort_keys=True)
            f.write('\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
