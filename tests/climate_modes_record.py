"""The JAX package's float64 climate solves of the climate modes, recorded.

Runs ``picaso_tpu``'s front door (``inputs(calculation='browndwarf',
climate=True)`` ... ``inputs_climate`` ... ``climate``) on the CPU in
float64 for each case of ``CASES`` and writes what chip_smoke.py's phases
34-37 and the port's CPU tests hold the port against:
tests/climate_modes_reference.json.  Each case stores its own parameters
beside its results, so the readers build the same problem from the file.

The cases are those of tests/test_climate_workflows.py:10-72 (a brown
dwarf at 100 m/s^2, no star, ``pressure = logspace(-4, 2.5, nlevel)``,
the guess ``clip(1.2 Teff (p / 30 bar)^0.1, 250 K)``, the synthetic CK
table with its per-gas tables) and the energy injection of
tests/test_climate_workflows.py:86:

- ``diseq``: 700 K, ``diseq_chem=True`` with self-consistent Kzz,
  quenching and resort-rebin mixing of the per-gas tables; ``diseq_t900``
  the same at 900 K and 1000 m/s^2 (a field T dwarf at log g 5);
- ``cloudy``: 1300 K, virga with Mg2SiO4 and Fe, fsed 2 (the cloud forms;
  geometric optics, no .mieff files);
- ``moist``: 350 K, ``moistgrad=True``;
- ``inject``: 700 K, a Chapman deposition of 1e5 erg/cm^2/s peaking at
  0.1 bar with scale-height ratio 1, and ``with_spec=True``;
- ``driver_moist_41``: the TOML driver's climate mode
  (``driver.setup_climate_class`` given the connection, then
  ``case.climate``) on the moist case at 41 levels, the driver's own
  guess.

At the production depth (91 levels; the convective-zone guess 20 levels
above the bottom, as chip_smoke.py's equilibrium solves) on the 196-bin
table, diseq also on the 661-bin one; and small (31 levels, the guess 28
of test_climate_workflows.py) on the stride-4, 48-bin slice of the 196-bin
table (tests/test_torch_climate_fluxes.py:sliced_tables), which the CPU
tests run.  Recorded per case: temperature, converged, cvz_locs, flux_net,
seconds; diseq the Kzz and the last quench levels; cloudy the column
optical depth per cloud wavenumber; inject the thermal spectrum.  Where a
host-path Newton solve returned NaN fluxes, the first such profile step
(``nan_onset``) and every profile step's temperatures (``all_profiles``):
there the Newton Jacobian was singular (a one-level convective zone,
ROADMAP Queue 3; tests/climate_nan_diagnose.py), and what a solve does
with such a step depends on how the platform rounds.

Each solve runs in a process of its own on one thread.  Not a test: a
91-level solve takes minutes.  ``--port`` runs the port's own solve of a
case on the CPU instead and keeps it in tests/climate_modes_port_cpu.json.

    python tests/climate_modes_record.py            # all cases
    python tests/climate_modes_record.py --cases diseq_31,moist_31
    python tests/climate_modes_record.py --port --cases diseq_661_91 \
        --threads 4
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
OUT = os.path.join(HERE, 'climate_modes_reference.json')
PORT_OUT = os.path.join(HERE, 'climate_modes_port_cpu.json')

GRAVITY = 100.0   # m/s^2
SLICE = (4, 192)  # stride, stop: the 48-bin slice of the 196-bin table


def _case(mode, nlevel, table=196, teff=None, gravity=GRAVITY):
    teff = teff or {'diseq': 700.0, 'cloudy': 1300.0, 'moist': 350.0,
                    'inject': 700.0}[mode]
    spec = dict(mode=mode, teff=teff, gravity=gravity, nlevel=nlevel,
                table=table, rcb_guess=28 if nlevel == 31 else nlevel - 20,
                slice=list(SLICE) if nlevel == 31 else None,
                diseq_chem=mode == 'diseq', moistgrad=mode == 'moist',
                with_spec=mode == 'inject', virga_kwargs=None,
                injection=None)
    if mode == 'cloudy':
        spec['virga_kwargs'] = {'condensates': ['Mg2SiO4', 'Fe'],
                                'fsed': 2.0, 'mh': 1.0, 'mmw': 2.2}
    if mode == 'inject':
        spec['injection'] = dict(inject_energy=True,
                                 total_energy_injection=1e5,
                                 press_max_energy=0.1,
                                 injection_scalehight=1.0)
    return spec


def driver_config(nlevel=41):
    """The TOML driver's climate mode on the moist case (driver.py:316-405
    of the JAX package; its own guess, clip(1.2 Teff (p / 30 bar)^0.1,
    max(Teff / 4, 100 K)), and the convective-zone guess nlevel - 20)."""
    return {'calc_type': 'climate',
            'object': {'gravity': {'value': GRAVITY, 'unit': 'm/(s**2)'}},
            'climate': {'teff': 350.0, 'nlevel': nlevel,
                        'rcb_guess': nlevel - 20, 'moistgrad': True,
                        'run_kwargs': {}}}


CASES = {}
for _mode in ('diseq', 'cloudy', 'moist', 'inject'):
    CASES[f'{_mode}_31'] = _case(_mode, 31)
    CASES[f'{_mode}_91'] = _case(_mode, 91)
CASES['diseq_661_91'] = _case('diseq', 91, table=661)
# a field T dwarf, where CO-CH4 quenching was first seen: 900 K at
# log g 5 (cgs).  Its diseq solve balances where the 700 K one at log g 4
# blows up (ROADMAP Queue 3)
for _nl, _table, _name in ((31, 196, 'diseq_t900_31'),
                           (91, 196, 'diseq_t900_91'),
                           (91, 661, 'diseq_t900_661_91')):
    CASES[_name] = _case('diseq', _nl, table=_table, teff=900.0,
                         gravity=1000.0)
CASES['driver_moist_41'] = dict(_case('moist', 41), mode='driver',
                                config=driver_config(41))


def profile_guess(spec):
    """(pressure [bar], guess [K]) of a case."""
    pressure = np.logspace(-4, 2.5, spec['nlevel'])
    guess = np.clip(spec['teff'] * 1.2 * (pressure / 30.0) ** 0.1, 250.0,
                    None)
    return pressure, guess


def jax_table(spec):
    """The JAX synthetic CK table of a case, float64, with its per-gas
    tables, sliced where the case says."""
    from picaso_tpu.opacities import ck as jck
    t = jck.synthetic_ck_table(dtype=np.float64, with_per_gas=True,
                               grid661=spec['table'] == 661)
    if not spec['slice']:
        return t
    stride, stop = spec['slice']
    sl = np.s_[:stop:stride]
    a = t.arrays
    return jck.CKTable(
        a._replace(wno=a.wno[sl], delta_wno=a.delta_wno[sl],
                   ln_kappa=a.ln_kappa[:, :, sl, :],
                   cont_opa=a.cont_opa[:, :, sl]),
        t.molecules, t.full_abunds, t.gauss_pts, t.temps, t.pressures,
        per_gas=t.per_gas[:, :, :, sl, :],
        per_gas_molecules=t.per_gas_molecules, wno=t.wno[sl],
        delta_wno=t.delta_wno[sl], gauss_wts=t.gauss_wts)


def jax_facade_case(jdi, spec):
    """The JAX front door's case, ready for ``case.climate``."""
    case = jdi.inputs(calculation='browndwarf', climate=True)
    case.effective_temp(spec['teff'])
    case.gravity(gravity=spec['gravity'],
                 gravity_unit=jdi.u.Unit('m/(s**2)'))
    pressure, guess = profile_guess(spec)
    case.inputs_climate(temp_guess=guess, pressure=pressure,
                        rcb_guess=spec['rcb_guess'], rfacv=0.0,
                        moistgrad=spec['moistgrad'])
    if spec['diseq_chem']:
        case.inputs['approx']['chem_params']['quench'] = True
    if spec['virga_kwargs']:
        case.inputs['climate']['cloudy'] = True
        case.inputs['climate']['virga_kwargs'] = dict(spec['virga_kwargs'])
    if spec['injection']:
        case.energy_injection(**spec['injection'])
    return case


def _jax_f64_on_cpu():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    return jax


def run_jax(spec):
    jax = _jax_f64_on_cpu()
    from picaso_tpu import chemistry
    from picaso_tpu import justdoit as jdi

    quench = {}
    inner = chemistry.quench_levels

    def recording(*args, **kwargs):
        out = inner(*args, **kwargs)
        quench.clear()
        quench.update({k: int(v) for k, v in out[0].items()})
        return out

    chemistry.quench_levels = recording
    # the host path's Newton solves (diseq, cloudy): the first profile step
    # whose fluxes came back NaN, where the solve leaves what its numbers
    # define (platforms round exp and log differently near overflow)
    from picaso_tpu.climate import fused
    steps, nan_steps = [0], []
    newton = fused.newton_solve

    def watching(*args, **kwargs):
        out = newton(*args, **kwargs)
        if not isinstance(out[2], jax.core.Tracer):
            if np.isnan(np.asarray(out[2])).any():
                nan_steps.append(steps[0])
            steps[0] += 1
        return out

    fused.newton_solve = watching
    opa = jdi.opannection(ck_table=jax_table(spec))
    t0 = time.perf_counter()
    if spec['mode'] == 'driver':
        from picaso_tpu import driver
        config = spec['config']
        case, opa = driver.setup_climate_class(config, opa=opa)
        out = case.climate(opa, verbose=False,
                           **config['climate']['run_kwargs'])
    else:
        case = jax_facade_case(jdi, spec)
        out = case.climate(opa, diseq_chem=spec['diseq_chem'],
                           with_spec=spec['with_spec'], verbose=False,
                           save_all_profiles=True)
    seconds = time.perf_counter() - t0
    rec = dict(temperature=np.asarray(out['temperature'], float),
               converged=int(out['converged']),
               cvz_locs=[int(i) for i in out['cvz_locs']],
               flux_net=np.asarray(out['flux_balance']['flux_net'], float),
               seconds=seconds)
    if nan_steps:
        rec['nan_onset'] = nan_steps[0]
        rec['all_profiles'] = np.asarray(out['all_profiles'], float)
    if spec['diseq_chem']:
        rec['kzz'] = np.asarray(out['kzz'], float)
        rec['quench_levels'] = dict(quench)
    if spec['virga_kwargs']:
        nlayer = spec['nlevel'] - 1
        rec['column_opd'] = np.reshape(
            np.asarray(out['cld_df']['opd'], float), (nlayer, -1)).sum(0)
    if spec['with_spec']:
        rec['thermal'] = np.asarray(out['spectrum_output']['thermal'],
                                    float)
    return rec


def run_port(spec):
    """The port's float64 solve of a case on the CPU, through its front
    door as chip_smoke.py's phases 34-37 drive it on the card: the third
    witness where the card leaves the JAX record.  ``--port`` keeps these
    in tests/climate_modes_port_cpu.json."""
    import torch
    _jax_f64_on_cpu()   # the JAX table the port's is copied from
    from picaso_tpu_torch import justdoit as tdi
    from picaso_tpu_torch.climate import fused
    from torch_climate_modes_cases import port_table

    steps, nan_steps = [0], []
    newton = fused.newton_solve

    def watching(*args, **kwargs):
        out = newton(*args, **kwargs)
        if torch.isnan(out[2]).any():
            nan_steps.append(steps[0])
        steps[0] += 1
        return out

    fused.newton_solve = watching
    opa = tdi.opannection(ck_table=port_table(jax_table(spec)),
                          device='cpu')
    case = jax_facade_case(tdi, spec)
    t0 = time.perf_counter()
    out = case.climate(opa, diseq_chem=spec['diseq_chem'],
                       with_spec=spec['with_spec'], verbose=False,
                       save_all_profiles=True)
    rec = dict(temperature=np.asarray(out['temperature'], float),
               converged=int(out['converged']),
               cvz_locs=[int(i) for i in out['cvz_locs']],
               seconds=time.perf_counter() - t0,
               threads=torch.get_num_threads(),
               source='the port, float64 on the CPU '
                      '(tests/climate_modes_record.py --port)')
    if nan_steps:
        rec['nan_onset'] = nan_steps[0]
    if spec['diseq_chem']:
        rec['quench_levels'] = {k: int(v) for k, v in
                                out['quench_levels'].items()}
        rec['kzz_nan_levels'] = int(np.isnan(out['kzz']).sum())
    return rec


def _jsonable(rec):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in rec.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cases', default=','.join(CASES))
    ap.add_argument('--jobs', type=int, default=4)
    ap.add_argument('--out', help=f'default {OUT}, with --port {PORT_OUT}')
    ap.add_argument('--port', action='store_true',
                    help="run the port's solve on the CPU instead")
    ap.add_argument('--threads', type=int, default=1)
    ap.add_argument('--one', help=argparse.SUPPRESS)
    ap.add_argument('--to', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        run = run_port if args.port else run_jax
        with open(args.to, 'w') as f:
            json.dump(_jsonable(run(CASES[args.one])), f)
        return 0

    names = args.cases.split(',')
    out_path = args.out or (PORT_OUT if args.port else OUT)
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               OMP_NUM_THREADS=str(args.threads),
               XLA_FLAGS='--xla_cpu_multi_thread_eigen=false '
                         'intra_op_parallelism_threads=1')
    saved = {}
    if os.path.exists(out_path):
        with open(out_path) as f:
            saved = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        pending, running = list(names), {}
        try:
            while pending or running:
                while pending and len(running) < args.jobs:
                    name = pending.pop(0)
                    path = os.path.join(tmp, name + '.json')
                    running[name] = (subprocess.Popen(
                        [sys.executable, __file__, '--one', name, '--to',
                         path] + (['--port'] if args.port else []),
                        env=env), path)
                for name, (proc, path) in list(running.items()):
                    if proc.poll() is None:
                        continue
                    del running[name]
                    if proc.returncode != 0:
                        raise SystemExit(f'{name} failed')
                    with open(path) as f:
                        rec = json.load(f)
                    saved[name] = dict(case=CASES[name], **rec)
                    if not args.port:
                        saved[name]['source'] = (
                            'the JAX package, float64 on the CPU '
                            '(tests/climate_modes_record.py)')
                    print(json.dumps({name: {
                        k: rec[k] for k in ('converged', 'cvz_locs',
                                            'seconds')}}), flush=True)
                    with open(out_path, 'w') as f:
                        json.dump(saved, f, indent=1, sort_keys=True)
                        f.write('\n')
                time.sleep(1.0)
        finally:
            for proc, _ in running.values():
                proc.kill()
    return 0


if __name__ == '__main__':
    sys.exit(main())
