"""The JAX package's float64 climate solves with mocked photochemical
kinetics, recorded.

Runs ``picaso_tpu``'s front door on the CPU in float64 with the kinetics
of tests/test_photochem_climate.py:19-36 (``MockPhotochem``: CH4 frozen at
its deepest value, every other gas as the quench-adjusted chemistry left
it) in ``inputs['climate']['pc']``, ``diseq_chem=True``, on the field T
dwarf of tests/climate_modes_record.py (900 K, 1000 m/s^2, no star, the
synthetic CK table with its per-gas tables):

- ``photochem_t900_91``: 91 levels on the 196-bin table, the case of
  chip_smoke.py's photochemistry phase (``diseq_t900_91`` with kinetics);
- ``photochem_t900_31``: 31 levels on the stride-4, 48-bin slice, which
  tests/test_torch_photochem.py runs on the CPU.

Writes tests/photochem_reference.json: per case its parameters, the
temperature, converged, cvz_locs, flux_net, the Kzz, the final CH4
column, the kinetics' calls and whether each was warm-started, the
profile steps, seconds; where a Newton solve returned NaN fluxes, the
first such profile step (``nan_onset``, as tests/climate_modes_record.py
records it).  Each case runs in a process of its own on one thread; the
91-level solve takes minutes.

    python tests/photochem_record.py
    python tests/photochem_record.py --cases photochem_t900_31
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
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

from climate_modes_record import CASES as MODE_CASES  # noqa: E402
from climate_modes_record import (_jax_f64_on_cpu, _jsonable,  # noqa: E402
                                  jax_facade_case, jax_table)

OUT = os.path.join(HERE, 'photochem_reference.json')
CASES = {'photochem_t900_91': dict(MODE_CASES['diseq_t900_91'],
                                   mode='photochem'),
         'photochem_t900_31': dict(MODE_CASES['diseq_t900_31'],
                                   mode='photochem')}


class MockPhotochem:
    """tests/test_photochem_climate.py:19-36: a stand-in for
    EvoAtmosphereGasGiantPicaso with its ``run_for_picaso``."""

    def __init__(self):
        self.calls = 0
        self.guesses = []

    def run_for_picaso(self, df, log10metallicity, CtoO, Kzz,
                       df_comp_guess=None, rainout_condensed_atoms=True):
        self.calls += 1
        self.guesses.append(df_comp_guess is not None)
        assert len(Kzz) == len(df['pressure'])
        out = df.copy()
        if 'CH4' in out:
            out['CH4'] = float(np.asarray(out['CH4'])[-1])
        return out


def run_jax(spec):
    jax = _jax_f64_on_cpu()
    from picaso_tpu import justdoit as jdi
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
    case = jax_facade_case(jdi, spec)
    pc = MockPhotochem()
    case.inputs['climate']['pc'] = pc
    t0 = time.perf_counter()
    out = case.climate(opa, diseq_chem=True, verbose=False,
                       save_all_profiles=True)
    seconds = time.perf_counter() - t0
    prof = case.inputs['atmosphere']['profile']
    rec = dict(temperature=np.asarray(out['temperature'], float),
               converged=int(out['converged']),
               cvz_locs=[int(i) for i in out['cvz_locs']],
               flux_net=np.asarray(out['flux_balance']['flux_net'], float),
               kzz=np.asarray(out['kzz'], float),
               ch4=np.asarray(prof['CH4'], float),
               calls=pc.calls, guesses=[bool(g) for g in pc.guesses],
               profile_steps=len(out['all_profiles']), seconds=seconds)
    if nan_steps:
        rec['nan_onset'] = nan_steps[0]
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--cases', default=','.join(CASES))
    ap.add_argument('--out', default=OUT)
    ap.add_argument('--one', help=argparse.SUPPRESS)
    ap.add_argument('--to', help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        with open(args.to, 'w') as f:
            json.dump(_jsonable(run_jax(CASES[args.one])), f)
        return 0

    env = dict(os.environ, JAX_PLATFORMS='cpu', OMP_NUM_THREADS='1',
               XLA_FLAGS='--xla_cpu_multi_thread_eigen=false '
                         'intra_op_parallelism_threads=1')
    saved = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            saved = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name in args.cases.split(','):
            path = os.path.join(tmp, name + '.json')
            procs[name] = (subprocess.Popen(
                [sys.executable, __file__, '--one', name, '--to', path],
                env=env), path)
        for name, (proc, path) in procs.items():
            if proc.wait() != 0:
                raise SystemExit(f'{name} failed')
            with open(path) as f:
                rec = json.load(f)
            saved[name] = dict(case=CASES[name], **rec, source=(
                'the JAX package, float64 on the CPU, mocked kinetics '
                '(tests/photochem_record.py)'))
            print(json.dumps({name: {k: rec[k] for k in (
                'converged', 'cvz_locs', 'calls', 'seconds')}}), flush=True)
    with open(args.out, 'w') as f:
        json.dump(saved, f, indent=1, sort_keys=True)
        f.write('\n')
    return 0


if __name__ == '__main__':
    sys.exit(main())
