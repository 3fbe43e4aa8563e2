"""The singular and nearly singular Newton Jacobians of a recorded climate
solve, on the card or on the CPU.

Runs a case of tests/climate_modes_reference.json (the JAX package's
float64 solves, written by tests/climate_modes_record.py) through the
front door as ``chip_smoke.py``'s phases 34-37 do, in float64, with every
``torch.linalg.solve_ex`` of its Newton solves watched.  Each solve whose
smallest Jacobian column (the sum of its absolute values) is at most
``--ratio`` of the largest is reported: its profile step, the convective
levels of that step, the level of the smallest column, the ratio and
whether the solve's step came back finite.  A convective zone of one level
that the adiabatic re-stitch overwrites gives an exactly zero column
(ROADMAP Queue 3).  Then the solve's end against the record: converged,
cvz_locs, max |dT|, and each profile step's max |dT| to the record's where
the record kept them.  One JSON line, also appended to ``--out``:

    python -m picaso_tpu_torch.probes.climate_jacobian diseq_661_91
    python -m picaso_tpu_torch.probes.climate_jacobian diseq_t900_31 \\
        --device cpu
"""

import argparse
import json
import os
import time

import numpy as np
import torch

REFERENCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'tests', 'climate_modes_reference.json')


def modes_case(jdi, spec):
    """The front door's case of a recorded case (tests/
    climate_modes_record.py's recipe: a brown dwarf at ``spec['gravity']``
    m/s^2, no star, ``pressure = logspace(-4, 2.5, nlevel)``, the guess
    clip(1.2 Teff (p / 30 bar)^0.1, 250 K), and the case's mode)."""
    case = jdi.inputs(calculation='browndwarf', climate=True)
    case.effective_temp(spec['teff'])
    case.gravity(gravity=spec['gravity'],
                 gravity_unit=jdi.u.Unit('m/(s**2)'))
    pressure = np.logspace(-4, 2.5, spec['nlevel'])
    guess = np.clip(spec['teff'] * 1.2 * (pressure / 30.0) ** 0.1, 250.0,
                    None)
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


def watching(run, ratio=1e-12):
    """``run()`` (a climate solve) with every ``torch.linalg.solve_ex`` of
    its Newton solves watched: its output, the first solve per profile
    step whose smallest Jacobian column is at most ``ratio`` of the
    largest, how many such solves, the wall seconds."""
    from ..climate import fused

    state = {'step': 0, 'conv': []}
    found = []
    newton, solve_ex = fused.newton_solve, torch.linalg.solve_ex

    def counted(temp, props, zones, *args, **kwargs):
        state['conv'] = np.where(np.asarray(zones.is_conv))[0].tolist()
        out = newton(temp, props, zones, *args, **kwargs)
        state['step'] += 1
        return out

    def watched(a, b, *args, **kwargs):
        out = solve_ex(a, b, *args, **kwargs)
        col = a.abs().sum(0)
        small = float(col.min() / col.max())
        if small <= ratio:
            found.append(dict(step=state['step'],
                              convective_levels=state['conv'],
                              level=int(col.argmin()), ratio=small,
                              finite=bool(torch.isfinite(out[0]).all())))
        return out

    fused.newton_solve, torch.linalg.solve_ex = counted, watched
    try:
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
    finally:
        fused.newton_solve, torch.linalg.solve_ex = newton, solve_ex
    first = {}
    for f in found:     # the first report of each step: a summary
        first.setdefault(f['step'], f)
    return out, list(first.values()), len(found), wall


def watch(name, device, ratio=1e-12):
    """The report of the module docstring for the recorded case ``name``
    on ``device``."""
    from .. import justdoit as jdi
    from ..opacities.ck import synthetic_ck_table

    with open(REFERENCE) as f:
        rec = json.load(f)[name]
    spec = rec['case']
    ck = synthetic_ck_table(grid661=spec['table'] == 661, device='cpu',
                            with_per_gas=True)
    if spec['slice']:
        ck = ck.take_bins(slice(None, spec['slice'][1], spec['slice'][0]))
    opa = jdi.opannection(ck_table=ck, device=device)
    case = modes_case(jdi, spec)
    out, small, n_small, wall = watching(lambda: case.climate(
        opa, diseq_chem=spec['diseq_chem'], with_spec=False,
        verbose=False, save_all_profiles=True), ratio)
    steps = np.asarray(out['all_profiles'])
    ref_steps = np.asarray(rec.get('all_profiles', np.zeros((0, 1))))
    n = min(len(steps), len(ref_steps))
    return dict(
        case=name, device=str(device), wall_s=wall,
        converged=int(out['converged']),
        cvz_locs=[int(i) for i in out['cvz_locs']],
        jax_converged=rec['converged'], jax_cvz_locs=rec['cvz_locs'],
        jax_nan_onset=rec.get('nan_onset'),
        max_dT=float(np.abs(out['temperature']
                            - np.asarray(rec['temperature'])).max()),
        profile_steps=len(steps), jax_profile_steps=len(ref_steps),
        steps_max_dT=[float(np.abs(steps[i] - ref_steps[i]).max())
                      for i in range(n)],
        small_solves=n_small, small_by_step=small)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('cases', help='comma-separated record names')
    ap.add_argument('--device', default='cuda')
    ap.add_argument('--ratio', type=float, default=1e-12)
    ap.add_argument('--out', default='build/climate_jacobian.jsonl')
    args = ap.parse_args()
    for name in args.cases.split(','):
        line = json.dumps(watch(name, torch.device(args.device),
                                args.ratio))
        print(line, flush=True)
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'a') as f:
            f.write(line + '\n')
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
