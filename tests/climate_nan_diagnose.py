"""Where the NaN fluxes of the JAX package's host-path climate solves come
from, and which workflow blows up (ROADMAP Queue 3).

Two reports on a case of tests/climate_modes_record.py, each in float64 on
the CPU with the JAX package, one JSON line each:

- ``--onset``: runs the case's solve until the first profile step whose
  Newton solve returns NaN fluxes, then rebuilds that step's Newton
  Jacobian outside the jitted solve (each pert level moved by
  max(1e-4 T, 3 K), re-stitched, its residual columns) and reports the
  step, the zone layout (the convective levels), the columns that are
  exactly zero, the condition number, and whether the fluxes at the
  step's own temperatures are finite;
- ``--workflows``: the case's solve four ways: the diseq workflow (one
  loose profile, then ``find_strat``) on the fused equilibrium step
  without per-gas tables, the same on the host-assembled step, and the
  equilibrium workflow (two profiles, then ``find_strat``) on the
  host-assembled step, with ``atmosphere._hydrostatic`` as it is and with
  the layer gravity of its end layers set to the planet's (as the fused
  path's column densities).  Each: converged, cvz_locs, flux balance
  over the radiative zone, the hottest level.

    python tests/climate_nan_diagnose.py --onset diseq_91
    python tests/climate_nan_diagnose.py --workflows diseq_31

Minutes per 91-level case; not a test.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from climate_modes_record import (CASES, _jax_f64_on_cpu,  # noqa: E402
                                  jax_facade_case, jax_table)


class _Stop(Exception):
    pass


def onset(name):
    """The first NaN-flux profile step of ``name`` and its Jacobian."""
    _jax_f64_on_cpu()
    import jax.numpy as jnp
    from picaso_tpu import justdoit as jdi
    from picaso_tpu.climate import core, fused
    from picaso_tpu.climate.adiabat import load_adiabat_grid

    spec = CASES[name]
    table = jax_table(spec)
    newton, seen = fused.newton_solve, {'step': 0}

    def watching(temp, props, zones, data, geom, ck, adiabat, config):
        out = newton(temp, props, zones, data, geom, ck, adiabat, config)
        if np.isnan(np.asarray(out[2])).any():
            seen.update(temp=temp, props=props, zones=zones, data=data,
                        geom=geom)
            raise _Stop()
        seen['step'] += 1
        return out

    fused.newton_solve = watching
    try:
        jax_facade_case(jdi, spec).climate(jdi.opannection(ck_table=table),
                                           diseq_chem=spec['diseq_chem'],
                                           verbose=False)
        return {'case': name, 'nan_onset': None}
    except _Stop:
        pass
    finally:
        fused.newton_solve = newton
    temp, props, zones, data = (seen[k] for k in ('temp', 'props', 'zones',
                                                  'data'))
    adiabat = load_adiabat_grid()
    a = table.arrays

    def fluxes(t):
        return core.thermal_fluxes(t, props, data.plevel, seen['geom'],
                                   a.wno, a.delta_wno, a.gauss_wts,
                                   data.surf_reflect)

    fni0, fnil0, _ = fluxes(temp)
    t_host = np.asarray(temp)
    pert = np.asarray(zones.pert_levels)
    rl = np.asarray(zones.resid_level)
    at_level = np.asarray(zones.resid_is_level).astype(bool)
    n_total = int(zones.n_total)
    cols = []
    for m in range(len(t_host)):
        jm = int(pert[m])
        dt = max(1e-4 * t_host[jm], 3.0)
        tp = core.reconstruct_profile(temp.at[jm].add(dt), zones,
                                      data.plevel, adiabat)
        fni, fnil, _ = fluxes(tp)
        cols.append(np.where(at_level, np.asarray(fni - fni0)[rl],
                             np.asarray(fnil - fnil0)[rl]) / dt)
    jac = np.array(cols).T[:n_total, :n_total]
    zero = [int(pert[i]) for i in range(n_total) if not jac[:, i].any()]
    return {'case': name, 'nan_onset': seen['step'],
            'convective_levels': np.where(np.asarray(zones.is_conv))[0]
            .tolist(),
            'zero_columns_at_levels': zero,
            'condition': float(np.linalg.cond(jac)),
            'fluxes_finite_at_step_temperature': bool(
                np.isfinite(np.asarray(fni0)).all()),
            't_max': float(t_host.max())}


def workflows(name):
    """The case's solve under each workflow and step (module docstring)."""
    jax = _jax_f64_on_cpu()
    from picaso_tpu import atmosphere
    from picaso_tpu import justdoit as jdi
    from picaso_tpu.climate import api, core, fused

    spec = CASES[name]
    hydrostatic, profile_step = atmosphere._hydrostatic, fused.profile_step
    states = []
    init = api._ClimateState.__init__

    def keep(self, *args, **kwargs):
        init(self, *args, **kwargs)
        states.append(self)

    def host_step(temp, zones, data, chem, ck, geom, adiabat, config):
        st = states[-1]
        t = core.reconstruct_profile(temp, zones, data.plevel, adiabat)
        df = st.premix(np.asarray(t), np.asarray(
            st.bundle.inputs['climate']['pressure']))
        props, _ = st.build_props_host(df)
        out = fused.newton_solve(t, props, zones, data, geom, ck, adiabat,
                                 config)
        dtdp = (jax.numpy.diff(jax.numpy.log(out[0]))
                / jax.numpy.diff(jax.numpy.log(data.plevel)))
        return out[0], out[1], dtdp, out[2], out[3], out[4]

    def planet_gravity(plevel, tlevel, mmw, gravity, radius, mass, p_ref):
        z, dz, g_layer, scale_h = hydrostatic(plevel, tlevel, mmw, gravity,
                                              radius, mass, p_ref)
        return z, dz, np.full_like(g_layer, gravity), scale_h

    runs = {'diseq workflow, fused step': (True, False, False),
            'diseq workflow, host step': (True, True, False),
            'equilibrium workflow, host step': (False, True, False),
            'equilibrium workflow, host step, planet gravity in the end '
            'layers': (False, True, True)}
    report = {'case': name}
    api._ClimateState.__init__ = keep
    try:
        for label, (diseq, host, gravity) in runs.items():
            fused.profile_step = host_step if host else profile_step
            atmosphere._hydrostatic = (planet_gravity if gravity
                                       else hydrostatic)
            table = jax_table(spec)
            table.per_gas = None
            case = jax_facade_case(jdi, spec)
            update = api._ClimateState.update_diseq_chem
            # diseq: the workflow alone, its chemistry the equilibrium one
            api._ClimateState.update_diseq_chem = (
                lambda self, t, p: self.premix(t, p))
            flag = diseq and not host

            def plain(state, *args, **kwargs):
                state.diseq = False
                return run(state, *args, **kwargs)

            run = api.profile
            if flag:
                api.profile = plain
            try:
                out = case.climate(jdi.opannection(ck_table=table),
                                   diseq_chem=diseq, verbose=False)
            finally:
                api.profile = run
                api._ClimateState.update_diseq_chem = update
            nstr = [int(i) for i in out['cvz_locs']]
            net = np.asarray(out['flux_balance']['flux_net'])[:max(nstr[1],
                                                                  1)]
            report[label] = dict(
                converged=int(out['converged']), cvz_locs=nstr,
                flux_balance=float(np.abs(net).max()
                                   / (core.SIGMA_SB * spec['teff'] ** 4)),
                t_max=float(np.max(out['temperature'])))
    finally:
        api._ClimateState.__init__ = init
        fused.profile_step = profile_step
        atmosphere._hydrostatic = hydrostatic
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--onset', help='a case of climate_modes_record.CASES')
    ap.add_argument('--workflows', help='a case, as --onset')
    args = ap.parse_args()
    if args.onset:
        print(json.dumps(onset(args.onset)), flush=True)
    if args.workflows:
        print(json.dumps(workflows(args.workflows)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
