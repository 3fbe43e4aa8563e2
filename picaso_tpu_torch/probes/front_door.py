"""The front door's production cases, and where their time goes.

``facade_case`` builds a ``justdoit.inputs`` bundle as a user does, on the
production profile of ``pipeline.build_problem`` (91 levels, H2, He and
the 16 molecules of ``MIX_16``), its cloud deck as an EGP-grid table, or
the hot-spot GCM map of ``examples/phase_curve_3d.py`` deepened to that
profile; ``chip_smoke.py``'s phases 26-29 run them.  Run as a script on a
CUDA machine, this module times one full-width 1D spectrum and one
36-facet 3D spectrum on the production table (nwno 50 000) and splits
them up: the host's time by function (``cProfile``) and the card's busy
time and launches (``torch.profiler``).  It prints one JSON line and
appends it to ``--out``:

    python -m picaso_tpu_torch.probes.front_door [--out FILE]
"""

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import time

import numpy as np
import torch

NWNO = 50_000
NLEVEL = 91


def production_profile(molecules, nlevel=NLEVEL, scale=1.0):
    """``build_problem``'s 91-level profile (bench.py:121-137) as the
    facade's dict of columns: temperatures times ``scale``, H2, He and
    ``pipeline.MIX_16``'s mixing ratios of ``molecules``."""
    from .. import pipeline
    pressure = np.logspace(-6, 2.5, nlevel)
    prof = {'pressure': pressure,
            'temperature': scale * np.clip(
                1200.0 * (pressure / 50.0) ** 0.08, 150.0, None),
            'H2': np.zeros(nlevel) + 0.84, 'He': np.zeros(nlevel) + 0.155}
    for m in molecules:
        prof[m] = np.zeros(nlevel) + pipeline.MIX_16[m]
    return prof


def egp_cloud_table(nlayer):
    """``build_problem``'s cloud deck as an eddysed table on the 196-point
    EGP grid (nlayer x 196 rows)."""
    return {'opd': np.repeat(np.linspace(0.0, 1.0, nlayer) ** 2, 196),
            'g0': np.zeros(nlayer * 196) + 0.85,
            'w0': np.zeros(nlayer * 196) + 0.95}


def gcm_map(molecules, nlevel=NLEVEL, nlon=12, nlat=8, uniform=False):
    """examples/phase_curve_3d.py's hot-spot map deepened to the production
    profile: 91 levels x 12 lon x 8 lat, the dayside up to 25 % hotter, H2,
    He and the 16 molecules (``uniform``: every column the same)."""
    prof = production_profile(molecules, nlevel)
    lon = np.linspace(-180, 180, nlon)
    lat = np.linspace(-85, 85, nlat)
    day = np.cos(np.radians(lon))[:, None] * np.cos(np.radians(lat))[None]
    heat = 1.0 + (0.0 if uniform else 0.25) * np.maximum(day, 0.0)
    data = {'pressure': prof['pressure'], 'lat': lat, 'lon': lon}
    for key, col in prof.items():
        if key != 'pressure':
            data[key] = col[:, None, None] * (
                heat[None] if key == 'temperature' else np.ones_like(heat))
    return data


def facade_case(opa, case='planet', phase=0.0, disk=(10, 1),
                phase_grid=None, calculation=None, scale=1.0,
                multi_phase='N=2', atmosphere='1d', clouds=True):
    """A ``justdoit.inputs`` bundle as a user builds one: geometry, the
    planet of build_problem (1.898e30 g, 7.1492e9 cm), a 5700 K blackbody
    star of 6.96e10 cm at 0.05 AU (none for case='browndwarf'), the
    production profile (``atmosphere``: '1d', '3d' the hot-spot map,
    'uniform' the uniform map, '4d' the hot-spot map per phase), the EGP
    cloud deck (1D), and ``approx`` with ``multi_phase``."""
    from .. import justdoit as jdi
    mols = opa.molecules
    c = jdi.inputs(calculation=case)
    if phase_grid is None:
        c.phase_angle(phase, num_gangle=disk[0], num_tangle=disk[1])
    else:
        c.phase_angle(phase_grid=phase_grid, num_gangle=disk[0],
                      num_tangle=disk[1], calculation=calculation)
    c.gravity(mass=1.898e30, mass_unit='g', radius=7.1492e9,
              radius_unit='cm')
    if case != 'browndwarf':
        c.star(opa, temp=5700, radius=6.96e10, radius_unit='cm',
               semi_major=0.05, semi_major_unit='AU')
    if atmosphere == '1d':
        c.atmosphere(df=production_profile(mols, scale=scale))
        if clouds:
            c.clouds(df=egp_cloud_table(NLEVEL - 1))
    elif atmosphere == '4d':
        c.atmosphere_4d(gcm_map(mols), verbose=False)
    else:
        c.atmosphere_3d(gcm_map(mols, uniform=atmosphere == 'uniform'))
    c.approx(multi_phase=multi_phase)
    return c


def _profiled(fn, top=12):
    """fn()'s wall ms, the host's top functions by own time (ms) under
    cProfile, and the card's busy ms and kernel count under
    torch.profiler (each a separate call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = sorted(((v[2] * 1e3, f'{os.path.basename(k[0])}:{k[1]}:{k[2]}')
                   for k, v in stats.items()), reverse=True)[:top]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        fn()
        torch.cuda.synchronize()
    on_card = [e for e in tp.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return {'wall_ms': wall, 'device_busy_ms': sum(
                e.device_time for e in on_card) / 1e3,
            'device_launches': len(on_card),
            'host_own_ms': [[round(ms, 3), name] for ms, name in rows]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default='build/front_door.jsonl')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit('front_door: no CUDA device')
    from .. import justdoit as jdi
    from .. import pipeline
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    _, grid, _ = pipeline.build_problem(NWNO, nlevel=NLEVEL, device='cuda')
    opa = jdi.Opacity(grid.wno, grid=grid)
    calc = 'reflected+thermal+transmission'
    result = {'card': smi[0], 'nwno': NWNO,
              '1d': _profiled(lambda: facade_case(opa).spectrum(
                  opa, calculation=calc)),
              '3d_36_facets': _profiled(lambda: facade_case(
                  opa, disk=(6, 6), atmosphere='3d').spectrum(
                      opa, calculation='reflected+thermal',
                      dimension='3d'))}
    line = json.dumps(result)
    print(line, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'a') as f:
        f.write(line + '\n')


if __name__ == '__main__':
    main()
