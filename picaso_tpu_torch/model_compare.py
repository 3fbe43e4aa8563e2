"""Physics benchmark harnesses against literature tables.

Port of ``picaso_tpu/model_compare.py`` (the reference ``model_compare.py``)
through the port's front door, on ``device`` (default the card, float32;
``device='cpu'`` runs float64).  Where the JAX module returns pandas
DataFrames these return dicts of numpy columns with the same row and
column keys: the row labels under the index's name (``'asy'`` or
``'ssa'``), then one array per column.

* :func:`dlugach_test` -- semi-infinite-atmosphere albedos vs Dlugach &
  Yanovitskij (1974) Table XXI (w0 x g0 sweep, rayleigh + constant-tau
  analytic test modes);
* :func:`thermal_sh_test` -- w0 x g0 grid of mean thermal flux for
  comparison against pyDISORT output;
* :func:`madhu_test` -- Madhu & Burrows (2011) Figure 2 reproduction.

Each builds an analytic connection (``opannection(wno_grid=...)``).  With
the Toon solver the reflected runs go through K5 and the thermal ones
through K6 on the card; ``method='SH'`` runs the plain SH path
(``rt/sh.py``), as the JAX front door does.
"""

from __future__ import annotations

import numpy as np

from . import justdoit as jdi
from .refdata import refdata_path

__all__ = ['dlugach_test', 'thermal_sh_test', 'madhu_test']

_NLEVEL = 60


def _read_dlugach():
    """DLUGACH_TEST.csv as {'asy': row labels (str), column: floats}."""
    with open(refdata_path('base_cases', 'testing', 'DLUGACH_TEST.csv')) as f:
        rows = [ln.strip().split(',') for ln in f if ln.strip()]
    header, body = rows[0], rows[1:]
    table = {header[0]: [r[0] for r in body]}
    for j, col in enumerate(header[1:], start=1):
        table[col] = np.array([float(r[j]) for r in body])
    return table


def _to_csv(table, path):
    """Write a dict of columns as a comma-separated table with a header."""
    keys = list(table)
    with open(path, 'w') as f:
        f.write(','.join(keys) + '\n')
        for i in range(len(table[keys[0]])):
            f.write(','.join(str(table[k][i]) for k in keys) + '\n')


def _analytic_case(device, wave=(0.55, 0.95), npts=6, nlevel=_NLEVEL):
    wno = np.sort(1e4 / np.linspace(wave[0], wave[1], npts))
    opa = jdi.opannection(wno_grid=wno, device=device)
    case = jdi.inputs()
    case.phase_angle(0)
    case.gravity(gravity=25, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.star(opa, 6000, 0.0122, 4.437)
    case.atmosphere(df={
        'pressure': np.logspace(-6, 3, nlevel),
        'temperature': np.zeros(nlevel) + 1000,
        'H2': np.zeros(nlevel) + 0.99,
        'H2O': np.zeros(nlevel) + 0.01})
    return opa, case


def _albedo_run(case, opa, approx_kwargs):
    """The run(w0, g0, test_mode, single_phase) of the reflected
    harnesses: the cloud deck of the test mode, then the last albedo."""
    nlayer = _NLEVEL - 1

    def run(w0, g0, test_mode, sp, opd=0.2):
        case.inputs['test_mode'] = test_mode
        case.approx(single_phase=sp, **approx_kwargs)
        opd_col = (np.repeat(10 ** np.linspace(-5, 3, nlayer), 196)
                   if test_mode == 'rayleigh'
                   else np.zeros(196 * nlayer) + opd)
        case.clouds(df={
            'opd': opd_col, 'w0': np.zeros(196 * nlayer) + w0,
            'g0': np.zeros(196 * nlayer) + g0})
        return float(np.asarray(
            case.spectrum(opa, calculation='reflected')['albedo'])[-1])
    return run


def dlugach_test(single_phase='OTHG', multi_phase='N=1', rayleigh=True,
                 phase=True, method='toon', stream=2, opd=0.2,
                 toon_coefficients='quadrature', delta_eddington=False,
                 output_dir=None, device='cuda'):
    """Albedos vs Dlugach & Yanovitskij Table XXI (model_compare.py:109).

    Returns (real_answer, perror): the table, and the same table with
    the computed albedos in its cells (a cell not computed keeps the
    table's value, as the JAX DataFrame copy does)."""
    real_answer = _read_dlugach()
    perror = {k: (list(v) if k == 'asy' else v.copy())
              for k, v in real_answer.items()}
    opa, case = _analytic_case(device)
    run = _albedo_run(case, opa, dict(
        raman='none', rt_method=method, stream=stream,
        toon_coefficients=toon_coefficients, multi_phase=multi_phase,
        delta_eddington=delta_eddington))
    columns = [k for k in real_answer if k != 'asy']
    labels = real_answer['asy']

    if rayleigh:
        for w in columns:
            w0 = 0.999999 if float(w) == 1.0 else float(w)
            perror[w][labels.index('Ray')] = run(w0, 0.0, 'rayleigh',
                                                 'TTHG_ray', opd)
    if phase:
        for i, g0 in enumerate(labels):
            if i == 0:
                continue
            for w in columns:
                w0 = 0.999999 if float(w) == 1.0 else float(w)
                perror[w][i] = run(w0, float(g0), 'constant_tau',
                                   single_phase, opd)
    if output_dir is not None:
        _to_csv(perror, output_dir)
    return real_answer, perror


def thermal_sh_test(single_phase='OTHG', method='toon', stream=2,
                    toon_coefficients='quadrature', delta_eddington=True,
                    tau=0.2, output_dir=None, device='cuda'):
    """Mean thermal flux over a w0 x g0 grid for DISORT comparison
    (model_compare.py:20-106): {'asy': g0 rows, w0 column: mean flux}."""
    cols = ['1.0', '0.999', '0.995', '0.990', '0.980', '0.950', '0.90',
            '0.8', '0.7', '0.6', '0.5', '0.4', '0.3', '0.2', '0.1']
    rows = [0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.999]
    perror = {'asy': np.asarray(rows, np.float64)}
    perror.update({c: np.full(len(rows), np.nan) for c in cols})

    nlevel = 20
    wno = np.sort(1e4 / np.linspace(1.2, 9.5, 10))
    opa = jdi.opannection(wno_grid=wno, device=device)
    case = jdi.inputs(calculation='browndwarf')
    case.phase_angle(0)
    case.gravity(gravity=200, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.surface_reflect(0, opa.wno)
    pressure = np.logspace(-4, 2, nlevel)
    case.atmosphere(df={
        'pressure': pressure,
        'temperature': np.clip(1270 * (pressure / 10) ** 0.1, 500, None),
        'H2': np.zeros(nlevel) + 0.85, 'He': np.zeros(nlevel) + 0.15})
    case.inputs['test_mode'] = 'constant_tau'
    nlayer = nlevel - 1

    for i, g0 in enumerate(rows):
        for w in cols:
            w0 = 0.999999 if float(w) == 1.0 else float(w)
            case.clouds(df={
                'opd': np.zeros(196 * nlayer) + tau,
                'w0': np.zeros(196 * nlayer) + w0,
                'g0': np.zeros(196 * nlayer) + g0})
            case.approx(single_phase=single_phase, rt_method=method,
                        stream=stream, toon_coefficients=toon_coefficients,
                        delta_eddington=delta_eddington, raman='none')
            out = case.spectrum(opa, calculation='thermal')
            perror[w][i] = float(np.mean(np.asarray(out['thermal'])))
    if output_dir is not None:
        _to_csv(perror, output_dir)
    return perror


def madhu_test(rayleigh=True, isotropic=True, asymmetric=True,
               single_phase='TTHG_ray', device='cuda'):
    """Madhu & Burrows (2011) fig. 2 cases (model_compare.py:209-300):
    {'ssa': single-scattering albedos, phase function: albedos} for the
    rayleigh / isotropic / asymmetric-HG phase functions."""
    ssa = np.array([0.3, 0.5, 0.7, 0.8, 0.9, 0.95, 0.99, 0.999999])
    out = {'ssa': ssa}
    nlevel = 60
    wno = np.sort(1e4 / np.linspace(0.55, 0.95, 4))
    opa = jdi.opannection(wno_grid=wno, device=device)
    case = jdi.inputs()
    case.phase_angle(0)
    case.gravity(gravity=10, gravity_unit=jdi.u.Unit('m/(s**2)'))
    case.star(opa, 6000, 0.0122, 4.437)
    p = np.logspace(-5, 4, nlevel)
    case.atmosphere(df={
        'pressure': p, 'temperature': np.zeros(nlevel) + 300,
        'CH4': np.zeros(nlevel) + 0.01, 'H2': np.zeros(nlevel) + 0.495,
        'He': np.zeros(nlevel) + 0.495})
    run = _albedo_run(case, opa, dict(raman='pollack',
                                      delta_eddington=True))

    if rayleigh:
        out['rayleigh'] = np.array([run(w, 0.0, 'rayleigh', 'TTHG_ray')
                                    for w in ssa])
    if isotropic:
        out['0.0'] = np.array([run(w, 0.0, 'constant_tau', 'OTHG')
                               for w in ssa])
    if asymmetric:
        for g in [0.2, 0.4, 0.6, 0.8]:
            out[str(g)] = np.array([run(w, g, 'constant_tau', single_phase)
                                    for w in ssa])
    return out
